"""All-intra batches in the port: ``device_batch`` frames share one
wavefront with a leading frame axis and one batched deblock + CDEF
(+ restoration's deblocked planes).  At 192x128, each case's TUs must be
byte-identical to svt_av1_tpu's Encoder with the same ``device_batch``
(one q per batch, from push_qp when given; a partial last batch flushed
by get_packet), the reference decoder must reproduce the port's recon,
and each batch must run ONE wavefront on [S, ...] blocks."""

import pytest

from svt_av1_tpu import EncoderConfig as JConfig
from svt_av1_tpu.io.yuv import synthetic_frame
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
from svt_av1_tpu_torch import EncoderConfig
from svt_av1_tpu_torch.pipeline import intra_encoder as IE
from svt_av1_tpu_torch.pipeline.encoder import Encoder

from _torch_parity import assert_decodes_to_recon, assert_same_tus
from _torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128
BASE = dict(width=W, height=H, qp=40, intra_period=-2, recon_output=True)
# name -> (config extras, frames, push_qp overrides, wavefront batch
# sizes the frames must take)
CASES = {
    "batch2_8bit_push_qp": (dict(device_batch=2), 5, [30, None, 50],
                            [2, 2, 1]),
    "batch4_10bit": (dict(device_batch=4, bit_depth=10), 6, None, [4, 2]),
    "batch2_restoration": (dict(device_batch=2, enable_restoration=True),
                           3, None, [2, 1]),
}


def _encode(enc, frames, qps):
    """Queue the overrides, send every frame, then drain: batches fill
    as they would behind a producer, and the last, partial one is
    flushed by get_packet."""
    for q in qps or ():
        enc.push_qp(q)
    for f in frames:
        enc.send_picture(f)
    enc.send_picture(None)
    out = []
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


@pytest.fixture(scope="module")
def encoded():
    """name -> (the reference's TUs, the port's, the port's wavefront
    batch sizes)."""
    res = {}
    real = IE.frame_step
    for name, (extra, n, qps, _) in CASES.items():
        kw = {**BASE, **extra}
        bd = kw.get("bit_depth", 8)
        frames = [synthetic_frame(W, H, seed=90 + i, bit_depth=bd)
                  for i in range(n)]
        want = _encode(JEncoder(JConfig(**kw)), frames, qps)
        sizes = []

        def spy(sy, *rest):
            sizes.append(sy.shape[0])
            return real(sy, *rest)

        mp = pytest.MonkeyPatch()
        mp.setattr(IE, "frame_step", spy)
        try:
            got = _encode(Encoder(EncoderConfig(**kw), device="cpu"),
                          frames, qps)
        finally:
            mp.undo()
        res[name] = (want, got, sizes)
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_batch_tus_equal_reference(encoded, name):
    want, got, _ = encoded[name]
    assert len(got) == CASES[name][1]
    assert_same_tus(want, got)
    assert [p.pts for p in got] == list(range(len(got)))


@pytest.mark.parametrize("name", list(CASES))
def test_batch_decodes_to_recon(encoded, name):
    assert_decodes_to_recon(encoded[name][1])


@pytest.mark.parametrize("name", list(CASES))
def test_batch_runs_one_wavefront_per_batch(encoded, name):
    assert encoded[name][2] == CASES[name][3]


def test_push_qp_is_taken_once_per_batch(encoded):
    """One q per batch: the overrides 30, None, 50 give the three
    batches of the first case qindex 120, the configured 160, 200."""
    _, got, _ = encoded["batch2_8bit_push_qp"]
    assert [p.qindex for p in got] == [120, 120, 160, 160, 200]


def test_checkpoint_refuses_a_pending_batch():
    enc = Encoder(EncoderConfig(**BASE, device_batch=2), device="cpu")
    enc.send_picture(synthetic_frame(W, H, seed=1))
    with pytest.raises(RuntimeError, match="drain"):
        enc.checkpoint()
    assert enc.get_packet() is not None      # flushes the partial batch
    assert enc.checkpoint()["frame_idx"] == 1
