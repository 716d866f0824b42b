"""Rate control of the port against svt_av1_tpu on the CPU: low-delay P
under the model controller (1), VBR (2) and constrained VBR (3), an
all-intra VBR batch and two lockstep VBR streams.

The inputs are tests/test_rate_control.py's (a window sliding over one
synthetic picture).  Both encoders are driven as a streaming user drives
them, draining get_packet after every send, so the reference absorbs
each packet's bits before it picks the next q (it absorbs a packet when
get_packet reaches it).  TUs must be byte-identical and the per-frame
qindex sequences equal; the mirror decoder must reproduce the port's
recon; and the controller must actually move q."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (assert_decodes_to_recon,  # noqa: E402
                           assert_same_tus, encode_both)
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import Frame, synthetic_frame  # noqa: E402


def rc_frames(w, h, n, seed=5):
    """tests/test_rate_control.py's clip: a w x h window moving over a
    larger synthetic picture by (2, 3) pixels a frame."""
    base = synthetic_frame(w + 64, h + 64, seed=seed)
    return [Frame(base.y[2 * t:2 * t + h, 3 * t:3 * t + w].copy(),
                  base.u[t:t + h // 2, 3 * t // 2:3 * t // 2 + w // 2].copy(),
                  base.v[t:t + h // 2, 3 * t // 2:3 * t // 2 + w // 2].copy())
            for t in range(n)]


def check_rc(kw, frames):
    """Encode frames under kw through both packages: equal TUs, equal
    per-frame qindex, decodable to the port's recon.  Returns the
    coded frames' qindex sequence."""
    tus = encode_both({**kw, "recon_output": True}, frames, qindex=True)
    assert_decodes_to_recon(tus)
    return [p.qindex for p in tus if p.recon is not None]


IPPP = dict(width=128, height=64, intra_period=63, pred_structure=0,
            frame_rate_num=30)
CASES = [("model", dict(rate_control_mode=1, target_bit_rate=240_000,
                        scene_change_detection=False)),
         ("vbr", dict(rate_control_mode=2, target_bit_rate=300_000)),
         ("cvbr", dict(rate_control_mode=3, target_bit_rate=150_000))]


@pytest.mark.parametrize("extra", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_ippp_rate_control_byte_identical(extra):
    qs = check_rc({**IPPP, **extra}, rc_frames(128, 64, 8))
    assert len(set(qs[1:])) > 1, qs       # q moves between P frames


def test_all_intra_vbr_batch_byte_identical():
    """device_batch=2, two frames sent before each drain: one shared q
    per batch, the feedback of a batch absorbed together before the next
    batch picks its q."""
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    kw = dict(width=64, height=64, rate_control_mode=2,
              target_bit_rate=500_000, frame_rate_num=30, device_batch=2,
              recon_output=True)
    frames = rc_frames(64, 64, 6)

    def by_pairs(enc):
        out = []
        for i in range(0, len(frames), 2):
            for f in frames[i:i + 2]:
                enc.send_picture(f)
            out += list(iter(enc.get_packet, None))
        return out

    want = by_pairs(JEncoder(JConfig(**kw)))
    got = by_pairs(Encoder(EncoderConfig(**kw), device="cpu"))
    assert_same_tus(want, got, qindex=True)
    assert_decodes_to_recon(got)
    qs = [p.qindex for p in got]
    assert qs[0] == qs[1] and qs[2] == qs[3] and qs[4] == qs[5]
    assert len(set(qs)) > 1, qs


def test_lockstep_vbr_two_streams_byte_identical():
    """MultiStreamEncoder: the streams share encs[0]'s controller, which
    absorbs the slot's mean bits per stream."""
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.pipeline.multistream import \
        MultiStreamEncoder as JMultiStream
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder

    kw = dict(IPPP, rate_control_mode=2, target_bit_rate=300_000,
              scene_change_detection=False, recon_output=True)
    streams = [rc_frames(128, 64, 5, seed=s) for s in (5, 6)]
    slots = list(zip(*streams))
    jms = JMultiStream(JConfig(**kw), 2)
    want = [jms.send(list(f)) for f in slots]
    tms = MultiStreamEncoder(EncoderConfig(**kw), 2, device="cpu")
    got = [tms.send(list(f)) for f in slots]
    for w_, g_ in zip(want, got):
        assert_same_tus(w_, g_, qindex=True)
    qs = [slot[0].qindex for slot in got]
    assert len(set(qs[1:])) > 1, qs
    for s in range(2):
        assert_decodes_to_recon([slot[s] for slot in got])
