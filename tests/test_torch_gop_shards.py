"""GOP-parallel encoding in the port: G GOPs of one stream in lockstep
through MultiStreamEncoder on one device (the reference package lays
them over a device mesh; its bytes do not depend on it).  At 128x96
(the inputs of tests/test_parallel.py), G=2 GOPs of L=4 frames, and a
tail of 6 frames padded to the slot grid, must give TUs byte-identical
to svt_av1_tpu's GopShardedEncoder and to the port's sequential Encoder
with the same keyframe cadence, in stream order, with the padding
dropped; the reference decoder must reproduce the port's recon."""

import numpy as np
import pytest

from svt_av1_tpu.config import EncoderConfig as JConfig
from svt_av1_tpu.io.yuv import synthetic_frame
from svt_av1_tpu.parallel import GopShardedEncoder as JGopSharded
from svt_av1_tpu.parallel import gop_mesh
from svt_av1_tpu_torch import EncoderConfig
from svt_av1_tpu_torch.parallel import GopShardedEncoder
from svt_av1_tpu_torch.pipeline.encoder import Encoder

from _torch_parity import assert_decodes_to_recon, assert_same_tus
from _torch_threads import one_torch_thread  # noqa: F401

W, H, L, G = 128, 96, 4, 2
KW = dict(width=W, height=H, qp=40, pred_structure=0,
          scene_change_detection=False, recon_output=True,
          enable_global_motion=False, interp_filter=0, intra_period=L - 1)
# name -> number of frames (a full super-GOP, a padded tail)
CASES = {"full": G * L, "padded_tail": G * L - 2}


def _clip(n):
    base = synthetic_frame(W, H, seed=3)
    out = []
    for i in range(n):
        f = synthetic_frame(W, H, seed=3)
        f.y[:] = np.roll(base.y, (i, 2 * i), (0, 1))
        f.u[:] = np.roll(base.u, (0, i), (0, 1))
        f.v[:] = np.roll(base.v, (0, i), (0, 1))
        out.append(f)
    return out


@pytest.fixture(scope="module")
def encoded():
    """name -> (frames, the reference's TUs, the port's)."""
    res = {}
    for name, n in CASES.items():
        frames = _clip(n)
        want = list(JGopSharded(JConfig(**KW), G, L,
                                mesh=gop_mesh(G)).encode_all(frames))
        got = list(GopShardedEncoder(EncoderConfig(**KW), G, L,
                                     device="cpu").encode_all(frames))
        res[name] = (frames, want, got)
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_gop_shards_tus_equal_reference(encoded, name):
    _, want, got = encoded[name]
    assert len(got) == CASES[name]
    assert_same_tus(want, got)
    assert [p.pts for p in got] == list(range(CASES[name]))
    assert [p.is_keyframe for p in got] == [i % L == 0
                                            for i in range(len(got))]


@pytest.mark.parametrize("name", list(CASES))
def test_gop_shards_equal_sequential_encoder(encoded, name):
    frames, _, got = encoded[name]
    seq = list(Encoder(EncoderConfig(**KW), device="cpu").encode_all(frames))
    assert [p.payload for p in seq] == [p.payload for p in got]


@pytest.mark.parametrize("name", list(CASES))
def test_gop_shards_decode_to_recon(encoded, name):
    assert_decodes_to_recon(encoded[name][2])


def test_gop_shards_retry_on_a_fresh_lockstep_encoder(monkeypatch):
    """A failure inside a super-GOP is retried once on a fresh lockstep
    encoder from the buffered frames; the packets are those of a clean
    run."""
    frames = _clip(G * L)
    clean = list(GopShardedEncoder(EncoderConfig(**KW), G, L,
                                   device="cpu").encode_all(frames))
    enc = GopShardedEncoder(EncoderConfig(**KW), G, L, device="cpu")
    real = type(enc._ms).send
    state = {"failed": False}

    def flaky(self, fr):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("lost the device")
        return real(self, fr)

    monkeypatch.setattr(type(enc._ms), "send", flaky)
    got = list(enc.encode_all(frames))
    assert state["failed"]
    assert [p.payload for p in got] == [p.payload for p in clean]
