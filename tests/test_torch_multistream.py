"""Multi-stream batched encoding in the port: S lockstep IPPP streams
share one device step with a leading stream axis.  With the inputs of
tests/test_multistream.py (S=3 at 192x128, qp 45), the port's
MultiStreamEncoder must write TUs byte-identical to svt_av1_tpu's
MultiStreamEncoder, and to the port's sequential Encoder run per stream
on the normalised config; the reference decoder must reproduce every
stream's recon; and each slot must run ONE step on [S, ...] planes."""

import numpy as np
import pytest

from svt_av1_tpu import EncoderConfig as JConfig
from svt_av1_tpu.io import synthetic_frame
from svt_av1_tpu.pipeline.multistream import (
    MultiStreamEncoder as JMultiStream)
from svt_av1_tpu_torch import EncoderConfig
from svt_av1_tpu_torch.pipeline import inter_encoder as PE
from svt_av1_tpu_torch.pipeline import intra_encoder as IE
from svt_av1_tpu_torch.pipeline.encoder import Encoder
from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder

from _torch_parity import assert_decodes_to_recon, assert_same_tus
from _torch_threads import one_torch_thread  # noqa: F401

W, H, S, N = 192, 128, 3, 4
KW = dict(width=W, height=H, qp=45, intra_period=63, pred_structure=0,
          scene_change_detection=False, recon_output=True)


def _slots():
    """The frames of tests/test_multistream.py: per slot one frame per
    stream, each stream its own seeded picture drifting."""
    bases = [synthetic_frame(W, H, seed=s) for s in range(S)]
    out = []
    for i in range(N):
        frames = []
        for s in range(S):
            f = synthetic_frame(W, H, seed=s)
            f.y[:] = np.roll(bases[s].y, (i, 2 * i + s), (0, 1))
            f.u[:] = np.roll(bases[s].u, (0, i), (0, 1))
            f.v[:] = np.roll(bases[s].v, (0, i), (0, 1))
            frames.append(f)
        out.append(frames)
    return out


@pytest.fixture(scope="module")
def encoded():
    """(slots, the reference's packets [slot][stream], the port's, the
    planes' shapes of each port step call)."""
    slots = _slots()
    ref = JMultiStream(JConfig(**KW), S)
    want = [ref.send(fr) for fr in slots]
    calls = []
    real_p, real_i = PE.p_frame_step, IE.frame_step

    def spy_p(*a, **k):
        step = real_p(*a, **k)

        def run(sy, *rest):
            calls.append(("P", tuple(sy.shape)))
            return step(sy, *rest)
        return run

    def spy_i(sy, *rest):
        calls.append(("I", tuple(sy.shape)))
        return real_i(sy, *rest)

    PE.build_p_frame_encoder_dyn.cache_clear()
    mp = pytest.MonkeyPatch()
    mp.setattr(PE, "p_frame_step", spy_p)
    mp.setattr(IE, "frame_step", spy_i)
    try:
        ms = MultiStreamEncoder(EncoderConfig(**KW), S, device="cpu")
        got = [ms.send(fr) for fr in slots]
    finally:
        mp.undo()
        PE.build_p_frame_encoder_dyn.cache_clear()
    return slots, want, got, calls


def test_multistream_tus_equal_reference(encoded):
    _, want, got, _ = encoded
    for i in range(N):
        assert len(got[i]) == S
        assert_same_tus(want[i], got[i])
    # streams are independent: payloads differ
    assert all(len({p.payload for p in slot}) == S for slot in got)


def test_multistream_equals_sequential_encoder(encoded):
    """The same streams through the port's Encoder one at a time, on the
    config MultiStreamEncoder normalises to (global motion off, the
    REGULAR filter instead of the first frame's pick)."""
    slots, _, got, _ = encoded
    cfg = EncoderConfig(**KW).replace(enable_global_motion=False,
                                      interp_filter=0)
    for s in range(S):
        enc = Encoder(cfg, device="cpu")
        seq = []
        for fr in slots:
            enc.send_picture(fr[s])
            seq.append(enc.get_packet())
        assert [p.payload for p in seq] == [slot[s].payload for slot in got]


def test_multistream_decodes_to_recon(encoded):
    _, _, got, _ = encoded
    for s in range(S):
        assert_decodes_to_recon([slot[s] for slot in got])


def test_multistream_runs_one_step_per_slot(encoded):
    """A real stream axis: one keyframe wavefront on [S, ...] blocks,
    then one P step on [S, ...] planes per slot — never one per
    stream."""
    _, _, _, calls = encoded
    assert [c[0] for c in calls] == ["I"] + ["P"] * (N - 1)
    assert all(c[1][0] == S for c in calls)
    assert calls[0][1] == (S, H // 8, W // 8, 8, 8)
    assert calls[1][1] == (S, H, W)
