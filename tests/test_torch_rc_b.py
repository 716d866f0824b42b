"""Rate control of the port against svt_av1_tpu on the CPU, on the
two-reference structures: low-delay B and hierarchical B under the
model controller (1), VBR (2) and constrained VBR (3).  Hierarchical B
VBR / CVBR plans each mini-GOP as a whole (the GOP controller: per-layer
bit models, a span budget from the buffered frames' complexities).

Inputs: tests/test_rate_control.py's moving window for low-delay B, its
hier-B clip (a rolling picture with fresh noise) cut from 33 frames to
9 (a keyframe and two mini-GOPs).  Both encoders drain get_packet after
every send (see test_torch_rc.py); TUs must be byte-identical, the
per-frame qindex sequences equal, the mirror decoder must reproduce the
port's recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_rc import rc_frames  # noqa: E402
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402

MODES = [("model", 1), ("vbr", 2), ("cvbr", 3)]


def hier_frames(w, h, n):
    """tests/test_rate_control.py's hier-B clip: motion plus fresh noise
    (pure rolls code as all-skip)."""
    base = synthetic_frame(w, h, seed=9)
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        f = synthetic_frame(w, h, seed=9)
        f.y[:] = np.clip(np.roll(base.y, (i, 2 * i), (0, 1)).astype(int)
                         + rng.integers(-12, 13, base.y.shape), 0, 255)
        out.append(f)
    return out


@pytest.mark.parametrize("mode", [m[1] for m in MODES],
                         ids=[m[0] for m in MODES])
def test_ldb_rate_control_byte_identical(mode):
    kw = dict(width=128, height=64, intra_period=-1, pred_structure=1,
              rate_control_mode=mode, target_bit_rate=300_000,
              frame_rate_num=30, scene_change_detection=False,
              recon_output=True)
    tus = encode_both(kw, rc_frames(128, 64, 6), qindex=True)
    assert_decodes_to_recon(tus)
    qs = [p.qindex for p in tus]
    assert len(set(qs[1:])) > 1, qs


@pytest.mark.parametrize("mode", [m[1] for m in MODES],
                         ids=[m[0] for m in MODES])
def test_hierb_rate_control_byte_identical(mode):
    kw = dict(width=128, height=64, intra_period=-1, pred_structure=2,
              hierarchical_levels=2, rate_control_mode=mode,
              target_bit_rate=400_000, frame_rate_num=30,
              scene_change_detection=False, recon_output=True)
    tus = encode_both(kw, hier_frames(128, 64, 9), qindex=True)
    assert_decodes_to_recon(tus)
    coded = [p for p in tus if p.recon is not None]
    assert len(coded) == 9
    qs = [p.qindex for p in coded]
    assert len(set(qs[1:])) > 2, qs       # layers and spans move q
