"""Hierarchical-B parity at 192x128 with compound prediction, for the
short spans the other hier-B tests leave out: levels 0 (every frame a
one-frame span: base P frames only) and intra_period=3 at levels 2 (a
keyframe every 4 frames ends each mini-GOP one frame short, so every
span is coded truncated); and per-frame QP overrides (push_qp) at
levels 2, which the keyframe takes at its send and the mini-GOP's
frames in decode order.  The port's TUs equal svt_av1_tpu's byte for
byte in decode order, with equal recon."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (HIERB, W, H, check_hierb_config,  # noqa: E402
                           encode_both)
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu_torch.pipeline.gop import layer_qindex  # noqa: E402

# (id, config overrides, frames, coded display order)
CASES = [
    ("levels=0", dict(hierarchical_levels=0), 4, [0, 1, 2, 3]),
    ("intra_period=3", dict(intra_period=3), 9,
     [0, 3, 1, 2, 4, 7, 5, 6, 8]),
]


@pytest.mark.parametrize("extra,n,order", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_hierb_levels_byte_identical(extra, n, order):
    coded = check_hierb_config(extra, n, order)
    keys = [p.display_idx for p in coded if p.is_keyframe]
    assert keys == ([0, 4, 8] if extra.get("intra_period") == 3 else [0])


def test_push_qp_hierb_consumed_in_decode_order():
    qps = [30, 44, 36, 20, 50, 40]
    frames = [synthetic_frame(W, H, seed=60 + i) for i in range(6)]
    tus = encode_both(HIERB, frames, qps)
    coded = [p for p in tus if p.recon is not None]
    # decode order 0 | 4 2 1 3 | 5: the queue's k-th entry goes to the
    # k-th coded frame, with the frame's layer offset
    layers = [None, 0, 1, 2, 2, 0]
    assert [p.display_idx for p in coded] == [0, 4, 2, 1, 3, 5]
    assert [p.qindex for p in coded] == [qps[0] * 4] + [
        layer_qindex(q * 4, lay) for q, lay in zip(qps[1:], layers[1:])]
