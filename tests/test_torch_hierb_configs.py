"""Hierarchical-B parity with periodic keyframes, at the ends of the qp
range and with a 2-frame mini-GOP, at 192x128 with compound prediction:
the port's TUs equal svt_av1_tpu's byte for byte in decode order, with
equal recon.  A keyframe that lands inside a buffered mini-GOP
truncates the span before it and restarts the slot book, which changes
refresh_frame_flags and ref_frame_idx in the headers that follow."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_hierb_config  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

# (id, config overrides, frames, coded display order).  intra_period=5
# over 8 frames: mini-GOP 1-4, then frame 5 is buffered when the
# keyframe 6 arrives, so the span (4, 5] is coded truncated before it,
# and flush codes (6, 7].  The others code one mini-GOP and a truncated
# 1-frame span.
CASES = [
    ("intra_period=5", dict(intra_period=5), 8, [0, 4, 2, 1, 3, 5, 6, 7]),
    ("qp0", dict(qp=0), 6, [0, 4, 2, 1, 3, 5]),
    ("qp63", dict(qp=63), 6, [0, 4, 2, 1, 3, 5]),
    ("levels=1", dict(hierarchical_levels=1), 4, [0, 2, 1, 3]),
]


@pytest.mark.parametrize("extra,n,order", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_hierb_config_byte_identical(extra, n, order):
    coded = check_hierb_config(extra, n, order)
    keys = [p.display_idx for p in coded if p.is_keyframe]
    assert keys == ([0, 6] if extra.get("intra_period") == 5 else [0])
