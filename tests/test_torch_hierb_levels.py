"""Hierarchical-B parity at the long mini-GOPs that the other hier-B
tests leave out, at 192x128 with compound prediction: levels 4 (one
full 16-frame mini-GOP) and levels 5 (one full 32-frame mini-GOP).  The
port's TUs equal svt_av1_tpu's byte for byte in decode order, with
equal recon.  Levels 0 and other keyframe positions are in
test_torch_hierb_levels_short.py."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_hierb_config  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

L4 = [0, 16, 8, 4, 2, 1, 3, 6, 5, 7, 12, 10, 9, 11, 14, 13, 15]
L5 = [0, 32] + L4[1:] + [24, 20, 18, 17, 19, 22, 21, 23, 28, 26, 25, 27,
                        30, 29, 31]
# (id, config overrides, frames, coded display order)
CASES = [
    ("levels=4", dict(hierarchical_levels=4), 17, L4),
    ("levels=5", dict(hierarchical_levels=5), 33, L5),
]


@pytest.mark.parametrize("extra,n,order", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_hierb_levels_byte_identical(extra, n, order):
    coded = check_hierb_config(extra, n, order)
    assert [p.display_idx for p in coded if p.is_keyframe] == [0]
