"""Tiled inter frames (a 2x2 grid at 320x192) on hierarchical B
(levels 2: a keyframe and a 4-frame mini-GOP), against svt_av1_tpu on
the CPU: equal TUs, and the mirror decoder reproduces the port's recon."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_tiled  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")


def test_tiled_hierb_byte_identical():
    check_tiled(dict(pred_structure=2, hierarchical_levels=2), 5)
