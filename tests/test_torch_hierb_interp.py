"""Hierarchical-B parity with the sharp interpolation filter fixed
(interp_filter=2) at 192x128, hierarchical_levels=2, compound
prediction: the port's TUs equal svt_av1_tpu's byte for byte in decode
order, with equal recon.  In a file of its own because the reference
compiles its steps anew for the filter."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_hierb_config  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")


def test_hierb_sharp_filter_byte_identical():
    coded = check_hierb_config(dict(interp_filter=2), 6, [0, 4, 2, 1, 3, 5])
    assert sum(p.compound_cells for p in coded[2:5]) > 0
