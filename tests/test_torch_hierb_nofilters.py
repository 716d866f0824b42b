"""Hierarchical-B parity with deblocking and CDEF off at 192x128,
hierarchical_levels=2, compound prediction: the port's TUs equal
svt_av1_tpu's byte for byte in decode order, with equal recon.  In a
file of its own because the reference compiles its steps anew without
the in-loop filters."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_hierb_config  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")


def test_hierb_filters_off_byte_identical():
    coded = check_hierb_config(
        dict(enable_deblocking=False, enable_cdef=False), 6,
        [0, 4, 2, 1, 3, 5])
    assert sum(p.compound_cells for p in coded[2:5]) > 0
