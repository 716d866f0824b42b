"""Hierarchical B with compound prediction at presets 5 and 0 against
svt_av1_tpu on the CPU.

A levels-1 mini-GOP codes its base from one reference and display 1
from two (LAST and ALTREF, the span's base; a levels-2 span's display 1
adds a third, test_torch_p5_hierb3.py), the B step with the compound
candidate, the tx-type search and rect leaves, whose halves inherit a
child's reference choice and compound pair.  The port's two-reference
compound step must give every output of the reference's, and streams
of two bands moving differently must be byte-identical at both presets,
the mirror decoder reproducing the port's recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (assert_decodes_to_recon, band_clip,  # noqa: E402
                           encode_both)
from _torch_rd import W, H, check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

HIERB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
             hierarchical_levels=1, compound_mode=1,
             scene_change_detection=False, recon_output=True)


@pytest.fixture(scope="module")
def p5_tus():
    return encode_both({**HIERB, "enc_mode": 5}, band_clip(W, H, 5))


def test_hierb_preset5_byte_identical(p5_tus):
    coded = [p for p in p5_tus if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 2, 1, 4, 3]
    assert coded[0].leaf16_cells
    assert any(p.rect_cells for p in coded[1:])
    assert sum(p.compound_cells for p in coded[2::2]) > 0
    assert_decodes_to_recon(p5_tus)


def test_hierb_preset0_byte_identical():
    tus = encode_both({**HIERB, "enc_mode": 0}, band_clip(W, H, 3, axis=0))
    assert_decodes_to_recon(tus)


def test_b_step_txs_rect_equals_reference(p5_tus):
    """The compound step alone on references with strong noise over
    different thirds of the picture."""
    out = check_step(2, True, 0, (60,), p5=True)
    assert (out["shape8"] > 0).any() and (out["txty"] == 9).any()
    # a rect leaf may take either reference or the compound average
    assert set(np.unique(out["ref8"][out["shape8"] > 0])) > {0}
