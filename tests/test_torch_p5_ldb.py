"""Low-delay B at presets 5 and 0 against svt_av1_tpu on the CPU.

Every frame after the keyframe runs the two-reference step (LAST and
GOLDEN) without compound prediction, with the tx-type search and rect
leaves.  The port's step must give every output of the reference's, and
streams of two bands moving differently must be byte-identical at both
presets, the mirror decoder reproducing the port's recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (assert_decodes_to_recon, band_clip,  # noqa: E402
                           encode_both)
from _torch_rd import W, H, check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

LDB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=1,
           scene_change_detection=False, recon_output=True)


@pytest.fixture(scope="module")
def p5_tus():
    return encode_both({**LDB, "enc_mode": 5}, band_clip(W, H, 3))


def test_ldb_preset5_byte_identical(p5_tus):
    assert p5_tus[0].is_keyframe and p5_tus[0].leaf16_cells
    assert any(p.rect_cells for p in p5_tus[1:])
    assert_decodes_to_recon(p5_tus)


def test_ldb_preset0_byte_identical():
    tus = encode_both({**LDB, "enc_mode": 0}, band_clip(W, H, 3, axis=0))
    assert_decodes_to_recon(tus)


def test_ldb_step_txs_rect_equals_reference(p5_tus):
    out = check_step(2, False, 0, (60, 160), ldb=True, p5=True)
    assert set(np.unique(out["ref8"])) <= {0, 1}
