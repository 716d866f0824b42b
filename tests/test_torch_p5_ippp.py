"""Low-delay P at presets 5 and 0 against svt_av1_tpu on the CPU.

Presets <= 5 add to the RD presets' P step the inter tx-type search
(DCT or IDTX per leaf of 8/16/32) and rectangular leaves (HORZ / VERT at
the 16 and 32 nodes), and code keyframes with the rich intra set (61
luma candidates, the DC / V / H / SMOOTH / CFL chroma pick) in the
16x16-unit search.  The port's P step (with the global-motion candidate,
as IPPP builds it) must give every output of the reference's, and IPPP
streams with two bands moving differently (so rect leaves pay) must be
byte-identical at both presets, the mirror decoder reproducing the
port's recon; frames with rect leaves take the Python tile writer."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (assert_decodes_to_recon, band_clip,  # noqa: E402
                           encode_both)
from _torch_rd import W, H, check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

IPPP = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=0,
            scene_change_detection=False, recon_output=True)


@pytest.fixture(scope="module")
def p5_tus():
    return encode_both({**IPPP, "enc_mode": 5}, band_clip(W, H, 3, axis=1))


def test_ippp_preset5_byte_identical(p5_tus):
    key, *inter = p5_tus
    assert key.is_keyframe and key.leaf16_cells
    assert any(p.rect_cells for p in inter)
    assert sum(p.idtx_cells for p in inter) > 0
    assert_decodes_to_recon(p5_tus)


def test_ippp_preset0_byte_identical():
    tus = encode_both({**IPPP, "enc_mode": 0}, band_clip(W, H, 3, axis=0))
    assert any(p.rect_cells for p in tus[1:])
    assert_decodes_to_recon(tus)


@pytest.mark.parametrize("q", [60, 160])
def test_p_step_txs_rect_equals_reference(p5_tus, q):
    """The step alone on noisy references, at two q."""
    out = check_step(1, False, 0, (q,), gm=True, p5=True)
    if q == 60:
        assert (out["shape8"] > 0).any() and (out["txty"] == 9).any()
