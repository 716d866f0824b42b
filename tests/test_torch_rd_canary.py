"""854x480 canary at the RD preset 6: a frame size that is not a
multiple of 64 and wider than 512 (header and edge bit layouts hide at
small sizes).  Hierarchical B at hierarchical_levels=1 codes the
keyframe (16x16 search), a base P frame and a two-reference compound B
frame through the RD steps; the TUs must equal svt_av1_tpu's byte for
byte in decode order, with the mirror decoder reproducing the port's
recon.  (Three-reference frames need a longer mini-GOP; they are held
to the reference at 192x128, tests/test_torch_rd_hierb.py.)"""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402

W, H = 854, 480


@pytest.fixture(scope="module")
def tus():
    kw = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
              hierarchical_levels=1, compound_mode=1, enc_mode=6,
              scene_change_detection=False, recon_output=True)
    return encode_both(kw, [synthetic_frame(W, H, seed=40 + i)
                            for i in range(3)])


def test_hierb_preset6_854x480_byte_identical(tus):
    coded = [p for p in tus if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 2, 1]
    assert coded[0].leaf16_cells


def test_hierb_preset6_854x480_mirror_decoder_reproduces_port_recon(tus):
    assert_decodes_to_recon(tus)
