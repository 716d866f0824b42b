"""10-bit hierarchical B at preset 5 against svt_av1_tpu on the CPU.

The rich keyframe search, the base P step and the compound B step with
the tx-type search and rect leaves run on 10-bit pixels (int16 on the
device, uint16 on the host).  A 3-frame levels-1 stream must be
byte-identical, the mirror decoder reproducing the port's recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402

W, H = 128, 64


def test_hierb_10bit_preset5_byte_identical():
    frames = []
    for i in range(3):
        f = synthetic_frame(W, H, seed=5, bit_depth=10)
        f.y[: H // 2 + 8] = np.roll(f.y[: H // 2 + 8], 3 * i, 1)
        frames.append(f)
    kw = dict(width=W, height=H, qp=40, bit_depth=10, intra_period=-1,
              pred_structure=2, hierarchical_levels=1, compound_mode=1,
              enc_mode=5, scene_change_detection=False, recon_output=True)
    tus = encode_both(kw, frames)
    coded = [p for p in tus if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 2, 1]
    assert coded[0].recon.y.dtype == np.uint16
    assert coded[0].recon.y.max() > 255
    assert coded[0].leaf16_cells
    assert_decodes_to_recon(tus)
