"""Low-delay B at the RD preset 7 against svt_av1_tpu on the CPU: every
frame after the keyframe runs the two-reference RD step without
compound prediction, from LAST and GOLDEN.  The step alone must give
the reference step's outputs; the stream's TUs must be byte-identical,
with the mirror decoder reproducing the port's recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_rd import W, H, check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402

LDB7 = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=1,
            enc_mode=7, recon_output=True)


@pytest.fixture(scope="module")
def tus():
    return encode_both(LDB7, [synthetic_frame(W, H, seed=60 + i)
                              for i in range(5)])


def test_ldb_preset7_tus_byte_identical(tus):
    assert [p.is_keyframe for p in tus] == [True] + [False] * 4
    assert all(p.compound_cells == 0 for p in tus[1:])
    assert_decodes_to_recon(tus)


def test_rd_two_reference_step_without_compound_equals_reference():
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(EncoderConfig(**LDB7), device="cpu")
    list(enc.encode_all([synthetic_frame(W, H, seed=60 + i)
                         for i in range(2)]))
    out = check_step(2, False, enc._interp_filt, (160, 60), ldb=True)
    assert set(np.unique(out["ref8"])) == {0, 1}
