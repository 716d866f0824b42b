"""Low-delay P (IPPP) at the RD preset 7 against svt_av1_tpu on the CPU.

The P step with rdo=True: the +-4 lattice, the dense quarter-pel
refinement per size, the subpel GLOBALMV candidate per size, the 64x64
candidates from the 32x32 winners, residual coding of every leaf size
and the float32 RD merge.  The port's step must give the reference
step's outputs on references with strong noise over part of the picture
(mixed leaf sizes), at a low and a high qindex; IPPP streams at preset
7 (global motion on, the default) must be byte-identical at qp 40, 0
and 63, with the mirror decoder reproducing the port's recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_rd import W, H, check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402

IPPP7 = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=0,
             enc_mode=7, scene_change_detection=False, recon_output=True)


def frames(n, seed=60):
    return [synthetic_frame(W, H, seed=seed + i) for i in range(n)]


@pytest.fixture(scope="module")
def default_run():
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    tus = encode_both(IPPP7, frames(4))
    enc = Encoder(EncoderConfig(**IPPP7), device="cpu")
    list(enc.encode_all(frames(2)))
    return tus, enc._interp_filt


def test_ippp_preset7_tus_byte_identical(default_run):
    tus, _ = default_run
    assert [p.is_keyframe for p in tus] == [True, False, False, False]
    assert tus[0].leaf16_cells
    assert_decodes_to_recon(tus)


def test_rd_p_step_with_global_motion_equals_reference(default_run):
    _, filt = default_run
    out = check_step(1, False, filt, (200, 60), gm=True)
    assert len(np.unique(out["sizes"])) >= 2


@pytest.mark.parametrize("qp", [0, 63])
def test_ippp_preset7_extreme_qp_byte_identical(qp):
    tus = encode_both({**IPPP7, "qp": qp}, frames(3, seed=90))
    assert_decodes_to_recon(tus)
