"""Port parity of the intra wavefront (pipeline/intra_encoder.frame_step,
preset 8) against svt_av1_tpu's frame_step on the CPU: modes, levels and
recon bit-exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline import intra_encoder as JIE  # noqa: E402
from svt_av1_tpu_torch.pipeline import intra_encoder as TIE  # noqa: E402


@pytest.mark.parametrize("w,h,qindex,kind", [(64, 64, 160, "mix"),
                                             (136, 72, 60, "noise"),
                                             (136, 72, 252, "mix")])
def test_frame_step_bitexact(w, h, qindex, kind):
    f = synthetic_frame(w, h, seed=qindex, kind=kind)
    sy = JIE.block_planes(f.y, 8)
    su = JIE.block_planes(f.u, 4)
    sv = JIE.block_planes(f.v, 4)
    nbh, nbw = h // 8, w // 8
    want = JIE.build_frame_encoder_dyn(nbh, nbw)(
        jnp.asarray(sy), jnp.asarray(su), jnp.asarray(sv),
        jnp.int32(qindex))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = TIE.frame_step(t(sy), t(su), t(sv), qindex)
    assert len(got) == 7
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a, b.numpy())


def test_block_planes_roundtrip_numpy_and_torch():
    a = np.arange(16 * 24).reshape(16, 24)
    b = JIE.block_planes(a, 8)
    assert np.array_equal(TIE.block_planes(a, 8), b)
    assert np.array_equal(TIE.block_planes(torch.from_numpy(a), 8).numpy(),
                          b)
    assert np.array_equal(TIE.unblock_planes(torch.from_numpy(b)).numpy(),
                          a)
    with pytest.raises(ValueError):
        TIE.block_planes(a[:, :20], 8)
