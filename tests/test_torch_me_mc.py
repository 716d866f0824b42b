"""Port parity of motion estimation, the MC helpers and the P step's
subpel kernels (svt_av1_tpu_torch ops/me.py, ops/mc.py and the helpers
of pipeline/inter_encoder.py) against svt_av1_tpu on the CPU.  All
outputs are integers and must be bit-exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.ops import mc as JMC  # noqa: E402
from svt_av1_tpu.ops import me as JME  # noqa: E402
from svt_av1_tpu.pipeline import inter_encoder as JPE  # noqa: E402
from svt_av1_tpu_torch.ops import mc as TMC  # noqa: E402
from svt_av1_tpu_torch.ops import me as TME  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402

T_ = torch.from_numpy
H, W = 64, 96


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def _pair(seed=0, shift=(2, -3)):
    """A textured source and a shifted, noisy reference (uint8)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H + 16, 0:W + 16]
    base = (128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
            + rng.integers(-20, 21, (H + 16, W + 16)))
    base = np.clip(base, 0, 255).astype(np.uint8)
    src = base[8:8 + H, 8:8 + W]
    ref = base[8 + shift[0]:8 + shift[0] + H, 8 + shift[1]:8 + shift[1] + W]
    ref = np.clip(ref.astype(np.int32) + rng.integers(-2, 3, ref.shape),
                  0, 255).astype(np.uint8)
    return src, ref


def test_mv_rate_bits_bitexact():
    mv = np.random.default_rng(0).integers(-300, 301, (7, 9, 2)).astype(
        np.int32)
    mv[0, 0] = 0
    assert _eq(JME.mv_rate_bits(jnp.asarray(mv)), TME.mv_rate_bits(T_(mv)))


def test_hme_centers_bitexact():
    src, ref = _pair(1, (5, -6))
    s, r = src.astype(np.int32), ref.astype(np.int32)
    assert _eq(JME.hme_centers(jnp.asarray(s), jnp.asarray(r), 13),
               TME.hme_centers(T_(s), T_(r), 13))


def test_warp_by_centers_bitexact():
    src, ref = _pair(2)
    pad = 16
    ref_pad = np.pad(ref, pad, mode="edge")
    cen = np.random.default_rng(2).integers(-13, 14, (H // 32, W // 32, 2)
                                            ).astype(np.int32)
    assert _eq(JME.warp_by_centers(jnp.asarray(ref_pad), jnp.asarray(cen),
                                   32, pad),
               TME.warp_by_centers(T_(ref_pad), T_(cen), 32, pad))


def test_lattice_select_median_bitexact():
    src, ref = _pair(3, (1, 2))
    s = src.astype(np.int32)
    cen = np.random.default_rng(3).integers(-4, 5, (H // 32, W // 32, 2)
                                            ).astype(np.int32)
    jl = JME.sad_lattice_multisize(jnp.asarray(s), jnp.asarray(ref), 3)
    tl = TME.sad_lattice_multisize(T_(s), T_(ref), 3)
    for bs in (8, 16, 32):
        assert _eq(jl[bs], tl[bs])
    jp = JME.select_from_lattice(jl, jnp.asarray(cen), 32, 3)
    tp = TME.select_from_lattice(tl, T_(cen), 32, 3)
    jpri = {bs: JME.median3_mv_field(jp[bs][0]) for bs in (8, 16, 32)}
    tpri = {bs: TME.median3_mv_field(tp[bs][0]) for bs in (8, 16, 32)}
    jq = JME.select_from_lattice(jl, jnp.asarray(cen), 32, 3, 37, jpri)
    tq = TME.select_from_lattice(tl, T_(cen), 32, 3, 37, tpri)
    for bs in (8, 16, 32):
        for k in (0, 1):
            assert _eq(jp[bs][k], tp[bs][k])
            assert _eq(jq[bs][k], tq[bs][k])
        assert _eq(jpri[bs], tpri[bs])


def test_refined_search_multisize_bitexact():
    src, ref = _pair(4, (-2, 1))
    s = src.astype(np.int32)
    cen = np.zeros((H // 32, W // 32, 2), np.int32)
    pri = {bs: np.ones((H // bs, W // bs, 2), np.int32) for bs in (8, 16, 32)}
    want = JME.refined_search_multisize(
        jnp.asarray(s), jnp.asarray(ref.astype(np.int32)),
        jnp.asarray(cen), 32, 3, 21, {k: jnp.asarray(v)
                                      for k, v in pri.items()})
    got = TME.refined_search_multisize(T_(s), T_(ref.astype(np.int32)),
                                       T_(cen), 32, 3, 21,
                                       {k: T_(v) for k, v in pri.items()})
    for bs in (8, 16, 32):
        assert _eq(want[bs][0], got[bs][0])
        assert _eq(want[bs][1], got[bs][1])


@pytest.mark.parametrize("filt", [0, 1, 2])
def test_filter_kernels_and_padding(filt):
    for phase in range(16):
        assert JMC.kernel(phase, filt) == TMC.kernel(phase, filt)
    plane = np.random.default_rng(filt).integers(0, 256, (12, 20)).astype(
        np.uint8)
    assert _eq(JMC.pad_for_filter(jnp, jnp.asarray(plane), 5),
               TMC.pad_for_filter(T_(plane), 5))


def _patch_case(bs, halo, seed):
    rng = np.random.default_rng(seed)
    n = 12
    patch = rng.integers(0, 256, (n, bs + halo, bs + halo)).astype(np.int32)
    return patch, rng


@pytest.mark.parametrize("filt", [0, 1, 2])
def test_phase_grid_bitexact(filt):
    patch, _ = _patch_case(8, 8, filt)
    p = np.ascontiguousarray(patch.transpose(1, 2, 0))
    kern = JPE._filter_kern(filt)
    want = JPE._phase_grid(jnp.asarray(p), 8, 8, kern)
    got = TPE._phase_grid(T_(p), 8, 8, TPE._filter_kern(filt))
    for py in range(4):
        for px in range(4):
            assert _eq(want[py][px], got[py][px])


@pytest.mark.parametrize("bs,filt", [(8, 0), (4, 0), (8, 2), (4, 1)])
def test_interp_patch_bitexact(bs, filt):
    patch, rng = _patch_case(bs, 7, bs + filt)
    ph_r = rng.integers(0, 16, (3, 4)).astype(np.int32)
    ph_c = rng.integers(0, 16, (3, 4)).astype(np.int32)
    ph_r[0, :2] = 0
    ph_c[0, ::2] = 0          # copy / x-only / y-only / 2-D cases
    want = JPE._interp_patch(jnp.asarray(patch), jnp.asarray(ph_r),
                             jnp.asarray(ph_c), bs, 8, False, filt)
    got = TPE._interp_patch(T_(patch), T_(ph_r), T_(ph_c), bs, 8, filt)
    assert _eq(want, got)


@pytest.mark.parametrize("chroma", [False, True])
def test_gather_mc_patch_bitexact(chroma):
    rng = np.random.default_rng(int(chroma))
    bs, pad = (4, 9) if chroma else (8, 17)
    plane = rng.integers(0, 256, (4 * bs, 6 * bs)).astype(np.uint8)
    pp = np.asarray(JMC.pad_for_filter(np, plane, pad))
    lim = pad * (16 if chroma else 8)
    mv8 = (rng.integers(-lim // 2, lim // 2 + 1, (4, 6, 2)) * 2).astype(
        np.int32)
    want = JPE._gather_mc_patch(jnp.asarray(pp), jnp.asarray(mv8), bs, pad,
                                chroma)
    got = TPE._gather_mc_patch(T_(pp), T_(mv8), bs, pad, chroma)
    for a, b in zip(want, got):
        assert _eq(a, b)


def test_subpel_refine_dense_bitexact():
    src, ref = _pair(6, (1, -1))
    bs, pad = 16, 17
    ref_pad = np.asarray(JMC.pad_for_filter(np, ref, pad))
    s = src.astype(np.int32)
    sb = s.reshape(H // bs, bs, W // bs, bs).transpose(0, 2, 1, 3)
    rng = np.random.default_rng(6)
    mv_fp = rng.integers(-3, 4, (H // bs, W // bs, 2)).astype(np.int32)
    prior8 = rng.integers(-16, 17, (H // bs, W // bs, 2)).astype(np.int32)
    want = JPE._subpel_refine_dense(jnp.asarray(sb), jnp.asarray(ref_pad),
                                    jnp.asarray(mv_fp), bs, pad, 40,
                                    jnp.asarray(prior8))
    got = TPE._subpel_refine_dense(T_(np.ascontiguousarray(sb)),
                                   T_(ref_pad), T_(mv_fp), bs, pad, 40,
                                   T_(prior8))
    assert _eq(want[0], got[0])
    assert _eq(want[1], got[1])


def test_coeff_bits_bitexact():
    lv = np.random.default_rng(8).integers(-40, 41, (5, 6, 8, 8))
    lv[lv % 3 == 0] = 0
    lv[0, 0] = 0
    lv = lv.astype(np.int32)
    assert _eq(JPE._coeff_bits(jnp.asarray(lv)), TPE._coeff_bits(T_(lv)))
