"""Port parity of the ops at 10 bits: quantization, the exact and f32
forward transforms and the inverse, intra prediction, deblocking, CDEF,
the MC kernels, the ME SAD lattice, the gather's plain version on the
port's int16 pixel container, and the RD presets' float32 J maps at
10-bit magnitudes, each against svt_av1_tpu on the CPU.

Pixels are 10-bit values (0..1023) made with numpy from a seed: uint16
for the reference, int16 for the port's device tensors (torch's uint16
has no arithmetic).  Every output must be bit-exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.ops import cdef as JC  # noqa: E402
from svt_av1_tpu.ops import deblock as JD  # noqa: E402
from svt_av1_tpu.ops import gather as JG  # noqa: E402
from svt_av1_tpu.ops import intra as JI  # noqa: E402
from svt_av1_tpu.ops import mc as JMC  # noqa: E402
from svt_av1_tpu.ops import me as JME  # noqa: E402
from svt_av1_tpu.ops import quant as JQ  # noqa: E402
from svt_av1_tpu.ops import transforms as JT  # noqa: E402
from svt_av1_tpu.pipeline import inter_encoder as JPE  # noqa: E402
from svt_av1_tpu_torch.ops import cdef as TC  # noqa: E402
from svt_av1_tpu_torch.ops import deblock as TD  # noqa: E402
from svt_av1_tpu_torch.ops import gather as TG  # noqa: E402
from svt_av1_tpu_torch.ops import intra as TI  # noqa: E402
from svt_av1_tpu_torch.ops import mc as TMC  # noqa: E402
from svt_av1_tpu_torch.ops import me as TME  # noqa: E402
from svt_av1_tpu_torch.ops import quant as TQ  # noqa: E402
from svt_av1_tpu_torch.ops import transforms as TT  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402
from svt_av1_tpu_torch.pipeline import rdo as RDO  # noqa: E402
from test_torch_rd_fp import merge_reference  # noqa: E402

BD = 10
PMAX = (1 << BD) - 1
T_ = torch.from_numpy
SQUARE = [JT.TX_4X4, JT.TX_8X8, JT.TX_16X16, JT.TX_32X32, JT.TX_64X64]


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def _resid(tx, n, seed):
    rng = np.random.default_rng(seed + tx)
    return rng.integers(-PMAX, PMAX + 1, (n, JT.TX_H[tx], JT.TX_W[tx])
                        ).astype(np.int32)


@pytest.mark.parametrize("tx", SQUARE)
@pytest.mark.parametrize("qindex", [1, 160, 255])
def test_quant_dequant_bitexact_10bit(tx, qindex):
    """The 10-bit dc_q / ac_q grids, the (1 << 17) - 1 level and
    coefficient caps; qindex 1 reaches the caps at dim-64 transforms."""
    rng = np.random.default_rng(tx * 1000 + qindex)
    c = rng.integers(-(1 << 18), 1 << 18, (16, JT.TX_H[tx], JT.TX_W[tx])
                     ).astype(np.int32)
    q = jnp.int32(qindex)
    want = np.asarray(JQ.quantize_batch(jnp.asarray(c), q, tx, BD))
    got = TQ.quantize_batch(T_(c), qindex, tx, BD).numpy()
    assert np.array_equal(want, got)
    want_dq = np.asarray(JQ.dequantize_batch(jnp.asarray(want), q, tx, BD))
    got_dq = TQ.dequantize_batch(T_(got), qindex, tx, BD).numpy()
    assert np.array_equal(want_dq, got_dq)


def test_quant_per_block_qindex_10bit():
    rng = np.random.default_rng(11)
    c = rng.integers(-40000, 40000, (3, 4, 16, 16)).astype(np.int32)
    qmap = rng.integers(1, 256, (3, 4)).astype(np.int32)
    want = np.asarray(JQ.quantize_batch(jnp.asarray(c), jnp.asarray(qmap),
                                        JT.TX_16X16, BD))
    got = TQ.quantize_batch(T_(c), T_(qmap), JT.TX_16X16, BD).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx", [JT.TX_8X8, JT.TX_4X4, JT.TX_16X16])
def test_fwd_exact_bitexact_10bit(tx):
    """The keyframe path's int32 forward with its bd+8 and max(bd+6, 16)
    clamps (8x8 / 4x4 blocks, 16x16 leaves at the RD presets)."""
    r = _resid(tx, 64, 3)
    want = np.asarray(JT.fwd_txfm2d_batch_exact(jnp.asarray(r), tx,
                                                JT.DCT_DCT, BD))
    got = TT.fwd_txfm2d_batch_exact(T_(r), tx, JT.DCT_DCT, BD).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx", SQUARE)
def test_fwd_f32_bitexact_10bit(tx):
    """The inter path's f32 forward (XLA:CPU's dot order) on 10-bit
    residuals."""
    r = _resid(tx, 96, 5)
    want = np.asarray(JT.fwd_txfm2d_batch(jnp.asarray(r), tx, JT.DCT_DCT,
                                          BD))
    got = TT.fwd_txfm2d_batch(T_(r), tx, JT.DCT_DCT, BD).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx", SQUARE)
def test_inv_bitexact_10bit(tx):
    """range_row 18 and the bd+8 / max(bd+6, 16) clamps of the inverse;
    coefficients reach past the clamps."""
    rng = np.random.default_rng(tx + 40)
    c = rng.integers(-(1 << 18), 1 << 18, (32, JT.TX_H[tx], JT.TX_W[tx])
                     ).astype(np.int32)
    want = np.asarray(JT.inv_txfm2d_batch(jnp.asarray(c), tx, JT.DCT_DCT,
                                          BD))
    got = TT.inv_txfm2d_batch(T_(c), tx, JT.DCT_DCT, BD).numpy()
    assert np.array_equal(want, got)


def test_fwd_int32_bound_propagation_10bit():
    """No butterfly of the port's int32 forward reaches 2^31 for 10-bit
    residuals, at any of the 19 transform sizes (tests/test_transforms.py's
    8-bit proof, started from 1023 << s0).  The rectangular sqrt(2)
    rescale is bounded below 2^31 at every size but 32x64 and 64x32,
    where the worst case is ~2.25 * 2^31: those two sizes never reach
    the int32 forward (it codes the keyframes' square blocks; larger and
    rectangular inter transforms take the f32 forward)."""
    rect_over = []
    for tx_size in range(TT.TX_SIZES_ALL):
        w, h = TT.TX_W[tx_size], TT.TX_H[tx_size]
        s0, s1, _ = TT.FWD_SHIFT[tx_size]
        wi, hi = w.bit_length() - 3, h.bit_length() - 3
        cb_col, cb_row = TT.FWD_COS_BIT_COL[wi][hi], TT.FWD_COS_BIT_ROW[wi][hi]

        def pass_bound(key, cos_bit, start, n):
            bound = np.full(n, float(start))
            for a, b, wa, wb, is_mul, _ in TT.compiled_stages(key, cos_bit):
                raw = np.abs(wa) * bound[a] + np.abs(wb) * bound[b] \
                    + (1 << (cos_bit - 1))
                assert raw.max() < 2 ** 31, (tx_size, key, raw.max())
                bound = np.where(is_mul, raw / (1 << cos_bit),
                                 np.abs(wa) * bound[a] + np.abs(wb) * bound[b])
            return bound.max()

        start = PMAX * (1 << s0)
        for vk in [f"fdct{h}"] + ([f"fadst{h}"] if 4 < h <= 16 else []):
            colmax = pass_bound(vk, cb_col, start, h)
            mid = colmax / (1 << -s1) if s1 < 0 else colmax
            for hk in [f"fdct{w}"] + ([f"fadst{w}"] if 4 < w <= 16 else []):
                rowmax = pass_bound(hk, cb_row, mid, w)
                if abs(wi - hi) == 1 and rowmax * TT.NEW_SQRT2 >= 2 ** 31:
                    rect_over.append(tx_size)
    assert sorted(set(rect_over)) == [JT.TX_32X64, JT.TX_64X32]


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_predict_all_modes_bitexact_10bit(bs):
    """Edge base values 1 << (bd - 1) where a side is missing, and the
    10-bit clips of the smooth / paeth / directional modes."""
    rng = np.random.default_rng(bs + 10)
    B = 48
    edge = lambda *shape: rng.integers(0, PMAX + 1, shape).astype(np.int32)
    above, left, tl, ext = edge(B, bs), edge(B, bs), edge(B), edge(B, bs)
    ha = rng.random(B) < 0.7
    hl = rng.random(B) < 0.7
    ar = rng.random(B) < 0.5
    modes = tuple(JI.ALL_MODES)
    want = np.asarray(JI.predict_all_modes(
        jnp.asarray(above), jnp.asarray(left), jnp.asarray(tl),
        jnp.asarray(ha), jnp.asarray(hl), bs, bs, BD, modes=modes,
        above_ext=jnp.asarray(ext), ar_avail=jnp.asarray(ar)))
    got = TI.predict_all_modes(T_(above), T_(left), T_(tl), T_(ha),
                               T_(hl), bs, bs, BD, modes=modes,
                               above_ext=T_(ext), ar_avail=T_(ar)).numpy()
    assert np.array_equal(want, got)
    assert got.max() > 255


def _blocky(H, W, bs, rng):
    vals = rng.integers(160, 864, (H // bs, W // bs))
    noise = rng.integers(-12, 13, (H, W))
    return (np.repeat(np.repeat(vals, bs, 0), bs, 1) + noise).astype(
        np.int32)


@pytest.mark.parametrize("luma,level", [(True, 12), (True, 40), (False, 9)])
def test_deblock_plane_bitexact_10bit(luma, level):
    """Thresholds and offsets shifted by bd - 8, mixed leaf sizes."""
    rng = np.random.default_rng(level + 100)
    H, W = 64, 128
    plane = _blocky(H, W, 8 if luma else 4, rng)
    cells = rng.choice([8, 16, 32, 64], (H // 64, W // 64))
    sz = np.repeat(np.repeat(cells, 64, 0), 64, 1)
    sz = (sz if luma else sz // 2).astype(np.int32)
    want = np.asarray(JD.deblock_plane(jnp, jnp.asarray(plane),
                                       jnp.asarray(sz), level, level, luma,
                                       bd=BD))
    got = TD.deblock_plane(T_(plane), T_(sz), level, level, luma,
                           bd=BD).numpy()
    assert np.array_equal(want, got)
    assert np.count_nonzero(got != plane) > 0


def test_find_dir_grid_bitexact_10bit():
    rng = np.random.default_rng(12)
    luma = rng.integers(0, PMAX + 1, (64, 96)).astype(np.int32)
    wd, wv = JC.find_dir_grid(np, luma, coeff_shift=BD - 8)
    gd, gv = TC.find_dir_grid(T_(luma), coeff_shift=BD - 8)
    assert np.array_equal(wd, gd.numpy())
    assert np.array_equal(wv, gv.numpy())


@pytest.mark.parametrize("damping", [3, 5])
def test_cdef_search_and_apply_bitexact_10bit(damping):
    """coeff_shift = 2: strengths scaled, damping adjusted and the
    direction search on the shifted planes."""
    rng = np.random.default_rng(damping + 20)
    H, W = 72, 136
    y = _blocky(H, W, 8, rng)
    u = _blocky(H // 2, W // 2, 4, rng)
    v = _blocky(H // 2, W // 2, 4, rng)
    srcs = [np.clip(p + rng.integers(-24, 25, p.shape), 0, PMAX).astype(
        np.int32) for p in (y, u, v)]
    skip8 = rng.random((H // 8, W // 8)) < 0.2
    fn = jax.jit(lambda p, s, k: JC.cdef_search_and_apply(
        jnp, p, s, k, damping, coeff_shift=BD - 8))
    (wy, wu, wv), widx = fn(tuple(jnp.asarray(p) for p in (y, u, v)),
                            tuple(jnp.asarray(s) for s in srcs),
                            jnp.asarray(skip8))
    (gy, gu, gv), gidx = TC.cdef_search_and_apply(
        tuple(T_(p) for p in (y, u, v)), tuple(T_(s) for s in srcs),
        T_(skip8), damping, coeff_shift=BD - 8)
    for a, b in ((wy, gy), (wu, gu), (wv, gv), (widx, gidx)):
        assert np.array_equal(np.asarray(a), b.numpy())


def _pair10(seed, shift, H=64, W=96):
    """A textured 10-bit source and a shifted, noisy reference: uint16
    for the reference package, int16 for the port."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H + 16, 0:W + 16]
    base = (512 + 240 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
            + rng.integers(-80, 81, (H + 16, W + 16)))
    base = np.clip(base, 0, PMAX).astype(np.uint16)
    src = base[8:8 + H, 8:8 + W]
    ref = base[8 + shift[0]:8 + shift[0] + H, 8 + shift[1]:8 + shift[1] + W]
    ref = np.clip(ref.astype(np.int32) + rng.integers(-8, 9, ref.shape),
                  0, PMAX).astype(np.uint16)
    return src, ref


def test_sad_lattice_and_hme_bitexact_10bit():
    """The reference sweeps 10-bit SADs in int32 (64 * 1023 > int16);
    the port sweeps in int32 at every bit depth."""
    src, ref = _pair10(1, (3, -2))
    s = src.astype(np.int32)
    jl = JME.sad_lattice_multisize(jnp.asarray(s), jnp.asarray(ref), 4, BD)
    tl = TME.sad_lattice_multisize(T_(s), T_(ref.astype(np.int16)), 4, BD)
    for bs in (8, 16, 32):
        assert _eq(jl[bs], tl[bs])
    assert int(tl[8].max()) > 32767 // 4
    r = ref.astype(np.int32)
    assert _eq(JME.hme_centers(jnp.asarray(s), jnp.asarray(r), 13),
               TME.hme_centers(T_(s), T_(r), 13))


def test_warp_by_centers_int16_bitexact_10bit():
    """The ME warp gathers the 10-bit reference in its pixel container:
    uint16 in the reference package, int16 in the port."""
    _, ref = _pair10(2, (0, 0))
    pad = 16
    ref_pad = np.pad(ref, pad, mode="edge")
    cen = np.random.default_rng(2).integers(-13, 14, (2, 3, 2)).astype(
        np.int32)
    want = JME.warp_by_centers(jnp.asarray(ref_pad), jnp.asarray(cen), 32,
                               pad)
    got = TME.warp_by_centers(T_(ref_pad.astype(np.int16)), T_(cen), 32, pad)
    assert got.dtype == torch.int16
    assert np.array_equal(np.asarray(want).astype(np.int32),
                          got.numpy().astype(np.int32))


@pytest.mark.parametrize("bs,halo,off", [(8, 8, -4), (16, 8, -4),
                                         (32, 8, -4), (64, 7, -3),
                                         (4, 7, -3)])
def test_gather_plain_int16_bitexact_10bit(bs, halo, off):
    """The gather's plain version on int16 planes (the port's 10-bit
    container) equals the reference's gather of the same uint16 plane,
    at the 4K VOD path's tile shapes: the dense refine at 8 / 16 / 32,
    a 71x71 candidate and a chroma MC patch."""
    rng = np.random.default_rng(bs)
    nbh, nbw, pad = 3, 4, 17
    reach = pad - 1 if off == -4 else pad      # as the step's call sites
    plane = rng.integers(0, PMAX + 1, (nbh * bs + 2 * pad + 7,
                                       nbw * bs + 2 * pad + 7)
                         ).astype(np.uint16)
    mv_r = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    want = np.asarray(JG.gather_blocks_grid(
        jnp.asarray(plane), jnp.asarray(mv_r), jnp.asarray(mv_c), bs, pad,
        reach, halo=halo, off=off))
    got = TG.gather_blocks_grid(T_(plane.astype(np.int16)), T_(mv_r),
                                T_(mv_c), bs, pad, reach, halo=halo, off=off)
    assert got.dtype == torch.int16
    assert got.shape[-1] == bs + halo
    assert np.array_equal(want.astype(np.int32), got.numpy().astype(np.int32))


@pytest.mark.parametrize("filt", [0, 2])
def test_phase_grid_bitexact_10bit(filt):
    rng = np.random.default_rng(filt + 30)
    p = rng.integers(0, PMAX + 1, (16, 16, 12)).astype(np.int32)
    want = JPE._phase_grid(jnp.asarray(p), 8, BD, JPE._filter_kern(filt))
    got = TPE._phase_grid(T_(p), 8, BD, TPE._filter_kern(filt))
    for py in range(4):
        for px in range(4):
            assert _eq(want[py][px], got[py][px])


@pytest.mark.parametrize("bs,filt", [(8, 0), (4, 1), (16, 2)])
def test_interp_patch_and_compound_bitexact_10bit(bs, filt):
    """The regular MC (copy / x-only / y-only / 2-D rounding), the
    CONV_BUF-domain compound output and the COMPOUND_AVERAGE at 10
    bits: the clip to 1023 and the bd-dependent offsets."""
    rng = np.random.default_rng(bs * 3 + filt)
    patch = rng.integers(0, PMAX + 1, (12, bs + 7, bs + 7)).astype(np.int32)
    patch2 = rng.integers(0, PMAX + 1, (12, bs + 7, bs + 7)).astype(np.int32)
    ph_r = rng.integers(0, 16, (3, 4)).astype(np.int32)
    ph_c = rng.integers(0, 16, (3, 4)).astype(np.int32)
    ph_r[0, :2] = 0
    ph_c[0, ::2] = 0
    jargs = (jnp.asarray(ph_r), jnp.asarray(ph_c), bs, BD)
    targs = (T_(ph_r), T_(ph_c), bs, BD, filt)
    want = JPE._interp_patch(jnp.asarray(patch), *jargs, False, filt)
    got = TPE._interp_patch(T_(patch), *targs)
    assert _eq(want, got)
    assert int(got.max()) > 255
    j0 = JPE._interp_patch(jnp.asarray(patch), *jargs, True, filt)
    j1 = JPE._interp_patch(jnp.asarray(patch2), *jargs, True, filt)
    t0 = TPE._interp_patch(T_(patch), *targs, jnt=True)
    t1 = TPE._interp_patch(T_(patch2), *targs, jnt=True)
    assert _eq(j0, t0) and _eq(j1, t1)
    both = TPE._interp_patch(T_(patch), *targs, both=True)
    assert torch.equal(both[0], got) and torch.equal(both[1], t0)
    assert _eq(JMC.jnt_average(jnp, j0, j1, BD), TMC.jnt_average(t0, t1, BD))


def test_subpel_refine_dense_bitexact_10bit():
    src, ref = _pair10(6, (1, -1))
    H, W = src.shape
    bs, pad = 16, 17
    ref_pad = np.asarray(JMC.pad_for_filter(np, ref, pad))
    s = src.astype(np.int32)
    sb = s.reshape(H // bs, bs, W // bs, bs).transpose(0, 2, 1, 3)
    rng = np.random.default_rng(6)
    mv_fp = rng.integers(-3, 4, (H // bs, W // bs, 2)).astype(np.int32)
    prior8 = rng.integers(-16, 17, (H // bs, W // bs, 2)).astype(np.int32)
    want = JPE._subpel_refine_dense(jnp.asarray(sb), jnp.asarray(ref_pad),
                                    jnp.asarray(mv_fp), bs, pad, 160,
                                    jnp.asarray(prior8), BD)
    got = TPE._subpel_refine_dense(
        T_(np.ascontiguousarray(sb)), T_(ref_pad.astype(np.int32)),
        T_(mv_fp), bs, pad, 160, T_(prior8), BD)
    assert _eq(want[0], got[0])
    assert _eq(want[1], got[1])


# ac_q over the 10-bit qindex range (tables.ac_q(q, 10) at q = 1, 40,
# 120, 200, 255)
AC10 = (9, 158, 604, 2555, 7312)


@pytest.mark.parametrize("ac", AC10)
def test_rd_merge_maps_equal_reference_10bit(ac):
    """The RD merge's float32 J maps at 10-bit magnitudes: SSE up to
    2^31 - 1 (a 64x64 block of 10-bit residuals) and the 10-bit lambda
    (up to ~2.1e5), at the 8x8-cell map of a 200x136 frame."""
    from svt_av1_tpu_torch import tables

    assert ac in {tables.ac_q(q, BD) for q in (1, 40, 120, 200, 255)}
    rng = np.random.default_rng(ac)
    shp = {bs: (24 * 8 // bs, 32 * 8 // bs) for bs in (8, 16, 32, 64)}
    d = {bs: rng.integers(0, (1 << 31) - 1, shp[bs]).astype(np.int32)
         for bs in shp}
    r = {bs: rng.integers(0, 1 << 15, shp[bs]).astype(np.int32) for bs in shp}
    ins = {bs: rng.random(shp[bs]) < 0.9 for bs in (16, 32, 64)}
    want = jax.jit(merge_reference)(d, r, ins, jnp.int32(ac))
    lam = float(max(4, (ac * ac) >> 8))
    jc = {bs: RDO.fma_f32(lam, torch.from_numpy(r[bs]).float(),
                          torch.from_numpy(d[bs]).float()) for bs in shp}
    use16, use32, use64, maps = TPE.rd_merge(
        jc, lam, {bs: torch.from_numpy(m) for bs, m in ins.items()})
    maps.update(use16=use16, use32=use32, use64=use64)
    for k, v in want.items():
        assert np.array_equal(maps[k].numpy(), np.asarray(v)), k
