"""Port parity: transforms, quantization, intra prediction, deblocking and
CDEF of svt_av1_tpu_torch against svt_av1_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Every integer output must be bit-exact, the f32 forward transform of
the inter path included (it sums in XLA:CPU's order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.ops import cdef as JC  # noqa: E402
from svt_av1_tpu.ops import deblock as JD  # noqa: E402
from svt_av1_tpu.ops import intra as JI  # noqa: E402
from svt_av1_tpu.ops import quant as JQ  # noqa: E402
from svt_av1_tpu.ops import transforms as JT  # noqa: E402
from svt_av1_tpu_torch.ops import cdef as TC  # noqa: E402
from svt_av1_tpu_torch.ops import deblock as TD  # noqa: E402
from svt_av1_tpu_torch.ops import intra as TI  # noqa: E402
from svt_av1_tpu_torch.ops import quant as TQ  # noqa: E402
from svt_av1_tpu_torch.ops import transforms as TT  # noqa: E402

T_ = torch.from_numpy

# (tx size, tx type) pairs the slice runs: intra 8x8 luma / 4x4 chroma
# DCT (exact forward); inter square DCT 8..64 luma, 4..32 chroma (f32
# forward); the inverse runs on all of them
EXACT_FWD = [(JT.TX_8X8, JT.DCT_DCT), (JT.TX_4X4, JT.DCT_DCT)]
INTER = [(JT.TX_4X4, JT.DCT_DCT), (JT.TX_8X8, JT.DCT_DCT),
         (JT.TX_16X16, JT.DCT_DCT), (JT.TX_32X32, JT.DCT_DCT),
         (JT.TX_64X64, JT.DCT_DCT)]


def _resid(tx, n=64, seed=0):
    rng = np.random.default_rng(seed + tx)
    return rng.integers(-255, 256, (n, JT.TX_H[tx], JT.TX_W[tx])).astype(
        np.int32)


@pytest.mark.parametrize("tx,ty", EXACT_FWD)
def test_fwd_exact_bitexact(tx, ty):
    r = _resid(tx)
    want = np.asarray(JT.fwd_txfm2d_batch_exact(jnp.asarray(r), tx, ty))
    got = TT.fwd_txfm2d_batch_exact(T_(r), tx, ty).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx,ty", INTER + [(JT.TX_4X4, JT.ADST_DCT),
                                           (JT.TX_4X4, JT.DCT_ADST),
                                           (JT.TX_4X4, JT.ADST_ADST)])
def test_inv_bitexact(tx, ty):
    rng = np.random.default_rng(tx * 16 + ty)
    c = rng.integers(-4000, 4000, (32, JT.TX_H[tx], JT.TX_W[tx])).astype(
        np.int32)
    want = np.asarray(JT.inv_txfm2d_batch(jnp.asarray(c), tx, ty))
    got = TT.inv_txfm2d_batch(T_(c), tx, ty).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx,ty", INTER)
def test_fwd_f32_bitexact_vs_xla(tx, ty):
    """The f32 forward sums in XLA:CPU's order (lanes of fused
    multiply-adds, TT.XLA_DOT_LANES), so it equals the reference's einsum
    bit for bit, and card and CPU agree because every step is
    elementwise."""
    r = _resid(tx, n=128, seed=7)
    want = np.asarray(JT.fwd_txfm2d_batch(jnp.asarray(r), tx, ty))
    got = TT.fwd_txfm2d_batch(T_(r), tx, ty).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx", [JT.TX_16X16, JT.TX_32X32, JT.TX_64X64])
@pytest.mark.parametrize("n", [3, 41, 240])
def test_fwd_f32_bitexact_vs_xla_batch_sizes(tx, n):
    """The order holds at every batch size (the dot's M = n * width),
    not only at the one above: 240 is the 720p count of 64x64 blocks."""
    r = _resid(tx, n=n, seed=n)
    want = np.asarray(JT.fwd_txfm2d_batch(jnp.asarray(r), tx, JT.DCT_DCT))
    got = TT.fwd_txfm2d_batch(T_(r), tx, JT.DCT_DCT).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("tx", [JT.TX_4X4, JT.TX_8X8, JT.TX_16X16,
                                JT.TX_32X32, JT.TX_64X64])
@pytest.mark.parametrize("qindex", [4, 160, 255])
def test_quant_dequant_bitexact(tx, qindex):
    rng = np.random.default_rng(tx * 1000 + qindex)
    c = rng.integers(-6000, 6000, (16, JT.TX_H[tx], JT.TX_W[tx])).astype(
        np.int32)
    q = jnp.int32(qindex)     # the reference's per-frame (traced) q path
    want = np.asarray(JQ.quantize_batch(jnp.asarray(c), q, tx))
    got = TQ.quantize_batch(T_(c), qindex, tx).numpy()
    assert np.array_equal(want, got)
    want_dq = np.asarray(JQ.dequantize_batch(jnp.asarray(want), q, tx))
    got_dq = TQ.dequantize_batch(T_(got), qindex, tx).numpy()
    assert np.array_equal(want_dq, got_dq)


def test_quant_per_block_qindex():
    rng = np.random.default_rng(5)
    c = rng.integers(-3000, 3000, (3, 4, 8, 8)).astype(np.int32)
    qmap = rng.integers(1, 256, (3, 4)).astype(np.int32)
    want = np.asarray(JQ.quantize_batch(jnp.asarray(c), jnp.asarray(qmap),
                                        JT.TX_8X8))
    got = TQ.quantize_batch(T_(c), T_(qmap), JT.TX_8X8).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("bs", [4, 8])
def test_predict_all_modes_bitexact(bs):
    rng = np.random.default_rng(bs)
    B = 48
    above = rng.integers(0, 256, (B, bs)).astype(np.int32)
    left = rng.integers(0, 256, (B, bs)).astype(np.int32)
    tl = rng.integers(0, 256, B).astype(np.int32)
    ext = rng.integers(0, 256, (B, bs)).astype(np.int32)
    ha = rng.random(B) < 0.7
    hl = rng.random(B) < 0.7
    ar = rng.random(B) < 0.5
    modes = tuple(JI.ALL_MODES)
    want = np.asarray(JI.predict_all_modes(
        jnp.asarray(above), jnp.asarray(left), jnp.asarray(tl),
        jnp.asarray(ha), jnp.asarray(hl), bs, bs, 8, modes=modes,
        above_ext=jnp.asarray(ext), ar_avail=jnp.asarray(ar)))
    got = TI.predict_all_modes(T_(above), T_(left), T_(tl), T_(ha),
                               T_(hl), bs, bs, 8, modes=modes,
                               above_ext=T_(ext), ar_avail=T_(ar)).numpy()
    assert np.array_equal(want, got)


def _blocky(H, W, bs, rng):
    vals = rng.integers(40, 216, (H // bs, W // bs))
    noise = rng.integers(-3, 4, (H, W))
    return (np.repeat(np.repeat(vals, bs, 0), bs, 1) + noise).astype(
        np.int32)


@pytest.mark.parametrize("luma,level", [(True, 12), (True, 40),
                                        (False, 9), (True, 0)])
def test_deblock_plane_bitexact(luma, level):
    """Mixed 8/16/32/64 size maps (the P step's leaf sizes)."""
    rng = np.random.default_rng(level)
    H, W = 64, 128
    bs = 8 if luma else 4
    plane = _blocky(H, W, bs, rng)
    cells = rng.choice([8, 16, 32, 64], (H // 64, W // 64))
    sz = np.repeat(np.repeat(cells, 64, 0), 64, 1)
    sz = (sz if luma else sz // 2).astype(np.int32)
    want = np.asarray(JD.deblock_plane(jnp, jnp.asarray(plane),
                                       jnp.asarray(sz), level, level, luma))
    got = TD.deblock_plane(T_(plane), T_(sz), level, level, luma).numpy()
    assert np.array_equal(want, got)
    if level:
        assert np.count_nonzero(got != plane) > 0


def test_find_dir_grid_bitexact():
    rng = np.random.default_rng(1)
    luma = rng.integers(0, 256, (64, 96)).astype(np.int32)
    wd, wv = JC.find_dir_grid(np, luma)
    gd, gv = TC.find_dir_grid(T_(luma))
    assert np.array_equal(wd, gd.numpy())
    assert np.array_equal(wv, gv.numpy())


@pytest.mark.parametrize("damping", [3, 5])
def test_cdef_search_and_apply_bitexact(damping):
    rng = np.random.default_rng(damping)
    H, W = 72, 136            # partial superblocks on both edges
    y = _blocky(H, W, 8, rng)
    u = _blocky(H // 2, W // 2, 4, rng)
    v = _blocky(H // 2, W // 2, 4, rng)
    srcs = [np.clip(p + rng.integers(-6, 7, p.shape), 0, 255).astype(
        np.int32) for p in (y, u, v)]
    skip8 = rng.random((H // 8, W // 8)) < 0.2
    fn = jax.jit(lambda p, s, k: JC.cdef_search_and_apply(
        jnp, p, s, k, damping))
    (wy, wu, wv), widx = fn(tuple(jnp.asarray(p) for p in (y, u, v)),
                            tuple(jnp.asarray(s) for s in srcs),
                            jnp.asarray(skip8))
    (gy, gu, gv), gidx = TC.cdef_search_and_apply(
        tuple(T_(p) for p in (y, u, v)), tuple(T_(s) for s in srcs),
        T_(skip8), damping)
    for a, b in ((wy, gy), (wu, gu), (wv, gv), (widx, gidx)):
        assert np.array_equal(np.asarray(a), b.numpy())
