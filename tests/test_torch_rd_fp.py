"""The float32 arithmetic of the RD presets against XLA:CPU's.

The RD presets decide partitions on J = float32(SSE) + lambda * bits.
svt_av1_tpu evaluates those expressions under XLA:CPU, which contracts
an array product into the following add (one fused multiply-add),
rounds a product of two scalars on its own, and orders each 2x2 float32
block sum per merge level and map width.  The port emulates that
(svt_av1_tpu_torch/pipeline/rdo.py); a one-ulp difference would flip a
near-tie and change the packets.  Each test runs the reference's
expression under jax.jit on the CPU and the port's on the same inputs,
chosen where the evaluation orders differ, and asks for equal bits.
tools/probe_xla_rd_order.py re-derives the orders on another CPU or
jax version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.pipeline import intra_encoder as JIE  # noqa: E402
from svt_av1_tpu.pipeline import rdo as JRDO  # noqa: E402
from svt_av1_tpu.pipeline.inter_encoder import (_PART_BITS,  # noqa: E402
                                                _coeff_bits, _sum4)
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402
from svt_av1_tpu_torch.pipeline import intra_encoder as TIE  # noqa: E402
from svt_av1_tpu_torch.pipeline import rdo as RDO  # noqa: E402

ACS = (4, 40, 200, 700, 1828)      # ac_q over the 8-bit qindex range


def lam_of(ac):
    return float(max(4, (ac * ac) >> 8))


def test_rate_constants_equal_reference():
    assert RDO.partition_bits() == JRDO.partition_bits()
    assert RDO.inter_leaf_bits() == JRDO.inter_leaf_bits()
    assert RDO.intra_leaf_bits() == JRDO.intra_leaf_bits()
    assert (TIE.MODE_BITS_I, TIE.PART_NONE_I, TIE.PART_SPLIT_I,
            TIE._PART_NONE16_I) == (JIE.MODE_BITS_I, JIE.PART_NONE_I,
                                    JIE.PART_SPLIT_I, JIE._PART_NONE16_I)


def near_ties(rng, n, ac):
    """(d, r) int32 pairs where float32(d) + lam * r rounds differently
    as one fused multiply-add than as two roundings, plus exact
    round-half-to-even midpoints above 2^24."""
    lam = lam_of(ac)
    d = rng.integers(0, 1 << 30, 8 * n).astype(np.int32)
    r = rng.integers(0, 1 << 20, 8 * n).astype(np.int32)
    two = d.astype(np.float32) + np.float32(lam) * r.astype(np.float32)
    one = (d.astype(np.float32).astype(np.float64)
           + lam * r.astype(np.float64)).astype(np.float32)
    pick = np.flatnonzero(two != one)[:n]
    # midpoints: lam * r + d = 2^25 + 2 (float32 spacing 4 there)
    rm = np.arange(1, 64, dtype=np.int64)
    dm = (1 << 25) + 2 - int(lam) * rm
    ok = (dm >= 0) & (dm < (1 << 24))      # float32(d) exact
    return (np.concatenate([d[pick], dm[ok].astype(np.int32)]),
            np.concatenate([r[pick], rm[ok].astype(np.int32)]))


@pytest.mark.parametrize("ac", ACS)
def test_fused_rd_cost_equals_xla_at_near_ties(ac):
    d, r = near_ties(np.random.default_rng(ac), 4096, ac)
    f = jax.jit(lambda d, r, ac: d.astype(jnp.float32) + jnp.maximum(
        4, (ac * ac) >> 8).astype(jnp.float32) * r)
    want = np.asarray(f(d, r, jnp.int32(ac)))
    got = RDO.fma_f32(lam_of(ac), torch.from_numpy(r).float(),
                      torch.from_numpy(d).float()).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_fused_rd_cost_with_fractional_bits_equals_xla():
    """The keyframe's J: bits carry the fractional mode rate, and a large
    SSE puts the exact sum beyond float64 (the round-to-odd path)."""
    rng = np.random.default_rng(1)
    n = 1 << 16
    bits = (rng.integers(0, 1 << 16, n).astype(np.float32)
            + np.float32(JIE.MODE_BITS_I))
    bits[: n // 2] = (rng.random(n // 2) * 2.0 ** -20).astype(np.float32)
    sse = rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32)
    f = jax.jit(lambda s, b, ac: s.astype(jnp.float32) + jnp.maximum(
        4, (ac * ac) >> 8).astype(jnp.float32) * b)
    for ac in ACS:
        want = np.asarray(f(sse, bits, jnp.int32(ac)))
        got = TIE._rd_cost(torch.from_numpy(sse), torch.from_numpy(bits),
                           lam_of(ac)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), ac


def test_scalar_rate_product_rounds_before_the_add():
    rng = np.random.default_rng(2)
    j = (rng.random(1 << 16) * 2 ** 24).astype(np.float32)
    consts = [_PART_BITS[bs][k] for bs in (8, 16, 32, 64) for k in (0, 1)]
    consts.append(JIE.PART_SPLIT_I + 4 * JIE.PART_NONE_I)
    for c in consts:
        f = jax.jit(lambda j, ac, c=c: j + jnp.maximum(
            4, (ac * ac) >> 8).astype(jnp.float32) * c)
        for ac in ACS:
            want = np.asarray(f(j, jnp.int32(ac)))
            got = (torch.from_numpy(j)
                   + RDO.scalar_product_f32(lam_of(ac), c)).numpy()
            assert np.array_equal(got, want), (c, ac)


def merge_reference(d, r, ins, ac):
    """svt_av1_tpu's RD merge expressions (pipeline/inter_encoder.py
    :734-736 lam_rd, :785 J, :891-937 the merge without rect leaves) on
    per-size SSE d and bits r."""
    lam_rd = jnp.maximum(4, (ac * ac) >> 8).astype(jnp.float32)
    jc = {bs: d[bs].astype(jnp.float32) + lam_rd * r[bs] for bs in d}
    inf = jnp.float32(3e38)
    j_at = jc[8] + lam_rd * _PART_BITS[8][0]
    out = {"j8": j_at}
    for bs in (16, 32, 64):
        j_split = _sum4(j_at) + lam_rd * _PART_BITS[bs][1]
        j_bs = jnp.where(ins[bs], jc[bs] + lam_rd * _PART_BITS[bs][0], inf)
        use = j_bs <= j_split
        j_at = jnp.where(use, j_bs, j_split)
        out.update({f"j_split{bs}": j_split, f"j{bs}": j_bs,
                    f"j_at{bs}": j_at, f"use{bs}": use})
    out["use64"] = out["use64"] & ins[64]
    return out


# 8x8-cell map shapes of 192x128, 256x128 (power-of-two widths), 64x64,
# 854x480 and 1920x1080 frames
MERGE_SHAPES = [(16, 24), (16, 32), (8, 8), (64, 112), (136, 240)]


@pytest.mark.parametrize("hh,ww", MERGE_SHAPES,
                         ids=[f"{h}x{w}" for h, w in MERGE_SHAPES])
def test_rd_merge_maps_equal_reference(hh, ww):
    """Random per-size SSE and bits large enough that every sum rounds;
    the J maps and the decisions must match bit for bit."""
    rng = np.random.default_rng(hh * ww)
    shp = {bs: (hh * 8 // bs, ww * 8 // bs) for bs in (8, 16, 32, 64)}
    d = {bs: rng.integers(0, 1 << 27, shp[bs]).astype(np.int32) for bs in shp}
    r = {bs: rng.integers(0, 1 << 14, shp[bs]).astype(np.int32) for bs in shp}
    ins = {bs: rng.random(shp[bs]) < 0.9 for bs in (16, 32, 64)}
    for ac in ACS:
        want = jax.jit(merge_reference)(d, r, ins, jnp.int32(ac))
        lam = lam_of(ac)
        jc = {bs: RDO.fma_f32(lam, torch.from_numpy(r[bs]).float(),
                              torch.from_numpy(d[bs]).float()) for bs in shp}
        use16, use32, use64, maps = TPE.rd_merge(
            jc, lam, {bs: torch.from_numpy(m) for bs, m in ins.items()})
        maps.update(use16=use16, use32=use32, use64=use64)
        for k, v in want.items():
            assert np.array_equal(maps[k].numpy(), np.asarray(v)), (k, ac)


def test_rd_merge_sides_with_the_reference_on_one_ulp_ties():
    """Whole-node J one ulp either side of the split J and exactly on it
    (the comparison is <=, so a tie keeps the whole block)."""
    rng = np.random.default_rng(3)
    shp = {8: (16, 24), 16: (8, 12), 32: (4, 6), 64: (2, 3)}
    ac = 700
    lam = lam_of(ac)
    d = {bs: rng.integers(1 << 20, 1 << 26, shp[bs]).astype(np.int32)
         for bs in shp}
    r = {bs: rng.integers(0, 1 << 10, shp[bs]).astype(np.int32)
         for bs in shp}
    ins = {bs: np.ones(shp[bs], bool) for bs in (16, 32, 64)}
    base = jax.jit(merge_reference)(d, r, ins, jnp.int32(ac))
    # aim the 16 level's whole-block J at the split J: jc16 = split - none
    split = np.asarray(base["j_split16"]).astype(np.float64)
    none16 = float(np.float32(np.float32(lam) * np.float32(_PART_BITS[16][0])))
    target = np.floor(split - none16)
    r[16][:] = 0
    d[16] = (target + rng.integers(-1, 2, shp[16])).astype(np.int32)
    want = jax.jit(merge_reference)(d, r, ins, jnp.int32(ac))
    jc = {bs: RDO.fma_f32(lam, torch.from_numpy(r[bs]).float(),
                          torch.from_numpy(d[bs]).float()) for bs in shp}
    use16, _, _, maps = TPE.rd_merge(
        jc, lam, {bs: torch.from_numpy(m) for bs, m in ins.items()})
    assert np.array_equal(use16.numpy(), np.asarray(want["use16"]))
    assert 0 < int(use16.sum()) < use16.numel()
    for k in ("j16", "j_split16", "j_at16"):
        assert np.array_equal(maps[k].numpy(), np.asarray(want[k])), k


def test_coeff_bits_equal_reference():
    """float32 ceil(log2(|l| + 1)) of the reference == the port's bit
    length, for every level magnitude below 2^16."""
    lv = np.arange(-(1 << 16) + 1, 1 << 16, dtype=np.int32)[:, None, None]
    want = np.asarray(jax.jit(_coeff_bits)(jnp.asarray(lv)))
    got = TPE._coeff_bits(torch.from_numpy(lv)).numpy()
    assert np.array_equal(got, want)
    blocks = np.random.default_rng(4).integers(-300, 301, (64, 8, 8))
    blocks[blocks.__abs__() < 250] = 0
    assert np.array_equal(
        TPE._coeff_bits(torch.from_numpy(blocks.astype(np.int32))).numpy(),
        np.asarray(jax.jit(_coeff_bits)(jnp.asarray(blocks, jnp.int32))))
