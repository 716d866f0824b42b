"""CDF-derived rate constants for the batched RD merges.

The reference estimates per-symbol rates from the live CDF state at
frame init (av1_estimate_syntax_rate,
Source/Lib/Common/Codec/EbMdRateEstimation.c:76) and
feeds them to the RD cost model (EbRateDistortionCost.c).  The TPU
build's dense merges decide with SCALAR per-leaf overheads (one value
per block size, not per context) so that decisions stay bulk-batched —
this module derives those scalars from the same place the reference
does: the normative default CDF tables that seed every FrameContext
(entropy/cdf_model.py), replacing the hand-tuned constants flagged in
round 1.

All mode/partition default CDFs are q-independent, so the constants are
computed once at import and treated as build-time Python floats (they
bake into the jitted steps as literals — zero device cost).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from svt_av1_tpu_torch.entropy.cdf_model import FrameContext

# partition symbols (entropy/syntax.py)
_P_NONE, _P_HORZ, _P_VERT, _P_SPLIT = 0, 1, 2, 3
# bsl per square size: 8x8 -> 0 ... 64x64 -> 3 (tile.py write_partition)
_BSL = {8: 0, 16: 1, 32: 2, 64: 3}


def sym_bits(icdf: np.ndarray, sym: int) -> float:
    """-log2 P(sym) from an inverse-CDF row (icdf[i] = 32768 - cum)."""
    hi = 32768 if sym == 0 else int(icdf[sym - 1])
    lo = int(icdf[sym])
    p = max(hi - lo, 1) / 32768.0
    return -math.log2(p)


def _avg_over_ctx(rows: np.ndarray, sym: int) -> float:
    """Mean symbol cost across a table's context rows (the batched
    merge carries one scalar per decision, not per neighbor ctx)."""
    rows = rows.reshape(-1, rows.shape[-1])
    return float(np.mean([sym_bits(r, sym) for r in rows]))


@functools.lru_cache(maxsize=1)
def _fc0() -> FrameContext:
    # mode/partition tables are q-independent; any base_q works
    return FrameContext(base_q_idx=100)


@functools.lru_cache(maxsize=1)
def partition_bits() -> dict:
    """{bs: (none_bits, split_bits, horz_bits, vert_bits)} from the
    default partition CDFs, averaged over the 4 above/left neighbor
    contexts of that size."""
    fc = _fc0()
    out = {}
    for bs, bsl in _BSL.items():
        rows = fc.partition[bsl * 4 : bsl * 4 + 4]
        out[bs] = (_avg_over_ctx(rows, _P_NONE),
                   _avg_over_ctx(rows, _P_SPLIT),
                   _avg_over_ctx(rows, _P_HORZ),
                   _avg_over_ctx(rows, _P_VERT))
    return out


@functools.lru_cache(maxsize=1)
def inter_leaf_bits() -> dict:
    """Per-leaf syntax-rate scalars (bits) for the inter merges.

    mode:       skip=0 + is_inter=1 + NEWMV bin (the dominant leaf in
                this encoder's P/B paths; MV bits ride separately via
                ME.mv_rate_bits)
    ref_single: one single_ref fwd/bwd bin (2-ref frames)
    comp_extra: compound leaf cost beyond a single-ref leaf:
                comp_inter=1 bin delta + comp ref pair bins +
                NEW_NEWMV compound-mode symbol - single NEWMV bin
    """
    fc = _fc0()
    skip0 = _avg_over_ctx(fc.skip, 0)
    is_inter = _avg_over_ctx(fc.intra_inter, 1)
    newmv = _avg_over_ctx(fc.newmv, 0)          # bin 0 -> NEWMV
    mode = skip0 + is_inter + newmv
    # single_ref bit0: fwd(0) vs bwd(1) — average both directions
    b0 = fc.single_ref[:, 0]
    ref_single = 0.5 * (_avg_over_ctx(b0, 0) + _avg_over_ctx(b0, 1))
    comp1 = _avg_over_ctx(fc.comp_inter, 1)
    comp0 = _avg_over_ctx(fc.comp_inter, 0)
    # UNIDIR vs BIDIR type + one fwd-ref bin + one bwd-ref bin
    pair = (_avg_over_ctx(fc.comp_ref_type, 1)
            + _avg_over_ctx(fc.comp_ref[:, 0], 0)
            + _avg_over_ctx(fc.comp_bwdref[:, 0], 0))
    # NEW_NEWMV symbol index in the inter_compound_mode cdf (mvp.py
    # order: NEAREST_NEAREST..NEW_NEW == last of 8)
    new_new = _avg_over_ctx(fc.inter_compound_mode, 7)
    comp_extra = (comp1 - comp0) + pair + new_new - newmv
    return {"mode": mode, "ref_single": ref_single,
            "comp_extra": max(comp_extra, 0.0)}


@functools.lru_cache(maxsize=1)
def intra_leaf_bits() -> float:
    """Keyframe leaf mode-rate scalar: skip=0 + average kf y mode +
    average uv mode (the wavefront batches all modes; the scalar is the
    expected mode cost under the default CDFs)."""
    fc = _fc0()
    skip0 = _avg_over_ctx(fc.skip, 0)
    # expected y-mode symbol cost under the default kf cdf (entropy of
    # the default distribution, averaged over the 25 neighbor contexts)
    rows = fc.kf_y_mode.reshape(-1, fc.kf_y_mode.shape[-1])
    ent = 0.0
    for r in rows:
        cum = np.concatenate(([32768], r[:-1]))
        p = np.maximum(cum[:-1] - cum[1:], 1) / 32768.0
        p = p[:13] / p[:13].sum()
        ent += float(-(p * np.log2(p)).sum())
    y_bits = ent / len(rows)
    rows = fc.uv_mode[0].reshape(-1, fc.uv_mode.shape[-1])
    ent = 0.0
    for r in rows:
        cum = np.concatenate(([32768], r[:-1]))
        p = np.maximum(cum[:-1] - cum[1:], 1) / 32768.0
        p = p[:13] / p[:13].sum()
        ent += float(-(p * np.log2(p)).sum())
    uv_bits = ent / len(rows)
    return skip0 + y_bits + uv_bits


# --- float32 arithmetic of the RD decisions ---------------------------------
# The RD presets decide on J = float32(SSE) + lambda * bits.  The reference
# package evaluates those expressions under XLA:CPU, which (measured with
# tools/probe_xla_rd_order.py on an x86-64 AVX-512 CPU, jax 0.9.0)
# contracts an array product feeding an add into one fused multiply-add,
# rounds a product of two scalars (lambda times a Python-float rate
# constant, weak-typed to float32) on its own before the add, and sums a
# 2x2 block of float32 in an order that its vectorizer picks per merge
# level and map width (sum4_f32).  The helpers below give those bits on
# the CPU and on the card alike: each is a fixed sequence of IEEE
# operations.

def f32_scalar(x) -> float:
    """A Python number rounded to float32 (JAX's weak typing of a Python
    float constant against float32 arrays)."""
    return float(np.float32(x))


def scalar_product_f32(a, b) -> float:
    """float32(a) * float32(b), rounded to float32: a product of two
    scalars, which XLA:CPU computes on its own before any add."""
    return float(np.float32(a) * np.float32(b))


def fma_f32(a: float, b, c):
    """float32 fused multiply-add ``a * b + c`` with one rounding (XLA:CPU
    contracts ``c + a * b`` when b is an array).

    a: a float32-valued Python float; b, c: float32 tensors.  The product
    is exact in float64 (24 x 24 bits); the float64 sum is made
    round-to-odd with its exact error (TwoSum), so the final rounding to
    float32 equals the single rounding of the exact a * b + c."""
    p = b.double() * a
    cd = c.double()
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sum4_f32(a, first_level: bool):
    """[2H, 2W] float32 -> [H, W] 2x2 block sums in XLA:CPU's order for
    the RD merge (the reference's ``_sum4``).  With a = top-left, b =
    top-right, c = bottom-left, d = bottom-right: ((a + b) + c) + d,
    except above the first merge level on a map whose width W is a power
    of two, where the vectorized sum is (a + b) + (c + d).  Leading
    (frame) dims pass through."""
    a_, b_ = a[..., 0::2, 0::2], a[..., 0::2, 1::2]
    c_, d_ = a[..., 1::2, 0::2], a[..., 1::2, 1::2]
    w = a_.shape[-1]
    if not first_level and w & (w - 1) == 0:
        return (a_ + b_) + (c_ + d_)
    return ((a_ + b_) + c_) + d_
