#!/usr/bin/env python3
"""Find the summation order of XLA:CPU's f32 dot and hold the port's
forward transform against the JAX one.

    JAX_PLATFORMS=cpu python3 tools/probe_xla_dot_order.py

svt_av1_tpu_torch.ops.transforms.fwd_txfm2d_batch emulates the order in
which XLA:CPU sums the two dots of svt_av1_tpu's f32 forward transform
(XLA_DOT_LANES).  That order belongs to XLA's CPU kernels on the CPU at
hand, so run this after a change of CPU or of jax:

  1. the sum tree of one dot [M, K] x [N, K]^T for each K of the inter
     path, read off with exact inputs: every term 1, except +2^40 and
     -2^40 at positions p and q, so an output equals K less the size of
     the smallest subtree that holds both.  Printed as the lane count L
     whose lane model gives exactly that tree (term k in lane k mod L,
     each lane a chain in ascending k, lanes joined pairwise);
  2. mismatching outputs of the port's emulation (``_xla_dot_nt``)
     against XLA's dot on random operands at several M;
  3. mismatching coefficients of TT.fwd_txfm2d_batch against
     JT.fwd_txfm2d_batch for all 19 tx sizes at several batch sizes, the
     square ones also at their block count in a 1280x720 frame.

Exits 1 if a tree leaves the lane model or any output differs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KS = (4, 8, 16, 32, 64)


def lane_model(k: int, lanes: int) -> np.ndarray:
    """Subtree sizes of the lane model: lanes of ascending chains,
    joined pairwise ((l0 + l1) + (l2 + l3))."""
    lane = np.arange(k) % lanes
    pos = np.arange(k) // lanes
    d = np.zeros((k, k), np.int64)
    for p in range(k):
        for q in range(k):
            if p == q:
                continue
            if lane[p] == lane[q]:
                d[p, q] = max(pos[p], pos[q]) + 1
            else:
                span = 1        # lanes joined in aligned pairs, then quads
                while lane[p] // span != lane[q] // span:
                    span *= 2
                d[p, q] = span * (k // lanes)
    return d


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from jax import lax
    from svt_av1_tpu.ops import transforms as JT
    from svt_av1_tpu_torch.ops import transforms as TT

    dot = jax.jit(lambda a, b: lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    ok = True
    print("1. sum trees (M = 256, N = K)")
    for k in KS:
        m = 256
        ones = jnp.ones((k, k), jnp.float32)
        d = np.zeros((k, k), np.int64)
        for p in range(k):
            for q in range(p + 1, k):
                a = np.ones((m, k), np.float32)
                a[:, p], a[:, q] = 2.0 ** 40, -(2.0 ** 40)
                got = k - np.asarray(dot(jnp.asarray(a), ones)).astype(
                    np.int64)
                if (got != got[0, 0]).any():
                    print(f"   K={k}: the tree differs between outputs")
                    ok = False
                d[p, q] = d[q, p] = got[0, 0]
        lanes = next((n for n in (1, 2, 4, 8, 16, 32, 64) if k % n == 0
                      and np.array_equal(d, lane_model(k, n))), None)
        ok &= lanes == TT.XLA_DOT_LANES[k]
        print(f"   K={k:2d}: lane model with "
              f"{'no lane count' if lanes is None else f'{lanes} lanes'}"
              f" fits; XLA_DOT_LANES says {TT.XLA_DOT_LANES[k]}")

    print("2. emulation vs XLA's dot, random operands")
    rng = np.random.default_rng(0)
    for k in KS:
        for m in (64, 1000, 8192):
            a = (rng.integers(-255, 256, (m, k))
                 * rng.standard_normal((m, k))).astype(np.float32)
            b = (rng.standard_normal((k, k)) * 0.3).astype(np.float32)
            want = np.asarray(dot(jnp.asarray(a), jnp.asarray(b)))
            got = TT._xla_dot_nt(torch.from_numpy(a)[None],
                                 torch.from_numpy(b))[0].numpy()
            bad = int((want != got).sum())
            ok &= bad == 0
            print(f"   K={k:2d} M={m:5d}: {bad} of {want.size} differ")

    print("3. fwd_txfm2d_batch, port vs JAX, DCT_DCT (square sizes also "
          "at their 720p block count)")
    at_720p = {4: 15360, 8: 15360, 16: 3840, 32: 960, 64: 240}
    for tx in range(JT.TX_SIZES_ALL):
        h, w = JT.TX_H[tx], JT.TX_W[tx]
        line = []
        for n in (1, 7, 128, 500) + ((at_720p[h],) if h == w else ()):
            r = rng.integers(-255, 256, (n, h, w)).astype(np.int32)
            want = np.asarray(JT.fwd_txfm2d_batch(jnp.asarray(r), tx,
                                                  JT.DCT_DCT))
            got = TT.fwd_txfm2d_batch(torch.from_numpy(r), tx,
                                      JT.DCT_DCT).numpy()
            bad = int((want != got).sum())
            ok &= bad == 0
            line.append(f"n={n}: {bad}/{want.size}")
        print(f"   {h}x{w}: " + ", ".join(line))
    print("all equal" if ok else "DIFFERENCES FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
