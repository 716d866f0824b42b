#!/usr/bin/env python3
"""Find how XLA:CPU evaluates the float32 RD-cost expressions of the RD
presets and hold the port's emulation (svt_av1_tpu_torch.pipeline.rdo)
against them.

    JAX_PLATFORMS=cpu python3 tools/probe_xla_rd_order.py

The RD presets decide on J = float32(SSE) + lambda * bits
(svt_av1_tpu/pipeline/inter_encoder.py ``jcost`` and the merge,
intra_encoder.py ``frame_step16``).  A one-ulp difference flips a
near-tie and the packets differ, so the port must follow XLA's
evaluation, which belongs to XLA's CPU compiler and may change with the
CPU or the jax version.  Run this after such a change:

  1. ``d.astype(f32) + lam * r`` (lam a float32 scalar from the int32
     ac table, r an int32 or float32 array): contracted into one fused
     multiply-add, or two roundings?  Held against rdo.fma_f32.
  2. ``j + lam * c`` with c a Python float (weak-typed to float32): the
     scalar product rounded on its own, then the add?  Held against
     rdo.scalar_product_f32.
  3. the J maps of the RD merge (a replica of its expressions, from
     random per-size SSE and bits) at the step's map shapes, with the
     order of each level's 2x2 float32 sum: held against
     inter_encoder.rd_merge (rdo.sum4_f32).
  4. ``_coeff_bits``'s float32 ceil(log2(|l| + 1)) against the exact
     bit length for every |l| < 2^16 (the port takes the bit length);
  5. the merge of presets <= 5 (a replica with the rect hypotheses: the
     halves' J summed into node maps, HORZ / VERT beside NONE and SPLIT
     at the 16 and 32 nodes, the choices by equality) held against
     rd_merge with rect_j, with the 2x2 sum order of each level.

Each line prints the mismatch counts; exits 1 if the port's helper
differs from XLA anywhere.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def rd_merge_replica(d, r, ins, ac):
    """The reference's RD merge expressions (svt_av1_tpu/pipeline/
    inter_encoder.py:734-736, :785, :891-937, square leaves) on per-size
    SSE d and bits r: {name: float32 map}."""
    import jax.numpy as jnp

    from svt_av1_tpu.pipeline.inter_encoder import _PART_BITS, _sum4

    lam_rd = jnp.maximum(4, (ac * ac) >> 8).astype(jnp.float32)
    jc = {bs: d[bs].astype(jnp.float32) + lam_rd * r[bs] for bs in d}
    inf = jnp.float32(3e38)
    j_at = jc[8] + lam_rd * _PART_BITS[8][0]
    out = {"j8": j_at}
    for bs in (16, 32, 64):
        j_split = _sum4(j_at) + lam_rd * _PART_BITS[bs][1]
        j_bs = jnp.where(ins[bs], jc[bs] + lam_rd * _PART_BITS[bs][0], inf)
        j_at = jnp.where(j_bs <= j_split, j_bs, j_split)
        out.update({f"j_split{bs}": j_split, f"j{bs}": j_bs,
                    f"j_at{bs}": j_at})
    return out


def rd_merge_rect_replica(d, r, dr, rr, ins, ac):
    """The reference's RD merge with rect leaves (svt_av1_tpu/pipeline/
    inter_encoder.py:785, :878-880, :891-937) on per-size SSE d and bits
    r and per rect kind the halves' SSE dr and bits rr: {name: map}."""
    import jax.numpy as jnp

    from svt_av1_tpu.pipeline.inter_encoder import _PART_BITS, _sum4

    lam_rd = jnp.maximum(4, (ac * ac) >> 8).astype(jnp.float32)
    jc = {bs: d[bs].astype(jnp.float32) + lam_rd * r[bs] for bs in d}
    jr = {k: dr[k].astype(jnp.float32) + lam_rd * rr[k] for k in dr}
    node = {k: (jr[k][0::2] + jr[k][1::2]) if k in (4, 6)
            else (jr[k][:, 0::2] + jr[k][:, 1::2]) for k in jr}
    inf = jnp.float32(3e38)
    j_at = jc[8] + lam_rd * _PART_BITS[8][0]
    out = {"j8": j_at}
    for bs, (kh, kv) in ((16, (4, 5)), (32, (6, 7))):
        j_split = _sum4(j_at) + lam_rd * _PART_BITS[bs][1]
        j_bs = jnp.where(ins[bs], jc[bs] + lam_rd * _PART_BITS[bs][0], inf)
        jh = jnp.where(ins[bs], node[kh] + lam_rd * _PART_BITS[bs][2], inf)
        jv = jnp.where(ins[bs], node[kv] + lam_rd * _PART_BITS[bs][3], inf)
        j_at = jnp.minimum(jnp.minimum(j_bs, j_split), jnp.minimum(jh, jv))
        choice = jnp.where(j_at == j_bs, 0, jnp.where(
            j_at == jh, 1, jnp.where(j_at == jv, 2, 3))).astype(jnp.uint8)
        out.update({f"j_split{bs}": j_split, f"j{bs}": j_bs,
                    f"j_at{bs}": j_at, f"choice{bs}": choice})
    j_split = _sum4(j_at) + lam_rd * _PART_BITS[64][1]
    j64 = jnp.where(ins[64], jc[64] + lam_rd * _PART_BITS[64][0], inf)
    out.update({"j_split64": j_split, "j64": j64, "use64": j64 <= j_split})
    return out


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from svt_av1_tpu.pipeline import intra_encoder as JIE
    from svt_av1_tpu.pipeline import rdo as JRDO
    from svt_av1_tpu.pipeline.inter_encoder import _PART_BITS as JPB
    from svt_av1_tpu.pipeline.inter_encoder import _coeff_bits
    from svt_av1_tpu_torch.pipeline import rdo as RDO
    from svt_av1_tpu_torch.pipeline.inter_encoder import \
        _coeff_bits as t_coeff_bits
    from svt_av1_tpu_torch.pipeline.inter_encoder import rd_merge

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    bad = 0
    acs = (4, 40, 200, 700, 1828)    # ac_q range of 8-bit qindex 0..255

    # 1. fused multiply-add of an array product into an add
    n = 1 << 18
    d = rng.integers(0, 1 << 30, n).astype(np.int32)
    r = rng.integers(0, 1 << 20, n).astype(np.int32)
    f = jax.jit(lambda d, r, ac: d.astype(jnp.float32) + jnp.maximum(
        4, (ac * ac) >> 8).astype(jnp.float32) * r)
    for ac in acs:
        lam = float(max(4, (ac * ac) >> 8))
        got = np.asarray(f(d, r, jnp.int32(ac)))
        two = d.astype(np.float32) + np.float32(lam) * r.astype(np.float32)
        port = RDO.fma_f32(lam, torch.from_numpy(r).float(),
                           torch.from_numpy(d).float()).numpy()
        n_two, n_port = int((got != two).sum()), int((got != port).sum())
        bad += n_port
        print(f"J = d + lam*r, ac {ac}: differs from two roundings at "
              f"{n_two}, from rdo.fma_f32 at {n_port} of {n}")
    # the intra form: float32 bits with a fraction (+ MODE_BITS_I)
    bits = (rng.integers(0, 1 << 16, n).astype(np.float32)
            + np.float32(JIE.MODE_BITS_I))
    sse = rng.integers(0, 1 << 26, n).astype(np.int32)
    f = jax.jit(lambda s, b, ac: s.astype(jnp.float32) + jnp.maximum(
        4, (ac * ac) >> 8).astype(jnp.float32) * b)
    for ac in acs:
        lam = float(max(4, (ac * ac) >> 8))
        got = np.asarray(f(sse, bits, jnp.int32(ac)))
        port = RDO.fma_f32(lam, torch.from_numpy(bits),
                           torch.from_numpy(sse).float()).numpy()
        n_port = int((got != port).sum())
        bad += n_port
        print(f"J = sse + lam*bits (fractional bits), ac {ac}: differs "
              f"from rdo.fma_f32 at {n_port} of {n}")

    # 2. scalar product of lambda and a rate constant, then the add
    consts = [JRDO.partition_bits()[bs][k] for bs in (8, 16, 32, 64)
              for k in (0, 1)]
    consts.append(JIE.PART_SPLIT_I + 4 * JIE.PART_NONE_I)
    j = (rng.random(n) * 2 ** 24).astype(np.float32)
    for c in consts:
        f = jax.jit(lambda j, ac, c=c: j + jnp.maximum(
            4, (ac * ac) >> 8).astype(jnp.float32) * c)
        for ac in acs:
            lam = float(max(4, (ac * ac) >> 8))
            got = np.asarray(f(j, jnp.int32(ac)))
            fused = (j.astype(np.float64) + lam * float(np.float32(c))
                     ).astype(np.float32)
            port = (torch.from_numpy(j)
                    + RDO.scalar_product_f32(lam, c)).numpy()
            n_fused, n_port = int((got != fused).sum()), \
                int((got != port).sum())
            bad += n_port
            if n_port or ac == acs[-1]:
                print(f"j + lam*{c:.6f}, ac {ac}: differs from one fused "
                      f"rounding at {n_fused}, from the port at {n_port}")

    # 3. the merge's J maps: a replica of the reference's RD merge
    # (inter_encoder.py:891-937) from random per-size d, r at the step's
    # map shapes (192x128, 256x128, 64x64, 854x480, 1080p), held
    # against rd_merge; the 2x2 sum order per level is printed
    merge = jax.jit(rd_merge_replica)
    for hh, ww in ((16, 24), (16, 32), (8, 8), (64, 112), (136, 240)):
        shp = {bs: (hh * 8 // bs, ww * 8 // bs) for bs in (8, 16, 32, 64)}
        d = {bs: rng.integers(0, 1 << 27, shp[bs]).astype(np.int32)
             for bs in shp}
        r = {bs: rng.integers(0, 1 << 14, shp[bs]).astype(np.int32)
             for bs in shp}
        ins = {bs: rng.random(shp[bs]) < 0.9 for bs in (16, 32, 64)}
        ac = 1828
        got = merge(d, r, ins, jnp.int32(ac))
        got = {k: np.asarray(v) for k, v in got.items()}
        lam = float(max(4, (ac * ac) >> 8))
        jc = {bs: RDO.fma_f32(lam, torch.from_numpy(r[bs]).float(),
                              torch.from_numpy(d[bs]).float())
              for bs in shp}
        *_, port = rd_merge(jc, lam, {bs: torch.from_numpy(m)
                                      for bs, m in ins.items()})
        orders = []
        for bs, src in ((16, "j8"), (32, "j_at16"), (64, "j_at32")):
            x = got[src]
            a, b = x[0::2, 0::2], x[0::2, 1::2]
            c, e = x[1::2, 0::2], x[1::2, 1::2]
            s = np.float32(np.float32(lam)
                           * np.float32(JPB[bs][1]))
            seq = (((a + b) + c) + e) + s
            pair = ((a + b) + (c + e)) + s
            y = got[f"j_split{bs}"]
            orders.append(f"{bs}: w{a.shape[1]} "
                          f"{'seq' if (y == seq).all() else ''}"
                          f"{'pair' if (y == pair).all() else ''}")
        n_port = sum(int((got[k] != port[k].numpy()).sum()) for k in got)
        bad += n_port
        print(f"RD merge [{hh}x{ww} cells]: 2x2 order by level "
              f"{'; '.join(orders)}; maps differ from rd_merge at {n_port}")

    # 4. coefficient bits: float32 ceil(log2(|l| + 1)) vs the bit length
    lv = np.arange(-(1 << 16) + 1, 1 << 16, dtype=np.int32)[:, None, None]
    got = np.asarray(jax.jit(_coeff_bits)(jnp.asarray(lv)))
    port = t_coeff_bits(torch.from_numpy(lv)).numpy()
    n_port = int((got != port).sum())
    bad += n_port
    print(f"_coeff_bits, |l| < 2^16: differs from the port's bit length "
          f"at {n_port} of {lv.shape[0]}")
    # 5. the merge with rect leaves (presets <= 5)
    from svt_av1_tpu_torch.pipeline.inter_encoder import RECT_KINDS
    merge = jax.jit(rd_merge_rect_replica)
    for hh, ww in ((16, 24), (16, 32), (8, 8), (64, 112), (136, 240)):
        shp = {bs: (hh * 8 // bs, ww * 8 // bs) for bs in (8, 16, 32, 64)}
        rshp = {k: ((hh * 16 // ns, ww * 8 // ns) if s_ == "h" else
                    (hh * 8 // ns, ww * 16 // ns))
                for k, (ns, s_) in RECT_KINDS.items()}
        d = {bs: rng.integers(0, 1 << 27, shp[bs]).astype(np.int32)
             for bs in shp}
        r = {bs: rng.integers(0, 1 << 14, shp[bs]).astype(np.int32)
             for bs in shp}
        # the halves of a node cost about half its whole block, so the
        # rect choices compete with NONE and SPLIT
        dr = {k: rng.integers(0, 1 << 26, rshp[k]).astype(np.int32)
              for k in rshp}
        rr = {k: rng.integers(0, 1 << 13, rshp[k]).astype(np.int32)
              for k in rshp}
        ins = {bs: rng.random(shp[bs]) < 0.9 for bs in (16, 32, 64)}
        ac = 1828
        got = merge(d, r, dr, rr, ins, jnp.int32(ac))
        got = {k: np.asarray(v) for k, v in got.items()}
        lam = float(max(4, (ac * ac) >> 8))
        t = lambda a: torch.from_numpy(a)[None]
        jc = {bs: RDO.fma_f32(lam, t(r[bs]).float(), t(d[bs]).float())
              for bs in shp}
        jr = {k: RDO.fma_f32(lam, t(rr[k]).float(), t(dr[k]).float())
              for k in rshp}
        node = {k: (jr[k][:, 0::2] + jr[k][:, 1::2]) if k in (4, 6)
                else (jr[k][:, :, 0::2] + jr[k][:, :, 1::2]) for k in jr}
        _, _, use64, port = rd_merge(
            jc, lam, {bs: torch.from_numpy(m) for bs, m in ins.items()},
            node)
        port["use64"] = use64
        orders = []
        for bs, src in ((32, "j_at16"), (64, "j_at32")):
            x = got[src]
            a, b = x[0::2, 0::2], x[0::2, 1::2]
            c, e = x[1::2, 0::2], x[1::2, 1::2]
            s_ = np.float32(np.float32(lam) * np.float32(JPB[bs][1]))
            y = got[f"j_split{bs}"]
            seq = (y == (((a + b) + c) + e) + s_).all()
            pair = (y == ((a + b) + (c + e)) + s_).all()
            orders.append(f"{bs}: w{a.shape[1]} {'seq' if seq else ''}"
                          f"{'pair' if pair else ''}")
        n_port = sum(int((got[k] != port[k][0].numpy()).sum())
                     for k in got)
        picks = np.bincount(got["choice16"].ravel(), minlength=4)
        bad += n_port
        print(f"RD merge with rect [{hh}x{ww} cells]: 2x2 order by level "
              f"{'; '.join(orders)}; choice16 counts {picks.tolist()}; "
              f"maps differ from rd_merge at {n_port}")
    print("OK" if bad == 0 else f"MISMATCH ({bad})")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
