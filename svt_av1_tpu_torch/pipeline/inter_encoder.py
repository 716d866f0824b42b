"""P- and B-frame encoder in PyTorch: batched ME + MC + transform coding
with variable partitions.

Port of svt_av1_tpu/pipeline/inter_encoder.py at presets 0-8, at 8 or
10 bits: ``p_frame_step`` with one reference
(low-delay P and the hierarchical-B base layer, with or without the
global motion candidate), two (hierarchical-B interior frames: the
forward and the backward reference, optionally with the
COMPOUND_AVERAGE of the two; low-delay B: LAST and GOLDEN) or three
(multi-reference hierarchical-B interior frames: + ALTREF).  Inter
prediction has no intra-frame dependency, so a frame is one
bulk-parallel program over every block.  Preset 8 (rdo=False):

  hierarchical full-pel ME per reference (HME centers, center-warped
  +-3 lattice)
  -> fast SAD-domain partition merge (8/16/32/64) on the cheapest
     reference's cost
  -> one quarter-pel refinement per 8x8 cell and reference against the
     true reference, then the per-cell reference / compound choice
  -> MC at cell granularity -> residual coding at every leaf size
  -> per-cell selection -> deblocking + CDEF.  With lr=True the step also
returns the deblocked (pre-CDEF) planes, which the host's loop
restoration reads its stripe context rows from; with aq=True residual
quantization goes per superblock from a qindex map (adaptive
quantization 2; lambda, loop filters and CDEF stay at the frame q).

The RD presets 6-7 (rdo=True): a +-4 lattice, a dense quarter-pel
refinement per size, 64x64 candidates from the 32x32 winners, the
per-size reference argmin and compound candidate, MC and residual
coding of every leaf size, and a bottom-up merge on the float32 RD cost
J = SSE + lambda * bits (evaluated as the reference package's XLA:CPU
build evaluates it, pipeline/rdo.py) -> per-cell selection -> filters.
Presets 0-5 add to the RD path the inter tx-type search (txs: every leaf
of 8/16/32 coded with DCT and with IDTX, the cheaper kept) and
rectangular leaves (rect: PARTITION_HORZ / VERT at the 16 and 32 nodes,
each half predicted with the motion of its cheaper square child at 8x8
cell granularity and coded with the rect transform), which join the
merge beside NONE and SPLIT.

Every reference-patch read goes through ops.gather (the CUDA tile
gather on the card).  The reference package's one-hot integer matmuls
(tap selection, offset resolution) are indexing here.

The step carries a leading frame axis: given planes [S, H, W] it codes
S frames (the reference package's ``jax.vmap`` of the step over the
streams of pipeline/multistream.py) in the launches of one, every
search, argmin, merge and filter per frame; given [H, W] planes it is
the one-frame step (S = 1 inside).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu_torch import tables as _tbl
from svt_av1_tpu_torch.ops import cdef as CD
from svt_av1_tpu_torch.ops import deblock as DB
from svt_av1_tpu_torch.ops import gather as G
from svt_av1_tpu_torch.ops import mc as MC
from svt_av1_tpu_torch.ops import me as ME
from svt_av1_tpu_torch.ops import quant as Q
from svt_av1_tpu_torch.ops import transforms as T
from svt_av1_tpu_torch.pipeline import rdo as RDO

SEARCH_RANGE = 16   # full-pel luma search window (+-R)
SIZES = (8, 16, 32)     # ME sweep sizes (the SAD pyramid's native levels)
SIZES64 = (8, 16, 32, 64)   # leaf sizes incl. 64x64 (PARTITION_NONE at SB)
TX_OF = {8: T.TX_8X8, 16: T.TX_16X16, 32: T.TX_32X32, 64: T.TX_64X64}
TX_OF_C = {8: T.TX_4X4, 16: T.TX_8X8, 32: T.TX_16X16, 64: T.TX_32X32}
# CDF-derived per-decision rate scalars (pipeline/rdo.py)
_PART_BITS = RDO.partition_bits()   # {bs: (none, split, horz, vert) bits}
_LEAF = RDO.inter_leaf_bits()          # mode / ref_single / comp_extra


def inter_layout(nrefs: int, compound: bool, txs: bool, lv8: bool,
                 lr: bool, rect: bool = False) -> dict:
    """name -> output-tuple index for a p_frame_step build (the port
    builds lv8 False: the first nine names, then ``ref8`` for nrefs >=
    2, ``mv2`` for compound, ``txty`` for txs, ``shape8`` for rect and
    the deblocked planes for lr; the reference package's names and
    indices for the same flags)."""
    names = ["sizes", "mv", "ly", "lu", "lv", "rec_y", "rec_u", "rec_v",
             "cdef"]
    if nrefs >= 2:
        names.append("ref8")
    if compound:
        names.append("mv2")
    if txs:
        names.append("txty")
    if rect:
        names.append("shape8")
    if lv8:
        names += ["small", "ly8", "lu8", "lv8",
                  "lflags", "lcount", "ply", "plu", "plv"]
    if lr:
        names += ["deb_y", "deb_u", "deb_v"]
    return {n: i for i, n in enumerate(names)}


def _block(plane, bs: int):
    """[..., H, W] -> [..., H/bs, W/bs, bs, bs]."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // bs, bs, w // bs, bs).transpose(-3, -2)


def _block_rect(plane, bh: int, bw: int):
    """[..., H, W] -> [..., H/bh, W/bw, bh, bw]."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // bh, bh, w // bw, bw).transpose(-3, -2)


# rect leaf shapes searched by the RD merge (PARTITION_HORZ / VERT at the
# 16 and 32 nodes; ref ext partition shapes, EbSvtAv1Enc.h:194).  Kind
# codes of the per-cell leaf map: 0..3 square 8/16/32/64, then these.
RECT_KINDS = {4: (16, "h"), 5: (16, "v"), 6: (32, "h"), 7: (32, "v")}
KIND_SIZE = np.array([8, 16, 32, 64, 16, 16, 32, 32], np.int32)
KIND_SHAPE = np.array([0, 0, 0, 0, 1, 2, 1, 2], np.int32)  # 1 HORZ, 2 VERT
# rect luma / chroma tx per kind (HORZ at node 16 is 16 wide, 8 high)
RECT_TX = {4: T.TX_16X8, 5: T.TX_8X16, 6: T.TX_32X16, 7: T.TX_16X32}
RECT_TX_C = {4: T.TX_8X4, 5: T.TX_4X8, 6: T.TX_16X8, 7: T.TX_8X16}


def _rect_dims(kind: int):
    """(height, width) in luma pixels of a rect kind's leaf."""
    ns, shp = RECT_KINDS[kind]
    return (ns // 2, ns) if shp == "h" else (ns, ns // 2)


def _unblock(blocks):
    """[..., nbh, nbw, bh, bw] -> [..., nbh*bh, nbw*bw]."""
    *lead, nbh, nbw, bh, bw = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, nbh * bh, nbw * bw)


def _up(a, k: int, dim: int = 0):
    """Repeat dims (dim, dim + 1) k times each: a [h, w] map (dim 0), or
    a [S, h, w, ...] map or vector field of the batched step (dim 1)."""
    if k == 1:
        return a
    return a.repeat_interleave(k, dim).repeat_interleave(k, dim + 1)


def _up1(a, k: int):
    return _up(a, k, 1)


def _up1_hw(a, kh: int, kw: int):
    """Repeat dims (1, 2) of a [S, h, w, ...] map kh and kw times."""
    return a.repeat_interleave(kh, 1).repeat_interleave(kw, 2)


def _encode_plane(src_blocks, pred_blocks, qindex, tx_size: int,
                  bd: int = 8, tx_type: int = T.DCT_DCT):
    """[..., nbh, nbw, bh, bw] source + prediction -> (levels, recon)
    with the f32 forward transform and the exact inverse.  qindex: a
    Python int, or an [..., nbh, nbw] tensor of per-block qindex values
    (per-SB adaptive quantization)."""
    bh, bw = src_blocks.shape[-2:]
    if isinstance(qindex, torch.Tensor):
        qindex = qindex.reshape(-1)
    resid = (src_blocks - pred_blocks).reshape(-1, bh, bw)
    coeff = T.fwd_txfm2d_batch(resid, tx_size, tx_type, bd)
    levels = Q.quantize_batch(coeff, qindex, tx_size, bd)
    if T.TX_W[tx_size] > 32 or T.TX_H[tx_size] > 32:
        # spec Adjusted_Tx_Size: only the top-left 32x32 coefficients of a
        # dim-64 transform are coded — zero the rest so recon matches the
        # decoder (which parses a 32x32 region into a zero 64x64 array)
        keep = torch.zeros((T.TX_H[tx_size], T.TX_W[tx_size]),
                           dtype=torch.bool, device=levels.device)
        keep[:32, :32] = True
        levels = torch.where(keep, levels, 0)
    dq = Q.dequantize_batch(levels, qindex, tx_size, bd)
    rec = T.inv_txfm2d_batch(dq, tx_size, tx_type, bd)
    recon = torch.clamp(pred_blocks + rec.reshape(src_blocks.shape), 0,
                        (1 << bd) - 1)
    return levels.reshape(src_blocks.shape), recon


def _phase_grid(patch, bs: int, bd: int, kern):
    """Pixel-domain quarter-pel phase grid from a gathered patch.

    patch: [ext, ext, N] int32, ext = bs + 8, gathered at offset -4
    (filter halo + the -1 integer reach of negative deltas).  Returns
    P[py][px] planes, each [bs+1, bs+1, N] int16 clipped pixels:
    P[0][0] the full-pel copy, rows/cols 1..3 the 4/8/12 sixteenth-pel
    phases, with av1_convolve_{x,y,2d}_sr_c rounding case-for-case."""
    hi = (1 << bd) - 1

    def hconv(p, ker):                               # -> [:, bs+1, N]
        out = None
        for k, c in enumerate(ker):
            t = c * p[:, k: k + bs + 1, :]
            out = t if out is None else out + t
        return out

    def vconv(p, ker):                               # -> [bs+1, :, N]
        out = None
        for k, c in enumerate(ker):
            t = c * p[k: k + bs + 1, :, :]
            out = t if out is None else out + t
        return out

    rs = lambda x, n: (x + (1 << (n - 1))) >> n
    offset0 = 1 << (bd + 6)                          # 1 << (bd+FILTER_BITS-1)
    offset_bits = bd + 11                            # bd + 2*7 - 3
    sub = (1 << (bd - 1)) + (1 << (bd - 2))
    i16 = lambda x: x.to(torch.int16)
    P = [[None] * 4 for _ in range(4)]
    P[0][0] = i16(patch[3: 4 + bs, 3: 4 + bs, :])
    im = {}
    for pxi, px in enumerate((4, 8, 12)):
        # x-only (av1_convolve_x_sr_c rounding)
        P[0][pxi + 1] = i16(torch.clamp(
            rs(rs(hconv(patch[3: 4 + bs, :, :], kern[px]), 3), 4), 0, hi))
        im[px] = rs(hconv(patch, kern[px]) + offset0, 3)
    for pyi, py in enumerate((4, 8, 12)):
        # y-only (av1_convolve_y_sr_c rounding)
        P[pyi + 1][0] = i16(torch.clamp(
            rs(vconv(patch[:, 3: 4 + bs, :], kern[py]), 7), 0, hi))
        for pxi, px in enumerate((4, 8, 12)):
            # 2-D (av1_convolve_2d_sr_c rounding)
            P[pyi + 1][pxi + 1] = i16(torch.clamp(
                rs(vconv(im[px], kern[py]) + (1 << offset_bits), 11) - sub,
                0, hi))
    return P


def _filter_kern(filt: int):
    table = _tbl.spec_tables()[MC.FILTER_TABLES[filt]]
    return {p: tuple(int(v) for v in table[p]) for p in (4, 8, 12)}


def _subpel_refine_dense(src_blocks, ref_pad, mv_fp, bs: int, pad: int,
                         lam: int, prior8, bd: int = 8, filt: int = 0,
                         lat_reach: int = 6):
    """Dense quarter-pel refinement around full-pel MVs — ONE patch
    gather per block, then every candidate of the 7x7 lattice
    {-6..6 step 2}^2 (1/8-pel units) is a static slice of the on-patch
    phase grid.  Used by the RD presets (ref HalfPelSearch_LCU /
    QuarterPelSearch_LCU, EbMotionEstimation.c:3829/:4746)."""
    kern = _filter_kern(filt)
    grid = mv_fp.shape[:-1]                          # [..., nbh, nbw]
    patch = G.gather_blocks_grid(ref_pad, mv_fp[..., 0], mv_fp[..., 1],
                                 bs, pad, pad - 1, halo=8, off=-4)
    ext = bs + 8
    patch = patch.reshape(-1, ext, ext).permute(1, 2, 0).to(torch.int32)
    P = _phase_grid(patch, bs, bd, kern)             # [ext, ext, N] in
    src = src_blocks.reshape(-1, bs, bs).permute(1, 2, 0).to(torch.int16)
    dev = mv_fp.device
    best_cost = None
    best_mv = None
    for dy in range(-lat_reach, lat_reach + 1, 2):
        pyi = ((2 * dy) & 15) >> 2
        fy = dy >> 3
        for dx in range(-lat_reach, lat_reach + 1, 2):
            pxi = ((2 * dx) & 15) >> 2
            fx = dx >> 3
            pred = P[pyi][pxi][fy + 1: fy + 1 + bs, fx + 1: fx + 1 + bs, :]
            sad = (src - pred).abs().sum((0, 1), dtype=torch.int32
                                         ).reshape(grid)
            mv8c = mv_fp * 8 + torch.tensor([dy, dx], dtype=torch.int32,
                                            device=dev)
            cost = sad + ((lam * ME.mv_rate_bits(mv8c - prior8)) >> 4)
            if best_cost is None:
                best_cost, best_mv = cost, mv8c
            else:
                better = cost < best_cost
                best_cost = torch.where(better, cost, best_cost)
                best_mv = torch.where(better[..., None], mv8c, best_mv)
    return best_mv, best_cost


@functools.lru_cache(maxsize=None)
def _filter_table_on(filt: int, device: torch.device):
    table = _tbl.spec_tables()[MC.FILTER_TABLES[filt]]
    return torch.as_tensor(np.array(table, np.int32), device=device)


def _interp_patch(patch, ph_r, ph_c, bs: int, bd: int, filt: int = 0,
                  jnt: bool = False, both: bool = False):
    """Per-block subpel interpolation on gathered patches.

    patch: [..., N, bs+7, bs+7] full-pel windows (top-left at position
    - 3, the 8-tap halo); ph_r/ph_c: [..., nbh, nbw] phase16 indices.
    The regular output reproduces the reference's copy / x-only /
    y-only / 2-D rounding, selected per block; ``jnt`` returns instead
    the CONV_BUF-domain av1_jnt_convolve_2d output (one formula for
    every phase), and ``both`` returns (regular, CONV_BUF) from one
    shared convolution.  Each is [..., nbh, nbw, bs, bs] int32."""
    table = _filter_table_on(filt, patch.device)         # [16, 8]
    kx = table[ph_c.reshape(-1).long()]                  # [N, 8]
    ky = table[ph_r.reshape(-1).long()]
    p = patch.reshape(-1, bs + 7, bs + 7).permute(1, 2, 0).to(torch.int32)
    rs = lambda x, n: (x + (1 << (n - 1))) >> n
    hi = (1 << bd) - 1
    offset0 = 1 << (bd + 6)
    ob = bd + 11

    def hconv(src):
        out = None
        for k in range(8):
            t = src[:, k: k + bs, :] * kx[:, k]
            out = t if out is None else out + t
        return out                                       # [rows, bs, N]

    def vconv(src):
        out = None
        for k in range(8):
            t = src[k: k + bs] * ky[:, k]
            out = t if out is None else out + t
        return out                                       # [bs, cols, N]

    fin = lambda x: x.permute(2, 0, 1).reshape(*ph_r.shape, bs, bs)
    hc = hconv(p)                                        # [bs+7, bs, N]
    im = rs(hc + offset0, 3)
    twod_acc = vconv(im)
    jnt_out = None
    if jnt or both:
        jnt_out = fin(rs(twod_acc + (1 << ob), MC.JNT_ROUND1))
        if not both:
            return jnt_out
    sub = (1 << (bd - 1)) + (1 << (bd - 2))
    twod = torch.clamp(rs(twod_acc + (1 << ob), 11) - sub, 0, hi)
    x_only = torch.clamp(rs(rs(hc[3: 3 + bs], 3), 4), 0, hi)
    y_only = torch.clamp(rs(vconv(p[:, 3: 3 + bs, :]), 7), 0, hi)
    copy = p[3: 3 + bs, 3: 3 + bs, :]
    phx0 = ph_c.reshape(-1) == 0
    phy0 = ph_r.reshape(-1) == 0
    out = fin(torch.where(phx0 & phy0, copy,
                          torch.where(phy0, x_only,
                                      torch.where(phx0, y_only, twod))))
    return (out, jnt_out) if both else out


def _gather_mc_patch(plane_pad, mv8, bs: int, pad: int, chroma: bool):
    """One grid-anchored patch gather for subpel MC; returns
    (patch [N, bs+7, bs+7], ph_r, ph_c)."""
    if chroma:
        f_r, f_c = mv8[..., 0] >> 4, mv8[..., 1] >> 4
        ph_r, ph_c = mv8[..., 0] & 15, mv8[..., 1] & 15
    else:
        f_r, f_c = mv8[..., 0] >> 3, mv8[..., 1] >> 3
        ph_r, ph_c = (mv8[..., 0] * 2) & 15, (mv8[..., 1] * 2) & 15
    patch = G.gather_blocks_grid(plane_pad, f_r, f_c, bs, pad, pad,
                                 halo=7, off=-3)
    return patch, ph_r, ph_c


def _mc_patch(plane_pad, mv8, bs: int, pad: int, chroma: bool, bd: int,
              jnt: bool = False, filt: int = 0):
    """Subpel MC via one grid-anchored patch gather + on-patch interp."""
    patch, ph_r, ph_c = _gather_mc_patch(plane_pad, mv8, bs, pad, chroma)
    return _interp_patch(patch, ph_r, ph_c, bs, bd, filt, jnt=jnt)


# compound signaling beyond a single-ref leaf (comp_inter + ref pair +
# NEW_NEWMV symbol), from the default CDFs
COMP_EXTRA_BITS = round(_LEAF["comp_extra"])


def _coeff_bits(lv):
    """Per-block coefficient-rate estimate in bits from quantized levels
    (3 + 2*bit_length(|l|) bits per nonzero plus an eob/skip term; ref
    av1_estimate_syntax_rate, EbMdRateEstimation.c:76).  lv: [..., n, n]
    -> [...] int32 bits."""
    a = lv.abs().to(torch.int32)
    # ceil(log2(|l| + 1)) == bit_length(|l|): the binary exponent, exact
    # (the reference's float32 log2 gives the same for every |l| < 2^16,
    # tools/probe_xla_rd_order.py)
    nb = torch.frexp(a.to(torch.float32)).exponent.to(torch.int32)
    bits = torch.where(a > 0, 3 + 2 * nb, 0).sum((-1, -2),
                                                  dtype=torch.int32)
    nz = (a > 0).any(-1).any(-1)
    return bits + torch.where(nz, 4, 1)


def _sum4(a):
    """[..., 2H, 2W] -> [..., H, W] 2x2 block sum."""
    *lead, h, w = a.shape
    return a.reshape(*lead, h // 2, 2, w // 2, 2).sum((-3, -1),
                                                      dtype=a.dtype)


def _tiles8(x, t: int):
    """[..., gh, gw, bh, bw] block grid -> [..., gh*bh/t, gw*bw/t, t, t]
    tile grid."""
    *lead, gh, gw, bh, bw = x.shape
    kh, kw = bh // t, bw // t
    n = len(lead)
    return (x.reshape(*lead, gh, gw, kh, t, kw, t)
            .permute(*range(n), n, n + 2, n + 1, n + 4, n + 3, n + 5)
            .reshape(*lead, gh * kh, gw * kw, t, t))


def _inside_masks(ph: int, pw: int, mi_rows: int, mi_cols: int):
    """Static edge-legality masks for the 16/32/64 merge levels: a node
    may stay whole only when it lies inside the coded frame."""
    cells_h, cells_w = mi_rows // 2, mi_cols // 2   # 8x8 cells in frame
    out = {}
    for bs in (16, 32, 64):
        k = bs // 8
        r = np.arange(ph // bs)[:, None]
        c = np.arange(pw // bs)[None, :]
        out[bs] = (r * k + k <= cells_h) & (c * k + k <= cells_w)
    return out


def p_frame_step(ph: int, pw: int, mi_rows: int, mi_cols: int, *,
                 search: int = SEARCH_RANGE, nrefs: int = 1,
                 compound: bool = False, bd: int = 8, rdo: bool = False,
                 txs: bool = False, filt: int = 0, gm: bool = False,
                 lr: bool = False, rect: bool = False, filters: bool = True,
                 aq: bool = False, cdef: bool = True):
    """Build the P/B-frame encode step (a plain callable).

    Geometry: ph, pw are the 64-padded plane dims; mi_rows/mi_cols the
    frame's mode-info grid.  Every plane argument may carry a leading
    frame axis ([S, ph, pw], qmap [S, ...]): the step then codes S frames
    with a shared qindex and filter levels (and global translation), and
    each output gains the same leading axis.
    step(sy [ph,pw], su, sv [ph/2,pw/2], ref0_y, ref0_u, ref0_v
         [, ref1_y, ref1_u, ref1_v [, ref2_y, ref2_u, ref2_v]], qindex,
         lf_y, lf_u, lf_v[, gmv][, qmap])
    -> (sizes [nb8h,nb8w] u8 (8..64 leaf size covering each 8x8 cell),
        mv8 [nb8h,nb8w,2] i16 (selected cell MV in 1/8 pel),
        ly [nb8h,nb8w,8,8], lu, lv [nb8h,nb8w,4,4] i16 per-cell levels,
        recon_y [ph,pw], recon_u, recon_v (MC.pixel_dtype(bd)), cdef idx
        [sb rows, sb cols] u8[, ref8 [nb8h,nb8w] u8 (index of the cell's
        reference, nrefs = compound) when nrefs >= 2][, mv2 [nb8h,nb8w,2]
        i16 (the compound cells' ref1 MV) when compound][, txty
        [nb8h,nb8w] u8 (the cell's luma tx type: 0 DCT, 9 IDTX) when
        txs][, shape8 [nb8h,nb8w] u8 (0 square leaf, 1 HORZ, 2 VERT; a
        rect cell's size is its node's) when rect][, deb_y, deb_u,
        deb_v: the deblocked, pre-CDEF planes at the mode-info extent,
        when lr]) — inter_layout(nrefs, compound, txs, False, lr, rect)
        order.
    rdo=False is preset 8 (fast SAD merge, then one quarter-pel
    refinement per 8x8 cell); rdo=True the RD presets 6-7 (dense
    quarter-pel refinement per size, 64x64 candidates, residual coding
    of every leaf size and a float32 RD merge; with txs the DCT / IDTX
    search per leaf, with rect the HORZ / VERT leaves at the 16 and 32
    nodes — presets 0-5; both need rdo, as in the reference package,
    which ignores them without it).  With nrefs=3 the third
    reference (ALTREF) joins the per-size argmin; compound pairs
    (ref0, ref1).  qindex and the loop-filter levels are Python ints;
    gmv is the frame's (row, col) global translation in 1/8 pel (gm=True
    with one reference only, as in the reference package).  Sources and
    references are pixel tensors of any integer dtype (uint8 at 8 bits,
    int16 at 10).  qmap (aq=True): [ph/64, pw/64] absolute qindex per
    superblock, used by residual quantization only.
    """
    unported = {"nrefs>3": nrefs > 3,
                "compound with nrefs=1": compound and nrefs == 1,
                "filters=False": not filters}
    off = [k for k, v in unported.items() if v]
    if off:
        raise NotImplementedError(f"p_frame_step: {', '.join(off)} "
                                  "not ported")
    # the tx-type search and the rect leaves belong to the RD merge
    txs = txs and rdo
    rect = rect and rdo
    pad = search + 1
    cpad = pad // 2 + 1
    r2 = 4 if rdo else 3    # +-r2 full-pel lattice around the HME centers
    nb8h, nb8w = ph // 8, pw // 8
    ph_mi, pw_mi = mi_rows * 4, mi_cols * 4
    inside = _inside_masks(ph, pw, mi_rows, mi_cols)
    ac_table = _tbl.spec_tables()[f"ac_qlookup_{bd}"]
    kern_c = _filter_kern(filt)
    # per-leaf overheads (mode + partition symbols; two-reference frames
    # add the single_ref bin): lambda-scaled ints for the fast merge,
    # float32 products with lambda_rd for the RD merge
    mb = _LEAF["mode"] + (_LEAF["ref_single"] if nrefs >= 2 else 0)
    oh_bits = {bs: round(mb + _PART_BITS[bs][0]) for bs in SIZES64}
    sp_bits = {bs: round(_PART_BITS[bs][1]) for bs in (16, 32, 64)}
    mode_bits = round(mb)
    # merged-cell refinement lattice: 5x5 quarter-pel offsets (1/8 units)
    reach_q = 4
    cand = [(dy, dx) for dy in range(-reach_q, reach_q + 1, 2)
            for dx in range(-reach_q, reach_q + 1, 2)]

    def step(sy, su, sv, *rest):
        refs = rest[: 3 * nrefs]
        qindex, lf_y, lf_u, lf_v = rest[3 * nrefs: 3 * nrefs + 4]
        extra = rest[3 * nrefs + 4:]
        gmv = extra[0] if (gm and extra) else None
        qmap = extra[-1] if aq else None
        if sy.dim() == 3:
            return batched(sy, su, sv, refs, qindex, lf_y, lf_u, lf_v, gmv,
                           qmap)
        one = lambda a: None if a is None else torch.as_tensor(a)[None]
        out = batched(sy[None], su[None], sv[None],
                      tuple(r[None] for r in refs), qindex, lf_y, lf_u,
                      lf_v, gmv, one(qmap))
        return tuple(o[0] for o in out)

    def batched(sy, su, sv, refs, qindex, lf_y, lf_u, lf_v, gmv, qmap):
        """The step on [S, ...] planes: S frames, one shared q."""
        S = sy.shape[0]
        dev = sy.device
        q = int(qindex)
        ac = int(ac_table[q])
        lam = max(8, ac // 4)
        lf_levels = (int(lf_y), int(lf_y), int(lf_u), int(lf_v))
        ins = {bs: torch.as_tensor(m, device=dev) for bs, m in inside.items()}
        if qmap is not None:
            qmap = torch.as_tensor(qmap, device=dev).to(torch.int32)

        def qq(bh: int, bw: int = None):
            """The quantizer of residual coding at leaf size bh x bw
            (square when bw is None): the frame q, or with aq the per-SB
            map expanded to the blocks."""
            if qmap is None:
                return q
            return _up1_hw(qmap, 64 // bh, 64 // (bw or bh))
        sy = sy.to(torch.int32)
        su = su.to(torch.int32)
        sv = sv.to(torch.int32)
        padded = [(MC.pad_for_filter(refs[3 * i], pad),
                   MC.pad_for_filter(refs[3 * i + 1], cpad),
                   MC.pad_for_filter(refs[3 * i + 2], cpad))
                  for i in range(nrefs)]

        def me_one_ref(i, centers):
            """Hierarchical full-pel ME against reference i: a +-r2
            multi-size sweep on the center-warped reference and the
            rate-biased winners per size; then, at the RD presets, the
            dense quarter-pel refinement per size against the true
            reference, else the 64 level from 2x2 sums of the 32 level.
            Returns ({bs: mv 1/8 pel}, {bs: cost}, {bs: full-pel MVP
            prior})."""
            ry_i = refs[3 * i]
            ref_pad = MC.edge_pad(ry_i, search, search, search, search)
            warped = ME.warp_by_centers(ref_pad, centers, 32, search)
            lat = ME.sad_lattice_multisize(sy, warped, r2, bd)
            p1 = ME.select_from_lattice(lat, centers, 32, r2)
            priors = {bs: ME.median3_mv_field(p1[bs][0]) for bs in SIZES}
            p2 = ME.select_from_lattice(lat, centers, 32, r2, lam, priors)
            priors[64] = priors[32][:, ::2, ::2]
            if rdo:
                mv_i, cost_i = {}, {}
                for bs in SIZES:
                    # its d=0 candidate re-scores the warped-sweep winner
                    mv_i[bs], cost_i[bs] = _subpel_refine_dense(
                        _block(sy, bs), padded[i][0], p2[bs][0], bs, pad,
                        lam, priors[bs] * 8, bd, filt, lat_reach=6)
                return mv_i, cost_i, priors
            mv_i = {bs: p2[bs][0] * 8 for bs in SIZES}   # 1/8-pel units
            cost_i = {bs: p2[bs][1] for bs in SIZES}
            lat64 = _blocksum2(lat[32])
            cen64 = centers[:, ::2, ::2]
            dyx64 = ME._offset_table(r2, dev)
            c64 = lat64 + ((lam * ME.mv_rate_bits(
                (cen64[None] + dyx64[:, None, None, None, :]) * 8
                - priors[64][None] * 8)) >> 4)
            k64 = torch.argmin(c64, 0)
            mv_i[64] = (cen64 + dyx64[k64]) * 8
            cost_i[64] = c64.min(0).values
            return mv_i, cost_i, priors

        # quarter-res center search against ref0; at preset 8 the near
        # backward reference starts from the mirrored centers (the hier-B
        # references sit symmetrically around the source); every other
        # reference runs its own quarter-res search
        reach = search - r2
        centers0 = ME.hme_centers(sy, refs[0].to(torch.int32),
                                  search_reach=reach)
        per_ref = [me_one_ref(0, centers0)]
        for i in range(1, nrefs):
            cen = (torch.clamp(-centers0, -reach, reach)
                   if (not rdo and i == 1)
                   else ME.hme_centers(sy, refs[3 * i], search_reach=reach))
            per_ref.append(me_one_ref(i, cen))
        mv, cost = dict(per_ref[0][0]), dict(per_ref[0][1])

        if gm and nrefs == 1:
            # GLOBALMV candidate, charged mode bits but no MV bits
            g = (0, 0) if gmv is None else (int(gmv[0]), int(gmv[1]))
            mvg_one = torch.tensor(g, dtype=torch.int32, device=dev)
            if rdo:
                # subpel prediction at the global translation per size
                for bs in SIZES:
                    mvg = mvg_one.expand(S, ph // bs, pw // bs, 2)
                    predg = _mc_patch(padded[0][0], mvg, bs, pad, False, bd,
                                      filt=filt)
                    costg = ((_block(sy, bs) - predg).abs()
                             .sum((-1, -2), dtype=torch.int32)
                             + ((lam * 4) >> 4))
                    use_g = costg < cost[bs]
                    mv[bs] = torch.where(use_g[..., None], mvg_one, mv[bs])
                    cost[bs] = torch.minimum(costg, cost[bs])
            else:
                # the estimator emits FULL-pel global vectors, so one
                # copy-gather at the 8 level + 2x2 sums score every size
                full = lambda v: torch.full((S, nb8h, nb8w), v >> 3,
                                            dtype=torch.int32, device=dev)
                tiles = G.gather_blocks_grid(padded[0][0], full(g[0]),
                                             full(g[1]), 8, pad, pad - 1)
                sadg = {8: (_block(sy, 8)
                            - tiles.reshape(S, nb8h, nb8w, 8, 8)
                            .to(torch.int32)).abs().sum((-1, -2),
                                                        dtype=torch.int32)}
                for bs in (16, 32, 64):
                    sadg[bs] = _sum4(sadg[bs // 2])
                for bs in SIZES64:
                    costg = sadg[bs] + ((lam * 4) >> 4)
                    use_g = costg < cost[bs]
                    mv[bs] = torch.where(use_g[..., None], mvg_one, mv[bs])
                    cost[bs] = torch.minimum(costg, cost[bs])

        if rdo:
            kind8, rd = _rd_decide(sy, su, sv, padded, per_ref, mv, cost, qq,
                                   lam, ac, ins)
        else:
            # --- fast SAD-domain rate-biased partition merge on the
            # cheapest reference's cost at every size ------------------
            per_ref_mv = [mv] + [per_ref[i][0] for i in range(1, nrefs)]
            for i in range(1, nrefs):
                cost = {bs: torch.minimum(per_ref[i][1][bs], cost[bs])
                        for bs in SIZES64}
            oh = {bs: (lam * oh_bits[bs]) >> 4 for bs in SIZES64}
            sp = {bs: (lam * sp_bits[bs]) >> 4 for bs in (16, 32, 64)}
            j8 = cost[8] + oh[8]
            j_split16 = _sum4(j8) + sp[16]
            j16 = cost[16] + oh[16]
            use16 = (j16 <= j_split16) & ins[16]
            j_at16 = torch.where(use16, j16, j_split16)
            j_split32 = _sum4(j_at16) + sp[32]
            j32 = cost[32] + oh[32]
            use32 = (j32 <= j_split32) & ins[32]
            j_at32 = torch.where(use32, j32, j_split32)
            j_split64 = _sum4(j_at32) + sp[64]
            j64 = cost[64] + oh[64]
            use64 = (j64 <= j_split64) & ins[64]
            kind8 = _kind_map(torch.where(use16, 0, 3),
                              torch.where(use32, 0, 3), use64)

        # per-8x8-cell leaf kind: 0..3 square 8/16/32/64, 4..7 rect
        kind_size = torch.as_tensor(KIND_SIZE, device=dev)
        size8 = kind_size[kind8.long()].to(torch.uint8)
        rect_d = rd["rect"] if rdo else {}

        def kpick(per_kind, dtype):
            """Per-cell select over leaf kinds ({kind: cell array}; kinds
            absent from the map never win)."""
            out = per_kind[0]
            for k in sorted(per_kind):
                if k == 0 or per_kind[k] is None:
                    continue
                m = kind8 == k
                v = per_kind[k]
                if v.dim() > m.dim():
                    m = m.reshape(m.shape + (1,) * (v.dim() - m.dim()))
                out = torch.where(m, v, out)
            return out.to(dtype)

        sq_cells = lambda d: {0: d[8], 1: _up1(d[16], 2),
                              2: _up1(d[32], 4), 3: _up1(d[64], 8)}
        # a cell field per kind: the square leaves' maps and the rect
        # leaves' cell maps under name
        cells = lambda d, name: {**sq_cells(d), **{k: v[name] for k, v in
                                                   rect_d.items()}}
        ref8 = mv2_sel = txty8 = None
        if rdo:
            levels, rec_planes = rd["levels"], rd["rec"]
            mv_sel = kpick(cells(rd["mv"], "mv"), torch.int16)
            if nrefs >= 2:
                ref8 = kpick(cells(rd["sel"], "sel"), torch.uint8)
            if compound:
                mv2_sel = kpick(cells(rd["mv2"], "mv2"), torch.int16)
            if txs:
                # rect leaves code DCT only
                tt = sq_cells(rd["txty"])
                txty8 = kpick({**tt, **{k: torch.zeros_like(tt[0])
                                        for k in rect_d}}, torch.uint8)
        else:
            mv_sel, ref8, mv2_sel, levels, rec_planes = _fast_refine_code(
                sy, su, sv, padded, per_ref, per_ref_mv, kind8, kpick,
                sq_cells, qq, lam)

        # --- final recon: per-cell select of the chosen leaf's recon -----
        def select_plane(idx_plane, shift):
            km = _up1(kind8, 8 >> shift)
            out = rec_planes[8][idx_plane]
            for k, bs_ in ((1, 16), (2, 32), (3, 64)):
                out = torch.where(km == k, rec_planes[bs_][idx_plane], out)
            for k, v in rect_d.items():
                out = torch.where(km == k, v["rec"][idx_plane], out)
            return out

        rec_y = select_plane(0, 0)
        rec_u = select_plane(1, 1)
        rec_v = select_plane(2, 1)

        # --- level pack: per 8x8 cell, the SELECTED leaf's tiles --------
        def pack_cells(pidx, t):
            return kpick({**{i: _tiles8(levels[bs_][pidx], t)
                             for i, bs_ in enumerate(SIZES64)},
                          **{k: _tiles8(v["levels"][pidx], t)
                             for k, v in rect_d.items()}}, torch.int16)

        ly_pack = pack_cells(0, 8)
        lu_pack = pack_cells(1, 4)
        lv_pack = pack_cells(2, 4)

        # --- in-loop filters over the mi-grid region (the decoder filters
        # exactly [ph_mi, pw_mi]; the pad margin is edge-replicated) ----
        crop = lambda p2, sh: p2[:, : ph_mi >> sh, : pw_mi >> sh]
        cy, cu, cv = crop(rec_y, 0), crop(rec_u, 1), crop(rec_v, 1)
        sz8 = size8[:, : ph_mi // 8, : pw_mi // 8].to(torch.int32)
        idx_sb = torch.zeros((S, -(-ph_mi // 64), -(-pw_mi // 64)),
                             dtype=torch.uint8, device=dev)
        # per-direction tx extents (they differ at rect leaves: vertical
        # edges follow the tx WIDTH, horizontal ones the HEIGHT)
        szw8 = szh8 = sz8
        if rect:
            k8c = kind8[:, : ph_mi // 8, : pw_mi // 8].long()
            szw8 = torch.where(k8c >= 4, torch.as_tensor(
                [0, 0, 0, 0, 16, 8, 32, 16], device=dev)[k8c], sz8)
            szh8 = torch.where(k8c >= 4, torch.as_tensor(
                [0, 0, 0, 0, 8, 16, 16, 32], device=dev)[k8c], sz8)
        upy = lambda a: _up1(a, 8)
        upc = lambda a: _up1(a >> 1, 4)
        cy = DB.deblock_plane(cy, upy(szw8), lf_levels[0], lf_levels[1],
                              True, bd=bd, sizes_px_h=upy(szh8))
        cu = DB.deblock_plane(cu, upc(szw8), lf_levels[2], lf_levels[2],
                              False, bd=bd, sizes_px_h=upc(szh8))
        cv = DB.deblock_plane(cv, upc(szw8), lf_levels[3], lf_levels[3],
                              False, bd=bd, sizes_px_h=upc(szh8))
        # the deblocked (pre-CDEF) planes: loop restoration's stripe
        # context rows come from these (spec save_deblock_boundary_lines)
        deb = (cy, cu, cv)

        if cdef:
            # per-8x8-unit skip: the selected LEAF has all-zero levels
            def skipmap(lv3, kh, kw):
                z = ((lv3[0] == 0).all(-1).all(-1)
                     & (lv3[1] == 0).all(-1).all(-1)
                     & (lv3[2] == 0).all(-1).all(-1))
                return _up1_hw(z, kh, kw)

            sks = {i: skipmap(levels[bs_], bs_ // 8, bs_ // 8)
                   for i, bs_ in enumerate(SIZES64)}
            for k, v in rect_d.items():
                bh_, bw_ = _rect_dims(k)
                sks[k] = skipmap(v["levels"], bh_ // 8, bw_ // 8)
            sk = kpick(sks, torch.bool)[:, : sz8.shape[1], : sz8.shape[2]]
            damping = CD.pick_damping(q)
            (cy, cu, cv), idx_sb = CD.cdef_search_and_apply(
                (cy, cu, cv), (crop(sy, 0), crop(su, 1), crop(sv, 1)), sk,
                damping, coeff_shift=bd - 8)
            idx_sb = idx_sb.to(torch.uint8)

        px = MC.pixel_dtype(bd)
        repad = lambda core, like: MC.edge_pad(
            core, 0, like.shape[-2] - core.shape[-2], 0,
            like.shape[-1] - core.shape[-1]).to(px)
        out = (size8, mv_sel, ly_pack, lu_pack, lv_pack,
               repad(cy, rec_y), repad(cu, rec_u), repad(cv, rec_v), idx_sb)
        if nrefs >= 2:
            out = out + (ref8,)
        if compound:
            out = out + (mv2_sel,)
        if txs:
            out = out + (txty8,)
        if rect:
            out = out + (torch.as_tensor(KIND_SHAPE, device=dev)[
                kind8.long()].to(torch.uint8),)
        if lr:
            out = out + tuple(p.to(px) for p in deb)
        return out

    def mc_one(padded, pidx, chroma, bs2, pad2, mvs, mvs_c, sel):
        """Subpel MC of every block of one size on one plane: ref0's
        prediction, replaced by reference i where sel == i and by the
        compound average of ref0 (at mvs) and ref1 (at mvs_c) where
        sel == nrefs.  The compound reuses ref0's patch gather and its
        convolution (both=True)."""
        pt, r0, c0 = _gather_mc_patch(padded[0][pidx], mvs, bs2, pad2, chroma)
        if compound:
            out, m0 = _interp_patch(pt, r0, c0, bs2, bd, filt, both=True)
        else:
            out = _interp_patch(pt, r0, c0, bs2, bd, filt)
        for i in range(1, nrefs):
            pi = _mc_patch(padded[i][pidx], mvs, bs2, pad2, chroma, bd,
                           filt=filt)
            out = torch.where((sel == i)[..., None, None], pi, out)
        if compound:
            m1 = _mc_patch(padded[1][pidx], mvs_c, bs2, pad2, chroma, bd,
                           jnt=True, filt=filt)
            out = torch.where((sel == nrefs)[..., None, None],
                              MC.jnt_average(m0, m1, bd), out)
        return out

    def _rd_decide(sy, su, sv, padded, per_ref, mv, cost, qq, lam, ac, ins):
        """The RD presets' decision: 64x64 candidates per reference, the
        per-size argmin over the references and the compound candidate,
        residual coding of every leaf size against its own prediction
        (with txs: DCT and IDTX, the cheaper kept), the rect hypotheses
        (with rect), and the bottom-up float32 RD merge.  Returns (the
        per-cell leaf-kind map, {"levels", "rec", "mv", "sel", "mv2",
        "txty"} per size and "rect": {kind: {"mv", "sel", "mv2",
        "levels", "rec"}})."""
        dev = sy.device
        src_of = {bs: _block(sy, bs) for bs in SIZES64}

        def me64(i, mv32):
            """64x64 leaf candidates: the four 32x32 children's refined
            MVs, each evaluated on the whole 64 block."""
            prior64 = per_ref[i][2][64] * 8
            best_mv = best_cost = None
            for dr in (0, 1):
                for dc in (0, 1):
                    mvc = mv32[:, dr::2, dc::2]
                    pred = _mc_patch(padded[i][0], mvc, 64, pad, False, bd,
                                     filt=filt)
                    c = ((src_of[64] - pred).abs().sum((-1, -2),
                                                        dtype=torch.int32)
                         + ((lam * ME.mv_rate_bits(mvc - prior64)) >> 4))
                    if best_mv is None:
                        best_mv, best_cost = mvc, c
                    else:
                        better = c < best_cost
                        best_mv = torch.where(better[..., None], mvc, best_mv)
                        best_cost = torch.minimum(c, best_cost)
            return best_mv, best_cost

        mv[64], cost[64] = me64(0, mv[32])
        sel = {bs: None for bs in SIZES64}
        mv_c = {bs: None for bs in SIZES64}    # compound second (bwd) MV
        if nrefs >= 2:
            mvs_all, costs_all = [dict(mv)], [dict(cost)]
            for i in range(1, nrefs):
                mvi, costi = dict(per_ref[i][0]), dict(per_ref[i][1])
                mvi[64], costi[64] = me64(i, mvi[32])
                mvs_all.append(mvi)
                costs_all.append(costi)
            for bs in SIZES64:
                s = torch.zeros(costs_all[0][bs].shape, dtype=torch.uint8,
                                device=dev)
                best_c, best_mv = costs_all[0][bs], mvs_all[0][bs]
                for i in range(1, nrefs):
                    better = costs_all[i][bs] < best_c
                    s = torch.where(better, i, s).to(torch.uint8)
                    best_c = torch.minimum(costs_all[i][bs], best_c)
                    best_mv = torch.where(better[..., None], mvs_all[i][bs],
                                          best_mv)
                if compound:
                    # COMPOUND_AVERAGE candidate from the per-ref best MVs
                    mid0 = _mc_patch(padded[0][0], mvs_all[0][bs], bs, pad,
                                     False, bd, jnt=True, filt=filt)
                    mid1 = _mc_patch(padded[1][0], mvs_all[1][bs], bs, pad,
                                     False, bd, jnt=True, filt=filt)
                    pred_c = MC.jnt_average(mid0, mid1, bd)
                    rate = (ME.mv_rate_bits(mvs_all[0][bs]
                                            - per_ref[0][2][bs] * 8)
                            + ME.mv_rate_bits(mvs_all[1][bs]
                                              - per_ref[1][2][bs] * 8)
                            + COMP_EXTRA_BITS)
                    cost_c = ((src_of[bs] - pred_c).abs().sum(
                        (-1, -2), dtype=torch.int32) + ((lam * rate) >> 4))
                    use_c = cost_c < best_c
                    sel[bs] = torch.where(use_c, nrefs, s).to(torch.uint8)
                    mv[bs] = torch.where(use_c[..., None], mvs_all[0][bs],
                                         best_mv)
                    mv_c[bs] = mvs_all[1][bs]
                    cost[bs] = torch.minimum(cost_c, best_c)
                else:
                    sel[bs] = s
                    mv[bs] = best_mv
                    cost[bs] = best_c

        # --- per-size MC + residual coding + RD cost: J = SSE of the
        # recon (all planes) + lambda_rd * (coefficient + MV + mode bits),
        # lambda_rd ~ 0.25 qstep^2, in float32 as the reference evaluates
        # it (one fused multiply-add, pipeline/rdo.py) -----------------
        lam_rd = float(max(4, (ac * ac) >> 8))         # exact in float32
        sse = lambda a, b: ((a - b) ** 2).sum((-1, -2), dtype=torch.int32)
        levels, rec, jcost, txty = {}, {}, {}, {}
        for bs in SIZES64:
            cbs = bs // 2
            su_b, sv_b = _block(su, cbs), _block(sv, cbs)
            pred_y = mc_one(padded, 0, False, bs, pad, mv[bs], mv_c[bs],
                            sel[bs])
            pred_u = mc_one(padded, 1, True, cbs, cpad, mv[bs], mv_c[bs],
                            sel[bs])
            pred_v = mc_one(padded, 2, True, cbs, cpad, mv[bs], mv_c[bs],
                            sel[bs])
            base_r = ME.mv_rate_bits(mv[bs] - per_ref[0][2][bs] * 8) \
                + mode_bits
            if compound:
                base_r = base_r + torch.where(
                    sel[bs] == nrefs,
                    ME.mv_rate_bits(mv_c[bs] - per_ref[1][2][bs] * 8)
                    + COMP_EXTRA_BITS, 0)
            # tx-type search (ref ENCDEC_TX_SEARCH full loop,
            # EbProductCodingLoop.c:1880): the leaf coded with each type
            # of the inter reduced set (DCT, IDTX), chroma inheriting the
            # luma type; a winner without luma coefficients never codes
            # the type (the decoder infers DCT), so only a variant with
            # luma coefficients may displace DCT.  Dim-64 is DCT-only.
            best = None
            for ty in ((T.DCT_DCT,) if (not txs or bs == 64)
                       else (T.DCT_DCT, T.IDTX)):
                ly, rec_y = _encode_plane(src_of[bs], pred_y, qq(bs),
                                          TX_OF[bs], bd, ty)
                lu, rec_u = _encode_plane(su_b, pred_u, qq(bs), TX_OF_C[bs],
                                          bd, ty)
                lv, rec_v = _encode_plane(sv_b, pred_v, qq(bs), TX_OF_C[bs],
                                          bd, ty)
                d = sse(src_of[bs], rec_y) + sse(su_b, rec_u) \
                    + sse(sv_b, rec_v)
                r = _coeff_bits(ly) + _coeff_bits(lu) + _coeff_bits(lv) \
                    + base_r
                j = RDO.fma_f32(lam_rd, r.to(torch.float32),
                                d.to(torch.float32))
                cand = [j, ly, lu, lv, rec_y, rec_u, rec_v,
                        torch.full(j.shape, ty, dtype=torch.uint8,
                                   device=dev)]
                if best is None:
                    best = cand
                    continue
                pick = (j < best[0]) & (ly != 0).any(-1).any(-1)
                best = [torch.where(pick.reshape(pick.shape + (1,) * (
                    a.dim() - pick.dim())), a, b_)
                    for a, b_ in zip(cand, best)]
            jcost[bs] = best[0]
            txty[bs] = best[7]
            levels[bs] = tuple(a.to(torch.int16) for a in best[1:4])
            rec[bs] = tuple(_unblock(a) for a in best[4:7])

        rect_d = _rect_hypotheses(sy, su, sv, padded, per_ref, mv, cost, sel,
                                  mv_c, qq, lam_rd) if rect else {}
        use16, use32, use64, maps = rd_merge(
            jcost, lam_rd, ins,
            {k: v["j"] for k, v in rect_d.items()} if rect else None)
        kind8 = _kind_map(maps["choice16"], maps["choice32"], use64)
        return kind8, {"levels": levels, "rec": rec, "mv": mv, "sel": sel,
                       "mv2": mv_c, "txty": txty, "rect": rect_d}

    def _rect_hypotheses(sy, su, sv, padded, per_ref, mv, cost, sel, mv_c,
                         qq, lam_rd):
        """The rect leaves (PARTITION_HORZ / VERT at the 16 and 32 nodes):
        each half inherits the full inter descriptor (MV, reference
        choice, second MV) of the cheaper of its two square children at
        the half size, is predicted at 8x8-cell granularity (the
        interpolation is translation-invariant) and coded with the rect
        transform; its node J is the two halves' J.  ref: ext partition
        shapes in mode_decision_sb (EbProductCodingLoop.c:3300).
        Returns {kind: {"j" node map, cell maps "mv" / "sel" / "mv2",
        "levels" (rect block grids), "rec" (planes)}}."""
        out = {}
        sse = lambda a, b: ((a - b) ** 2).sum((-1, -2), dtype=torch.int32)
        for kind, (ns, shp) in RECT_KINDS.items():
            cs = ns // 2
            horz = shp == "h"
            bh_, bw_ = _rect_dims(kind)
            # the two children of a half: columns (HORZ) or rows (VERT)
            # of the half-size map, pairwise
            if horz:
                slc = (lambda a: a[:, :, 0::2], lambda a: a[:, :, 1::2])
            else:
                slc = (lambda a: a[:, 0::2], lambda a: a[:, 1::2])
            sel_b = slc[1](cost[cs]) < slc[0](cost[cs])

            def pick(a, _s=sel_b, _sl=slc):
                m = _s[..., None] if a.dim() == 4 else _s
                return torch.where(m, _sl[1](a), _sl[0](a))

            rmv = pick(mv[cs])
            rpri = pick(per_ref[0][2][cs])
            rsel = None if sel[cs] is None else pick(sel[cs])
            rmv2 = None if mv_c[cs] is None else pick(mv_c[cs])
            up = lambda a: _up1_hw(a, bh_ // 8, bw_ // 8)
            cmv = up(rmv).to(torch.int32)
            csel = None if rsel is None else up(rsel)
            cmv2 = None if rmv2 is None else up(rmv2).to(torch.int32)
            py_ = _unblock(mc_one(padded, 0, False, 8, pad, cmv, cmv2, csel))
            pu_ = _unblock(mc_one(padded, 1, True, 4, cpad, cmv, cmv2, csel))
            pv_ = _unblock(mc_one(padded, 2, True, 4, cpad, cmv, cmv2, csel))
            qr = qq(bh_, bw_)
            sby = _block_rect(sy, bh_, bw_)
            sbu = _block_rect(su, bh_ // 2, bw_ // 2)
            sbv = _block_rect(sv, bh_ // 2, bw_ // 2)
            ly_, ry_ = _encode_plane(sby, _block_rect(py_, bh_, bw_), qr,
                                     RECT_TX[kind], bd)
            lu_, ru_ = _encode_plane(sbu, _block_rect(pu_, bh_ // 2, bw_ // 2),
                                     qr, RECT_TX_C[kind], bd)
            lv_, rv_ = _encode_plane(sbv, _block_rect(pv_, bh_ // 2, bw_ // 2),
                                     qr, RECT_TX_C[kind], bd)
            d = sse(sby, ry_) + sse(sbu, ru_) + sse(sbv, rv_)
            r = (_coeff_bits(ly_) + _coeff_bits(lu_) + _coeff_bits(lv_)
                 + ME.mv_rate_bits(rmv - rpri * 8) + mode_bits)
            if compound:
                rpri2 = pick(per_ref[1][2][cs])
                r = r + torch.where(rsel == nrefs,
                                    ME.mv_rate_bits(rmv2 - rpri2 * 8)
                                    + COMP_EXTRA_BITS, 0)
            jr = RDO.fma_f32(lam_rd, r.to(torch.float32), d.to(torch.float32))
            out[kind] = {
                "j": (jr[:, 0::2] + jr[:, 1::2]) if horz
                else (jr[:, :, 0::2] + jr[:, :, 1::2]),
                "mv": cmv.to(torch.int16), "sel": csel,
                "mv2": None if cmv2 is None else cmv2.to(torch.int16),
                "levels": (ly_.to(torch.int16), lu_.to(torch.int16),
                           lv_.to(torch.int16)),
                "rec": (_unblock(ry_), _unblock(ru_), _unblock(rv_))}
        return out

    def _fast_refine_code(sy, su, sv, padded, per_ref, per_ref_mv, kind8,
                          kpick, sq_cells, qq, lam):
        """Preset 8 after the merge: one quarter-pel refinement per 8x8
        cell and reference against the true reference (each LEAF picks
        the candidate minimizing the sum of its cells' SADs + MV rate),
        the per-cell reference / compound choice, MC at cell granularity
        and residual coding at every leaf size.  Returns (mv_sel, ref8,
        mv2_sel, levels, rec) per size."""
        dev = sy.device
        S = sy.shape[0]
        leaf_cells = lambda d: kpick({ki: _up1(d[bs_], bs_ // 8)
                                      for ki, bs_ in enumerate(SIZES64)},
                                     d[8].dtype)
        dyx_c = torch.tensor(cand, dtype=torch.int32, device=dev)
        src8T = _block(sy, 8).reshape(-1, 8, 8).permute(1, 2, 0).to(
            torch.int16)

        def cand_slice(P, ci):
            dy, dx = cand[ci]
            pyi, pxi = ((2 * dy) & 15) >> 2, ((2 * dx) & 15) >> 2
            fy, fx = dy >> 3, dx >> 3
            return P[pyi][pxi][fy + 1: fy + 9, fx + 1: fx + 9, :]

        def refine_ref(i):
            """-> (refined cell MVs [nb8h,nb8w,2] i32, {bs: leaf cost},
            phase grid, per-cell candidate index)."""
            mvc8 = kpick(sq_cells(per_ref_mv[i]), torch.int32)
            patch = G.gather_blocks_grid(padded[i][0], mvc8[..., 0] >> 3,
                                         mvc8[..., 1] >> 3, 8, pad, pad - 1,
                                         halo=8, off=-4)
            P = _phase_grid(patch.reshape(-1, 16, 16).permute(1, 2, 0)
                            .to(torch.int32), 8, bd, kern_c)
            lvl = torch.stack([
                (src8T - cand_slice(P, ci)).abs().sum((0, 1),
                                                      dtype=torch.int32)
                .reshape(S, nb8h, nb8w) for ci in range(len(cand))])
            idx_l, cost_l = {}, {}
            for bs in SIZES64:
                if bs > 8:
                    lvl = _blocksum2(lvl)
                cl = lvl + ((lam * ME.mv_rate_bits(
                    per_ref_mv[i][bs][None] + dyx_c[:, None, None, None, :]
                    - per_ref[i][2][bs][None] * 8)) >> 4)
                idx_l[bs] = torch.argmin(cl, 0)
                cost_l[bs] = cl.min(0).values
            kcell = leaf_cells(idx_l)
            return mvc8 + dyx_c[kcell], cost_l, P, kcell

        ref_fine = [refine_ref(i) for i in range(nrefs)]
        ref8 = mv2_sel = None
        if nrefs == 1:
            mv_sel = ref_fine[0][0].to(torch.int16)
        else:
            sadc = None
            if compound:
                # compound decision from the refined cell predictions: a
                # pixel-domain average (the recon below uses the exact
                # CONV_BUF-domain jnt average)
                def pred_sel(P, kcell):
                    allc = torch.stack([cand_slice(P, ci)
                                        for ci in range(len(cand))])
                    idx = kcell.reshape(1, 1, 1, -1).expand(1, 8, 8, -1)
                    return torch.gather(allc, 0, idx)[0]
                p0s = pred_sel(ref_fine[0][2], ref_fine[0][3])
                p1s = pred_sel(ref_fine[1][2], ref_fine[1][3])
                avg = (p0s.to(torch.int32) + p1s + 1) >> 1
                sadc = ((src8T.to(torch.int32) - avg).abs()
                        .sum((0, 1), dtype=torch.int32)
                        .reshape(S, nb8h, nb8w))
            sel_l = {}
            for bs in SIZES64:
                k = bs // 8
                costs = torch.stack([ref_fine[i][1][bs]
                                     for i in range(nrefs)])
                s = torch.argmin(costs, 0).to(torch.uint8)
                if compound:
                    if bs > 8:
                        sadc = _sum4(sadc)
                    if bs >= 16:
                        # 8x8 leaves stay single-ref (rarely compound,
                        # the most costly)
                        r0 = ME.mv_rate_bits(ref_fine[0][0][:, ::k, ::k]
                                             - per_ref[0][2][bs] * 8)
                        r1 = ME.mv_rate_bits(ref_fine[1][0][:, ::k, ::k]
                                             - per_ref[1][2][bs] * 8)
                        cc = sadc + ((lam * (r0 + r1 + COMP_EXTRA_BITS))
                                     >> 4)
                        s = torch.where(cc < costs.min(0).values,
                                        nrefs, s).to(torch.uint8)
                sel_l[bs] = s
            ref8 = leaf_cells(sel_l)
            mv_sel = ref_fine[0][0]
            for i in range(1, nrefs):
                mv_sel = torch.where((ref8 == i)[..., None], ref_fine[i][0],
                                     mv_sel)
            mv_sel = mv_sel.to(torch.int16)
            if compound:
                mv2_sel = ref_fine[1][0].to(torch.int16)

        # --- motion compensation ONCE at selected-cell granularity (the
        # interpolation is translation-invariant, so MCing a leaf equals
        # MCing its 8x8 luma / 4x4 chroma cells with the same MV) -------
        mv32 = mv_sel.to(torch.int32)
        mv32c = None if mv2_sel is None else mv2_sel.to(torch.int32)
        pred_y_pl = _unblock(mc_one(padded, 0, False, 8, pad, mv32, mv32c,
                                    ref8))
        pred_u_pl = _unblock(mc_one(padded, 1, True, 4, cpad, mv32, mv32c,
                                    ref8))
        pred_v_pl = _unblock(mc_one(padded, 2, True, 4, cpad, mv32, mv32c,
                                    ref8))

        # --- residual coding at every size against the selected pred ----
        levels, rec = {}, {}
        for bs in SIZES64:
            cbs = bs // 2
            ly, rec_y = _encode_plane(_block(sy, bs), _block(pred_y_pl, bs),
                                      qq(bs), TX_OF[bs], bd)
            lu, rec_u = _encode_plane(_block(su, cbs),
                                      _block(pred_u_pl, cbs), qq(bs),
                                      TX_OF_C[bs], bd)
            lv, rec_v = _encode_plane(_block(sv, cbs),
                                      _block(pred_v_pl, cbs), qq(bs),
                                      TX_OF_C[bs], bd)
            levels[bs] = (ly.to(torch.int16), lu.to(torch.int16),
                          lv.to(torch.int16))
            rec[bs] = (_unblock(rec_y), _unblock(rec_u), _unblock(rec_v))
        return mv_sel, ref8, mv2_sel, levels, rec

    return step


def rd_merge(jcost: dict, lam_rd: float, ins: dict, rect_j=None):
    """The RD presets' bottom-up partition merge: at each node the whole
    block (J + lambda_rd * PARTITION_NONE bits, only inside the frame)
    against its four children's best J + lambda_rd * PARTITION_SPLIT
    bits, in the reference's float32 evaluation (pipeline/rdo.py).
    With rect_j ({kind: node J map} of RECT_KINDS, presets <= 5) the 16
    and 32 nodes also weigh HORZ and VERT (+ their partition bits, only
    inside the frame): the least J wins, NONE before HORZ before VERT
    before SPLIT on ties.

    jcost: {bs: [..., ph/bs, pw/bs] float32 leaf J}; lam_rd:
    float32-valued; ins: {16/32/64: bool inside masks}.  Returns (use16,
    use32, use64 — NONE at each level, {name: map}: the j8 / j_split /
    j_at float32 maps and choice16 / choice32 (0 NONE, 1 HORZ, 2 VERT,
    3 SPLIT))."""
    none_j = {bs: RDO.scalar_product_f32(lam_rd, _PART_BITS[bs][0])
              for bs in SIZES64}
    split_j = {bs: RDO.scalar_product_f32(lam_rd, _PART_BITS[bs][1])
               for bs in (16, 32, 64)}
    inf = RDO.f32_scalar(3e38)
    j_at = jcost[8] + none_j[8]
    maps = {"j8": j_at}
    use = {}
    for bs in (16, 32, 64):
        j_split = RDO.sum4_f32(j_at, bs == 16) + split_j[bs]
        j_bs = torch.where(ins[bs], jcost[bs] + none_j[bs], inf)
        if rect_j is not None and bs < 64:
            kh, kv = (4, 5) if bs == 16 else (6, 7)
            jh = torch.where(ins[bs], rect_j[kh] + RDO.scalar_product_f32(
                lam_rd, _PART_BITS[bs][2]), inf)
            jv = torch.where(ins[bs], rect_j[kv] + RDO.scalar_product_f32(
                lam_rd, _PART_BITS[bs][3]), inf)
            j_at = torch.minimum(torch.minimum(j_bs, j_split),
                                 torch.minimum(jh, jv))
            choice = torch.where(j_at == j_bs, 0, torch.where(
                j_at == jh, 1, torch.where(j_at == jv, 2, 3)))
            use[bs] = choice == 0
        else:
            use[bs] = j_bs <= j_split
            choice = torch.where(use[bs], 0, 3)
            j_at = torch.where(use[bs], j_bs, j_split)
        maps[f"j_split{bs}"] = j_split
        maps[f"j{bs}"] = j_bs
        maps[f"j_at{bs}"] = j_at
        maps[f"choice{bs}"] = choice
    return use[16], use[32], use[64] & ins[64], maps


def _kind_map(choice16, choice32, use64):
    """The per-8x8-cell leaf kind (0..3 square 8/16/32/64, RECT_KINDS 4..7)
    from the merge's choices at the 16 and 32 nodes (0 NONE, 1 HORZ,
    2 VERT, 3 SPLIT; [S, ...] maps) and its 64 decision."""
    c16 = _up1(choice16, 2)
    kind16 = torch.where(c16 == 0, 1, torch.where(
        c16 == 1, 4, torch.where(c16 == 2, 5, 0)))
    c32 = _up1(choice32, 4)
    kind32 = torch.where(c32 == 0, 2, torch.where(
        c32 == 1, 6, torch.where(c32 == 2, 7, -1)))
    return torch.where(_up1(use64, 8), 3,
                       torch.where(kind32 >= 0, kind32, kind16))


def _blocksum2(lat):
    """[n, ..., 2h, 2w] -> [n, ..., h, w] 2x2 sums (lattice levels)."""
    *lead, h, w = lat.shape
    return lat.reshape(*lead, h // 2, 2, w // 2, 2).sum((-3, -1),
                                                        dtype=torch.int32)


@functools.lru_cache(maxsize=4)
def build_p_frame_encoder_dyn(ph: int, pw: int, mi_rows: int, mi_cols: int,
                              search: int = SEARCH_RANGE,
                              cdef: bool = False, bd: int = 8,
                              rdo: bool = False, txs: bool = False,
                              filt: int = 0, gm: bool = False,
                              lr: bool = False, rect: bool = False,
                              filters: bool = True, aq: bool = False):
    """The P step for one geometry: step(sy, su, sv, ref_y, ref_u, ref_v,
    qindex, lf_y, lf_u, lf_v[, gmv][, qmap]) — every qindex runs the same
    callable (counterpart of the reference's jitted dynamic-q
    build_p_frame_encoder_dyn)."""
    return p_frame_step(ph, pw, mi_rows, mi_cols, search=search, bd=bd,
                        rdo=rdo, txs=txs, filt=filt, gm=gm, lr=lr,
                        rect=rect, filters=filters, aq=aq, cdef=cdef)


@functools.lru_cache(maxsize=6)
def build_b_frame_encoder_dyn(ph: int, pw: int, mi_rows: int, mi_cols: int,
                              cdef: bool = False, compound: bool = False,
                              bd: int = 8, filt: int = 0, rdo: bool = False,
                              nrefs: int = 2, lr: bool = False,
                              aq: bool = False, txs: bool = False,
                              rect: bool = False):
    """The multi-reference step for one geometry: step(sy, su, sv,
    r0_y, r0_u, r0_v, r1_y, r1_u, r1_v[, r2_y, r2_u, r2_v], qindex, lf_y,
    lf_u, lf_v[, qmap]); compound=True adds the COMPOUND_AVERAGE of
    (ref0, ref1), nrefs=3 a third single-prediction reference
    (counterpart of the reference's jitted build_b_frame_encoder_dyn)."""
    return p_frame_step(ph, pw, mi_rows, mi_cols, nrefs=nrefs,
                        compound=compound, bd=bd, rdo=rdo, txs=txs,
                        filt=filt, cdef=cdef, lr=lr, rect=rect, aq=aq)
