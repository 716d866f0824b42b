"""Intra frame encoder in PyTorch: wavefront sweeps of batched blocks.

Port of svt_av1_tpu/pipeline/intra_encoder.py with ibc=False, at 8
or 10 bits: ``frame_step`` (uniform 8x8 luma / 4x4 chroma blocks) and
``frame_step16`` (16x16 units that keep the 16x16 block or split into
four 8x8 blocks by RD cost: the keyframes of inter streams at presets
0-7).  Presets 6-8 search the 13 base luma modes with DC chroma; presets
0-5 (rich=True) search 61 luma candidates (the 13 base modes and angle
deltas -3..3 on the eight directional ones) and a joint U+V pick among
DC / V / H / SMOOTH (each with its derived tx type) and chroma from luma
(CFL, alphas -16..16 per plane).  Residuals are DCT but for the derived
chroma types.

A block predicts from its reconstructed above/left (and above-right)
neighbours, so blocks are coded in staircase-diagonal order d = 2r + c:
every block of one diagonal is one batch (the reference package's
``lax.fori_loop`` over diagonals becomes a Python loop of batched
tensor ops).  Reconstruction state lives in block-grid layout
[nbh+1, nbw+1, bs, bs]; the extra row/column absorbs the reads and
writes of positions outside the frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu_torch import tables as _tbl
from svt_av1_tpu_torch.ops import intra
from svt_av1_tpu_torch.ops import mc as MC
from svt_av1_tpu_torch.ops import quant as Q
from svt_av1_tpu_torch.ops import transforms as T
from svt_av1_tpu_torch.pipeline import rdo as RDO
from svt_av1_tpu_torch.pipeline.inter_encoder import _coeff_bits

LUMA_BS = 8
CHROMA_BS = 4
UV_CFL_ID = 13     # UV_CFL_PRED symbol (spec intra_frame_uv_mode)

# mode-decision candidate lists.  The rich set (presets <= 5) adds
# +-1..3 angle deltas on every directional base (ref angle-delta
# candidate injection, EbModeDecision.c:1120+); chroma then picks among
# DC / V / H / SMOOTH and CFL.
DIR_MODES = (intra.V, intra.H, intra.D45, intra.D135, intra.D113,
             intra.D157, intra.D203, intra.D67)
RICH_MODES = tuple(intra.ALL_MODES) + tuple(
    (m, d) for m in DIR_MODES for d in (-3, -2, -1, 1, 2, 3))
UV_MODES = (intra.DC, intra.V, intra.H, intra.SMOOTH)
# intra chroma tx type is DERIVED from the uv mode (spec compute_tx_type
# -> Mode_To_Txfm_Type; ref intra_mode_to_tx_type, EbModeDecision.c:1851)
UV_TX = {intra.DC: T.DCT_DCT, intra.V: T.ADST_DCT,
         intra.H: T.DCT_ADST, intra.SMOOTH: T.ADST_ADST}


def _cand_tables(cands):
    mode_ids, deltas, is_d203 = [], [], []
    for c in cands:
        m, d = c if isinstance(c, tuple) else (c, 0)
        mode_ids.append(m)
        deltas.append(d)
        is_d203.append(m == intra.D203)
    return (np.array(mode_ids, np.int32), np.array(deltas, np.int32),
            np.array(is_d203))


def _encode_plane_batch(src, pred, qindex, tx_size: int, bd: int = 8,
                        tx_type: int = T.DCT_DCT):
    """residual -> (levels, recon) for a [B, n, n] batch."""
    resid = src - pred
    coeff = T.fwd_txfm2d_batch_exact(resid, tx_size, tx_type, bd)
    levels = Q.quantize_batch(coeff, qindex, tx_size, bd)
    dq = Q.dequantize_batch(levels, qindex, tx_size, bd)
    rec_resid = T.inv_txfm2d_batch(dq, tx_size, tx_type, bd)
    recon = torch.clamp(pred + rec_resid, 0, (1 << bd) - 1)
    return levels, recon


@functools.lru_cache(maxsize=8)
def _static_maps(nbh: int, nbw: int, device: torch.device,
                 rich: bool = False):
    """Above-right / below-left availability (padded with an invalid
    row/col) and the candidate tables (mode ids, angle deltas, D203
    flags), as tensors on ``device``."""
    ar_avail_np, bl_avail_np = intra.edge_availability(nbh, nbw)
    ar_pad = np.zeros((nbh + 1, nbw + 1), bool)
    ar_pad[:nbh, :nbw] = ar_avail_np
    bl_pad = np.zeros((nbh + 1, nbw + 1), bool)
    bl_pad[:nbh, :nbw] = bl_avail_np
    mode_ids, deltas, d203 = _cand_tables(_luma_cands(rich))
    t = lambda a: torch.as_tensor(a, device=device)
    return t(ar_pad), t(bl_pad), t(mode_ids), t(deltas), t(d203)


def _luma_cands(rich: bool):
    return RICH_MODES if rich else tuple(intra.ALL_MODES)


def _chroma_search(su_b, sv_b, cp_u, cp_v, rec_y, qindex: int, tx_c: int,
                   bd: int):
    """The rich joint U+V chroma pick of a [B, ck, ck] chroma batch: each
    of UV_MODES coded with its derived tx type, plus the CFL candidate
    (spec 7.11.5; ref cfl_luma_subsampling_420 / subtract_average /
    cfl_predict, EbIntraPrediction.c:1303-1379): the AC of the block's
    reconstructed luma in Q3, an alpha in -16..16 searched per plane
    against the source on top of the DC prediction, never picked when
    both alphas are 0 (no joint-sign code).  The winner has the least
    U+V SSE (first index on ties).  cp_u / cp_v: [B, 4, ck, ck] DC / V /
    H / SMOOTH predictions; rec_y [B, 2ck, 2ck].  Returns (uv mode ids,
    U levels, U recon, V levels, V recon, SSE, coefficient bits, CFL
    alpha U, CFL alpha V) of the winners."""
    dev = su_b.device
    lvl_u, rec_u, lvl_v, rec_v, sse_c, bits_c = [], [], [], [], [], []
    sse = lambda a, b: ((a - b) ** 2).sum((-1, -2), dtype=torch.int32)
    for i, cm in enumerate(UV_MODES):
        li_u, ri_u = _encode_plane_batch(su_b, cp_u[:, i], qindex, tx_c, bd,
                                         UV_TX[cm])
        li_v, ri_v = _encode_plane_batch(sv_b, cp_v[:, i], qindex, tx_c, bd,
                                         UV_TX[cm])
        lvl_u.append(li_u)
        rec_u.append(ri_u)
        lvl_v.append(li_v)
        rec_v.append(ri_v)
        sse_c.append(sse(su_b, ri_u) + sse(sv_b, ri_v))
        bits_c.append(_coeff_bits(li_u) + _coeff_bits(li_v))
    ck = su_b.shape[-1]
    shift = int(np.log2(ck * ck))
    hi = (1 << bd) - 1
    lq3 = ((rec_y[:, 0::2, 0::2] + rec_y[:, 0::2, 1::2]
            + rec_y[:, 1::2, 0::2] + rec_y[:, 1::2, 1::2]) << 1)
    lavg = (lq3.sum((-1, -2), dtype=torch.int32)
            + (1 << (shift - 1))) >> shift
    ac = lq3 - lavg[:, None, None]
    alphas = torch.arange(-16, 17, dtype=torch.int32, device=dev)
    scaled = alphas[None, :, None, None] * ac[:, None]
    scq = torch.where(scaled >= 0, (scaled + 32) >> 6,
                      -((-scaled + 32) >> 6))
    lanes = torch.arange(su_b.shape[0], device=dev)
    cfl_l, cfl_r, cfl_a, sse_cfl, bits_cfl = [], [], [], 0, 0
    for sp_, dc_ in ((su_b, cp_u[:, 0]), (sv_b, cp_v[:, 0])):
        pcand = torch.clamp(dc_[:, None] + scq, 0, hi)
        ai = torch.argmin(((sp_[:, None] - pcand) ** 2).sum(
            (-1, -2), dtype=torch.int32), 1)
        cfl_a.append(alphas[ai])
        li, ri = _encode_plane_batch(sp_, pcand[lanes, ai], qindex, tx_c, bd,
                                     T.DCT_DCT)
        cfl_l.append(li)
        cfl_r.append(ri)
        sse_cfl = sse_cfl + sse(sp_, ri)
        bits_cfl = bits_cfl + _coeff_bits(li)
    both0 = (cfl_a[0] == 0) & (cfl_a[1] == 0)
    sse_c.append(sse_cfl + both0.to(torch.int32) * (1 << 30))
    bits_c.append(bits_cfl)
    lvl_u.append(cfl_l[0])
    rec_u.append(cfl_r[0])
    lvl_v.append(cfl_l[1])
    rec_v.append(cfl_r[1])
    sse_all = torch.stack(sse_c, 1)
    bc = torch.argmin(sse_all, 1)
    pick = lambda lst: torch.stack(lst, 1)[lanes, bc]
    uv_ids = torch.tensor(UV_MODES + (UV_CFL_ID,), dtype=torch.int32,
                          device=dev)
    is_cfl = bc == len(UV_MODES)
    return (uv_ids[bc], pick(lvl_u), pick(rec_u), pick(lvl_v), pick(rec_v),
            sse_all[lanes, bc], torch.stack(bits_c, 1)[lanes, bc],
            torch.where(is_cfl, cfl_a[0], 0), torch.where(is_cfl, cfl_a[1], 0))


def frame_step(sy, su, sv, qindex: int, bd: int = 8, rich: bool = False):
    """Full-frame intra encode of a block grid, or of a batch of S
    frames' block grids.

    sy [nbh,nbw,8,8], su/sv [nbh,nbw,4,4] source blocks (any integer
    dtype, on the working device), or [S, ...] of each (the reference
    package's ``jax.vmap`` of the step: each diagonal codes the blocks
    of all S frames as one batch, so S frames cost the launches of one);
    qindex a Python int, shared by the batch.
    -> (modes [nbh,nbw] u8, levels_y [nbh,nbw,8,8] i16, levels_u,
        levels_v [nbh,nbw,4,4] i16, recon_y [nbh,nbw,8,8], recon_u,
        recon_v: u8 at 8 bits, i16 at 10 (MC.pixel_dtype)
        [, angle deltas [nbh,nbw] i8, uv modes u8, cfl alphas
        [nbh,nbw,2] i8 — rich]) — the reference's output tuple with
        dynamic-q dtypes; each with the leading [S] for a batch.
    rich=True (presets <= 5): the 61 luma candidates and the rich chroma
    pick (_chroma_search).
    """
    if sy.dim() == 4:
        return tuple(o[0] for o in frame_step(sy[None], su[None], sv[None],
                                              qindex, bd, rich))
    dev = sy.device
    S, nbh, nbw = sy.shape[:3]
    cands = _luma_cands(rich)
    ar_pad, bl_pad, mode_ids, deltas, d203 = _static_maps(nbh, nbw, dev,
                                                          rich)
    # staircase wavefront d = 2r + c: the above-right neighbor (r-1, c+1)
    # lands on d-1, so spec-available above-right rows are real recon
    B = min(nbh, (nbw + 1) // 2)
    ndiag = 2 * nbh + nbw - 2
    sy = sy.to(torch.int32)
    su = su.to(torch.int32)
    sv = sv.to(torch.int32)
    z = lambda bs: torch.zeros((S, nbh + 1, nbw + 1, bs, bs),
                               dtype=torch.int32, device=dev)
    ry, ru, rv = z(LUMA_BS), z(CHROMA_BS), z(CHROMA_BS)
    ly, lu, lv = z(LUMA_BS), z(CHROMA_BS), z(CHROMA_BS)
    grid = lambda *tail: torch.zeros((S, nbh + 1, nbw + 1, *tail),
                                     dtype=torch.int32, device=dev)
    modes, angles, uvm, cfl = grid(), grid(), grid(), grid(2)
    ar_b = torch.arange(B, device=dev)
    # the diagonal's lanes of every frame as one batch: [S, B, ...] ->
    # [S*B, ...], a per-lane mask [B] repeated for each frame
    flat = lambda a: a.reshape(S * B, *a.shape[2:])
    lanes = lambda m: m.expand(S, B).reshape(S * B)
    unflat = lambda a: a.reshape(S, B, *a.shape[1:])

    for d in range(ndiag):
        r = max(0, (d - nbw + 2) // 2) + ar_b
        c = d - 2 * r
        valid = (r < nbh) & (c >= 0) & (c < nbw)
        rs = torch.where(valid, r, nbh)
        cs = torch.where(valid, c, nbw)
        ha = (r > 0) & valid
        hl = (c > 0) & valid
        r_up = torch.where(ha, rs - 1, nbh)
        c_lf = torch.where(hl, cs - 1, nbw)
        rc = torch.clamp(rs, max=nbh - 1)   # clamped src gather
        cc = torch.clamp(cs, max=nbw - 1)
        ha_l, hl_l = lanes(ha), lanes(hl)

        # ---- luma: mode decision over all candidates ----
        above = flat(ry[:, r_up, cs, LUMA_BS - 1, :])
        left = flat(ry[:, rs, c_lf, :, LUMA_BS - 1])
        topleft = flat(ry[:, r_up, c_lf, LUMA_BS - 1, LUMA_BS - 1])
        ar_avail = ar_pad[rs, cs]
        bl_avail = lanes(bl_pad[rs, cs])
        c_ar = torch.where(ar_avail, torch.clamp(cs + 1, max=nbw), nbw)
        above_ext = flat(ry[:, r_up, c_ar, LUMA_BS - 1, :])
        preds = intra.predict_all_modes(
            above, left, topleft, ha_l, hl_l, LUMA_BS, LUMA_BS, bd,
            modes=cands, above_ext=above_ext, ar_avail=lanes(ar_avail))
        src = flat(sy[:, rc, cc])
        sse = ((preds - src[:, None]) ** 2).sum((-1, -2), dtype=torch.int32)
        # D203 (all deltas) reads below-left pixels the wavefront cannot
        # provide where the spec makes them available: exclude it there
        sse = sse + (d203[None, :] & bl_avail[:, None]).to(torch.int32) \
            * (1 << 30)
        best = torch.argmin(sse, dim=1)
        pred = preds[torch.arange(preds.shape[0], device=dev), best]
        lvls, recon = _encode_plane_batch(src, pred, qindex, T.TX_8X8, bd)
        ry[:, rs, cs] = unflat(recon)
        ly[:, rs, cs] = unflat(lvls)
        modes[:, rs, cs] = unflat(mode_ids[best])

        # ---- chroma: DC with its DCT, or the rich joint U+V pick ----
        cps = []
        for rp in (ru, rv):
            cps.append(intra.predict_all_modes(
                flat(rp[:, r_up, cs, CHROMA_BS - 1, :]),
                flat(rp[:, rs, c_lf, :, CHROMA_BS - 1]),
                flat(rp[:, r_up, c_lf, CHROMA_BS - 1, CHROMA_BS - 1]),
                ha_l, hl_l, CHROMA_BS, CHROMA_BS, bd,
                modes=UV_MODES if rich else (intra.DC,)))
        su_b, sv_b = flat(su[:, rc, cc]), flat(sv[:, rc, cc])
        if rich:
            angles[:, rs, cs] = unflat(deltas[best])
            (uv_sel, lu_, ru_, lv_, rv_, _, _, a_u,
             a_v) = _chroma_search(su_b, sv_b, cps[0], cps[1], recon,
                                   qindex, T.TX_4X4, bd)
            uvm[:, rs, cs] = unflat(uv_sel)
            cfl[:, rs, cs] = unflat(torch.stack([a_u, a_v], -1))
        else:
            lu_, ru_ = _encode_plane_batch(su_b, cps[0][:, 0], qindex,
                                           T.TX_4X4, bd)
            lv_, rv_ = _encode_plane_batch(sv_b, cps[1][:, 0], qindex,
                                           T.TX_4X4, bd)
        ru[:, rs, cs] = unflat(ru_)
        lu[:, rs, cs] = unflat(lu_)
        rv[:, rs, cs] = unflat(rv_)
        lv[:, rs, cs] = unflat(lv_)

    trim = lambda a: a[:, :nbh, :nbw]
    px = MC.pixel_dtype(bd)
    out = (trim(modes).to(torch.uint8),
           trim(ly).to(torch.int16), trim(lu).to(torch.int16),
           trim(lv).to(torch.int16),
           trim(ry).to(px), trim(ru).to(px), trim(rv).to(px))
    if rich:
        out = out + (trim(angles).to(torch.int8), trim(uvm).to(torch.uint8),
                     trim(cfl).to(torch.int8))
    return out


# --- multi-size keyframe wavefront (presets 6-7) ----------------------------
# Per-leaf overheads of the in-loop partition RD select (J = SSE +
# lambda * bits, the inter RD merge's lambda model), from the default CDF
# tables (pipeline/rdo.py): intra leaf = skip + expected kf-y-mode +
# uv-mode entropy; partition symbols from the size-16 / size-8 rows.
MODE_BITS_I = RDO.intra_leaf_bits()
PART_NONE_I = RDO.partition_bits()[8][0]
PART_SPLIT_I = RDO.partition_bits()[16][1]
_PART_NONE16_I = RDO.partition_bits()[16][0]


@functools.lru_cache(maxsize=8)
def _static_maps16(nbh: int, nbw: int, device: torch.device):
    """The 16x16-unit wavefront's tables on ``device``: 8x8 above-right
    / below-left availability, the unit grid's (its above-right only
    where the whole 16px strip exists: partial strips would need the
    spec's numTopRight replication), and the units that lie wholly
    inside the block grid (the only ones a 16x16 leaf may take); each
    padded with an invalid row/col."""
    nuh, nuw = -(-nbh // 2), -(-nbw // 2)
    ar8, bl8 = intra.edge_availability(nbh, nbw)
    arU, blU = intra.edge_availability(nuh, nuw, per_sb=4)
    legal = np.zeros((nuh, nuw), bool)
    legal[: nbh // 2, : nbw // 2] = True
    strip = np.zeros((nuh, nuw), bool)
    for ci in range(nuw):
        strip[:, ci] = (2 * ci + 3) < nbw

    def pad(t):
        p = np.zeros((t.shape[0] + 1, t.shape[1] + 1), bool)
        p[: t.shape[0], : t.shape[1]] = t
        return torch.as_tensor(p, device=device)

    return pad(ar8), pad(bl8), pad(arU & strip), pad(blU), pad(legal)


def _rd_cost(sse, bits_f32, lam: float):
    """J = float32(sse) + lam * bits as XLA:CPU evaluates it (one fused
    multiply-add; pipeline/rdo.fma_f32)."""
    return RDO.fma_f32(lam, bits_f32, sse.to(torch.float32))


def frame_step16(sy, su, sv, qindex: int, bd: int = 8, rich: bool = False):
    """16x16-unit keyframe wavefront with the in-loop RD partition
    select of the RD presets (port of the reference package's
    frame_step16).

    Each staircase diagonal of 16x16 units runs five batched encodes:
    the four 8x8 sub-blocks in z-order (each the frame_step body: all 13
    luma modes, DC chroma) and the whole 16x16 block (TX_16X16 luma /
    TX_8X8 chroma); a unit keeps the 16x16 block where its J is at most
    the four sub-blocks' J plus the split overhead, and the unit lies
    inside the block grid.  J = SSE (all planes) + lambda * bits in
    float32, evaluated as the reference does (pipeline/rdo.py).

    rich=True (presets <= 5): every block searches the 61 luma
    candidates and the rich chroma set (_chroma_search; its coefficient
    bits join J).

    sy [nbh,nbw,8,8], su/sv [nbh,nbw,4,4] source blocks; qindex a Python
    int.  -> frame_step's tuple + (angle deltas [nbh,nbw] i8, uv modes
    u8, cfl alphas [nbh,nbw,2] i8 (0 / DC / 0 without rich), sizes
    [nbh,nbw] u8 (8 or 16 per 8x8 cell), levels16_y [nuh,nuw,16,16] i16,
    levels16_u / levels16_v [nuh,nuw,8,8] i16 (zero where the unit
    split)) — the reference's dynamic-q output tuple.
    """
    dev = sy.device
    nbh, nbw = sy.shape[:2]
    nuh, nuw = -(-nbh // 2), -(-nbw // 2)
    BU = min(nuh, (nuw + 1) // 2)
    ndiag = 2 * nuh + nuw - 2
    cands = _luma_cands(rich)
    uv_cands = UV_MODES if rich else (intra.DC,)
    _, _, mode_ids, deltas, d203 = _static_maps(nbh, nbw, dev, rich)
    ar8_pad, bl8_pad, arU_pad, blU_pad, legal_pad = _static_maps16(
        nbh, nbw, dev)
    ac = int(_tbl.spec_tables()[f"ac_qlookup_{bd}"][qindex])
    lam = float(max(4, (ac * ac) >> 8))            # exact in float32
    split_j = RDO.scalar_product_f32(lam, PART_SPLIT_I + 4 * PART_NONE_I)
    mode_f = RDO.f32_scalar(MODE_BITS_I)
    none16_f = RDO.f32_scalar(_PART_NONE16_I)

    sy = sy.to(torch.int32)
    su = su.to(torch.int32)
    sv = sv.to(torch.int32)
    z = lambda h, w, bs: torch.zeros((h + 1, w + 1, bs, bs),
                                     dtype=torch.int32, device=dev)
    ry, ru, rv = z(nbh, nbw, LUMA_BS), z(nbh, nbw, CHROMA_BS), \
        z(nbh, nbw, CHROMA_BS)
    ly8, lu8, lv8 = z(nbh, nbw, LUMA_BS), z(nbh, nbw, CHROMA_BS), \
        z(nbh, nbw, CHROMA_BS)
    ly16, lu16, lv16 = z(nuh, nuw, 16), z(nuh, nuw, 8), z(nuh, nuw, 8)
    grid = lambda *tail: torch.zeros((nbh + 1, nbw + 1, *tail),
                                     dtype=torch.int32, device=dev)
    modes, angles, cfl = grid(), grid(), grid(2)
    uvm = torch.full((nbh + 1, nbw + 1), intra.DC, dtype=torch.int32,
                     device=dev)
    size8 = torch.full((nbh + 1, nbw + 1), 8, dtype=torch.int32, device=dev)
    ar_u = torch.arange(BU, device=dev)
    zero_f = torch.zeros((BU,), dtype=torch.float32, device=dev)

    def chroma(su_b, sv_b, cp_u, cp_v, rec_y, tx_c):
        """The chroma of a block batch: DC (the one uv candidate without
        the rich set), or the rich pick.  Returns (uv mode, U levels, U
        recon, V levels, V recon, SSE, coefficient bits, CFL alphas
        [B, 2])."""
        if rich:
            out = _chroma_search(su_b, sv_b, cp_u, cp_v, rec_y, qindex,
                                 tx_c, bd)
            return out[:7] + (torch.stack(out[7:], -1),)
        lu_, ru_ = _encode_plane_batch(su_b, cp_u[:, 0], qindex, tx_c, bd)
        lv_, rv_ = _encode_plane_batch(sv_b, cp_v[:, 0], qindex, tx_c, bd)
        sse = (((su_b - ru_) ** 2).sum((-1, -2), dtype=torch.int32)
               + ((sv_b - rv_) ** 2).sum((-1, -2), dtype=torch.int32))
        return (intra.DC, lu_, ru_, lv_, rv_, sse,
                _coeff_bits(lu_) + _coeff_bits(lv_), 0)

    def luma_pick(preds, src, bl_avail):
        sse = ((preds - src[:, None]) ** 2).sum((-1, -2), dtype=torch.int32)
        sse = sse + (d203[None, :] & bl_avail[:, None]).to(torch.int32) \
            * (1 << 30)
        best = torch.argmin(sse, dim=1)
        return best, preds[torch.arange(preds.shape[0], device=dev), best]

    def enc8(rb, cb, valid_s):
        """One 8x8 sub-block batch (the frame_step body at the given
        coordinates); updates the state, returns the lanes' J."""
        ha = (rb < nbh) & (rb > 0) & valid_s
        hl = (cb < nbw) & (cb > 0) & valid_s
        r_up = torch.where(ha, rb - 1, nbh)
        c_lf = torch.where(hl, cb - 1, nbw)
        rc = torch.clamp(rb, max=nbh - 1)
        cc = torch.clamp(cb, max=nbw - 1)
        ar_avail = ar8_pad[rb, cb]
        c_ar = torch.where(ar_avail, torch.clamp(cb + 1, max=nbw), nbw)
        preds = intra.predict_all_modes(
            ry[r_up, cb, LUMA_BS - 1, :], ry[rb, c_lf, :, LUMA_BS - 1],
            ry[r_up, c_lf, LUMA_BS - 1, LUMA_BS - 1], ha, hl, LUMA_BS,
            LUMA_BS, bd, modes=cands,
            above_ext=ry[r_up, c_ar, LUMA_BS - 1, :], ar_avail=ar_avail)
        src = sy[rc, cc]
        best, pred = luma_pick(preds, src, bl8_pad[rb, cb])
        lvls, recon = _encode_plane_batch(src, pred, qindex, T.TX_8X8, bd)
        ry[rb, cb] = recon
        ly8[rb, cb] = lvls
        modes[rb, cb] = mode_ids[best]
        angles[rb, cb] = deltas[best]
        size8[rb, cb] = 8
        cp = [intra.predict_all_modes(
            rp[r_up, cb, CHROMA_BS - 1, :], rp[rb, c_lf, :, CHROMA_BS - 1],
            rp[r_up, c_lf, CHROMA_BS - 1, CHROMA_BS - 1], ha, hl,
            CHROMA_BS, CHROMA_BS, bd, modes=uv_cands)
            for rp in (ru, rv)]
        uv_, lu_, ru_, lv_, rv_, sse_c, bits_c, cfl_ = chroma(
            su[rc, cc], sv[rc, cc], cp[0], cp[1], recon, T.TX_4X4)
        uvm[rb, cb] = uv_
        cfl[rb, cb] = cfl_
        ru[rb, cb] = ru_
        lu8[rb, cb] = lu_
        rv[rb, cb] = rv_
        lv8[rb, cb] = lv_
        sse_y = ((src - recon) ** 2).sum((-1, -2), dtype=torch.int32)
        bits = (_coeff_bits(lvls) + bits_c).to(torch.float32) + mode_f
        return _rd_cost(sse_y + sse_c, bits, lam)

    def asm(g, ra, rb_, ca, cb_):
        top = torch.cat([g[ra, ca], g[ra, cb_]], -1)
        bot = torch.cat([g[rb_, ca], g[rb_, cb_]], -1)
        return torch.cat([top, bot], -2)

    for d in range(ndiag):
        R = max(0, (d - nuw + 2) // 2) + ar_u
        C = d - 2 * R
        valid_u = (R < nuh) & (C >= 0) & (C < nuw)
        Ru = torch.where(valid_u, R, nuh)
        Cu = torch.where(valid_u, C, nuw)
        r0 = torch.where(valid_u, R * 2, nbh)
        c0 = torch.where(valid_u, C * 2, nbw)

        # ---- four 8x8 sub-blocks in z-order ----
        J8 = zero_f
        subs = []
        for (i, j) in ((0, 0), (0, 1), (1, 0), (1, 1)):
            valid_s = valid_u & (R * 2 + i < nbh) & (C * 2 + j < nbw)
            rb = torch.where(valid_s, r0 + i, nbh)
            cb = torch.where(valid_s, c0 + j, nbw)
            J8 = J8 + torch.where(valid_s, enc8(rb, cb, valid_s), 0.0)
            subs.append((rb, cb))
        J8 = J8 + split_j

        # ---- the 16x16 candidate ----
        ha = (R > 0) & valid_u
        hl = (C > 0) & valid_u
        rup = torch.where(ha, r0 - 1, nbh)
        clf = torch.where(hl, c0 - 1, nbw)
        r1 = torch.clamp(r0 + 1, max=nbh)
        c1 = torch.clamp(c0 + 1, max=nbw)
        arU = arU_pad[Ru, Cu]
        c_ar0 = torch.where(arU, torch.clamp(c0 + 2, max=nbw), nbw)
        c_ar1 = torch.where(arU, torch.clamp(c0 + 3, max=nbw), nbw)
        preds16 = intra.predict_all_modes(
            torch.cat([ry[rup, c0, LUMA_BS - 1, :],
                       ry[rup, c1, LUMA_BS - 1, :]], -1),
            torch.cat([ry[r0, clf, :, LUMA_BS - 1],
                       ry[r1, clf, :, LUMA_BS - 1]], -1),
            ry[rup, clf, LUMA_BS - 1, LUMA_BS - 1], ha, hl, 16, 16, bd,
            modes=cands,
            above_ext=torch.cat([ry[rup, c_ar0, LUMA_BS - 1, :],
                                 ry[rup, c_ar1, LUMA_BS - 1, :]], -1),
            ar_avail=arU)
        rc0 = torch.clamp(r0, max=nbh - 1)
        cc0 = torch.clamp(c0, max=nbw - 1)
        rc1 = torch.clamp(r0 + 1, max=nbh - 1)
        cc1 = torch.clamp(c0 + 1, max=nbw - 1)
        src16 = asm(sy, rc0, rc1, cc0, cc1)
        best16, pred16 = luma_pick(preds16, src16, blU_pad[Ru, Cu])
        l16y, rec16y = _encode_plane_batch(src16, pred16, qindex,
                                           T.TX_16X16, bd)
        m16 = mode_ids[best16]
        a16 = deltas[best16]
        cp16 = []
        for rp in (ru, rv):
            cp16.append(intra.predict_all_modes(
                torch.cat([rp[rup, c0, CHROMA_BS - 1, :],
                           rp[rup, c1, CHROMA_BS - 1, :]], -1),
                torch.cat([rp[r0, clf, :, CHROMA_BS - 1],
                           rp[r1, clf, :, CHROMA_BS - 1]], -1),
                rp[rup, clf, CHROMA_BS - 1, CHROMA_BS - 1], ha, hl, 8, 8,
                bd, modes=uv_cands))
        uv16, l16u, r16u, l16v, r16v, sse_c16, bits_c16, cfl16 = chroma(
            asm(su, rc0, rc1, cc0, cc1), asm(sv, rc0, rc1, cc0, cc1),
            cp16[0], cp16[1], rec16y, T.TX_8X8)
        sse_y16 = ((src16 - rec16y) ** 2).sum((-1, -2), dtype=torch.int32)
        bits16 = ((_coeff_bits(l16y) + bits_c16).to(torch.float32)
                  + mode_f) + none16_f
        J16 = _rd_cost(sse_y16 + sse_c16, bits16, lam)
        use16 = legal_pad[Ru, Cu] & valid_u & (J16 <= J8)

        # ---- writeback: the 16x16 block's cells where it wins ----
        w = use16[:, None, None]
        for k, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            rb, cb = subs[k]
            ry[rb, cb] = torch.where(
                w, rec16y[:, i * 8: i * 8 + 8, j * 8: j * 8 + 8], ry[rb, cb])
            ru[rb, cb] = torch.where(
                w, r16u[:, i * 4: i * 4 + 4, j * 4: j * 4 + 4], ru[rb, cb])
            rv[rb, cb] = torch.where(
                w, r16v[:, i * 4: i * 4 + 4, j * 4: j * 4 + 4], rv[rb, cb])
            modes[rb, cb] = torch.where(use16, m16, modes[rb, cb])
            size8[rb, cb] = torch.where(use16, 16, size8[rb, cb])
            if rich:
                angles[rb, cb] = torch.where(use16, a16, angles[rb, cb])
                uvm[rb, cb] = torch.where(use16, uv16, uvm[rb, cb])
                cfl[rb, cb] = torch.where(use16[:, None], cfl16,
                                          cfl[rb, cb])
        ly16[Ru, Cu] = torch.where(w, l16y, 0)
        lu16[Ru, Cu] = torch.where(w, l16u, 0)
        lv16[Ru, Cu] = torch.where(w, l16v, 0)

    trim = lambda a: a[:nbh, :nbw]
    trimu = lambda a: a[:nuh, :nuw]
    px = MC.pixel_dtype(bd)
    return (trim(modes).to(torch.uint8),
            trim(ly8).to(torch.int16), trim(lu8).to(torch.int16),
            trim(lv8).to(torch.int16),
            trim(ry).to(px), trim(ru).to(px), trim(rv).to(px),
            trim(angles).to(torch.int8), trim(uvm).to(torch.uint8),
            trim(cfl).to(torch.int8),
            trim(size8).to(torch.uint8),
            trimu(ly16).to(torch.int16), trimu(lu16).to(torch.int16),
            trimu(lv16).to(torch.int16))


def block_planes(plane, bs: int):
    """[..., H, W] -> [..., H/bs, W/bs, bs, bs] block grid (numpy or
    torch; leading frame dims pass through)."""
    *lead, h, w = plane.shape
    if h % bs or w % bs:
        raise ValueError(f"plane {h}x{w} is not a multiple of {bs}")
    b = plane.reshape(*lead, h // bs, bs, w // bs, bs)
    return b.transpose(-3, -2) if isinstance(b, torch.Tensor) \
        else b.swapaxes(-3, -2)


def unblock_planes(blocks):
    """[..., nbh, nbw, bs, bs] -> [..., H, W] (numpy or torch)."""
    *lead, nbh, nbw, bs, _ = blocks.shape
    b = blocks.transpose(-3, -2) if isinstance(blocks, torch.Tensor) \
        else blocks.swapaxes(-3, -2)
    return b.reshape(*lead, nbh * bs, nbw * bs)


def pad_plane(plane: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Edge-replicate pad (ref PadPictureToMultipleOfLcuDimensions)."""
    h, w = plane.shape
    return np.pad(plane, ((0, target_h - h), (0, target_w - w)), mode="edge")
