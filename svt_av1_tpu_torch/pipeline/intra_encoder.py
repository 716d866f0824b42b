"""Intra frame encoder in PyTorch: wavefront sweeps of batched blocks.

Port of svt_av1_tpu/pipeline/intra_encoder.py (``frame_step`` with
rich=False, ibc=False: preset 8, uniform 8x8 luma / 4x4 chroma blocks,
13 base luma modes, DC chroma, DCT residuals).

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

from svt_av1_tpu_torch.ops import intra
from svt_av1_tpu_torch.ops import quant as Q
from svt_av1_tpu_torch.ops import transforms as T

LUMA_BS = 8
CHROMA_BS = 4


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
def _static_maps(nbh: int, nbw: int, device: torch.device):
    """Above-right / below-left availability (padded with an invalid
    row/col) and the candidate tables, as tensors on ``device``."""
    ar_avail_np, bl_avail_np = intra.edge_availability(nbh, nbw)
    ar_pad = np.zeros((nbh + 1, nbw + 1), bool)
    ar_pad[:nbh, :nbw] = ar_avail_np
    bl_pad = np.zeros((nbh + 1, nbw + 1), bool)
    bl_pad[:nbh, :nbw] = bl_avail_np
    mode_ids, _deltas, d203 = _cand_tables(tuple(intra.ALL_MODES))
    t = lambda a: torch.as_tensor(a, device=device)
    return t(ar_pad), t(bl_pad), t(mode_ids), t(d203)


def frame_step(sy, su, sv, qindex: int, bd: int = 8):
    """Full-frame intra encode of a block grid.

    sy [nbh,nbw,8,8], su/sv [nbh,nbw,4,4] source blocks (any integer
    dtype, on the working device); qindex a Python int.
    -> (modes [nbh,nbw] u8, levels_y [nbh,nbw,8,8] i16, levels_u,
        levels_v [nbh,nbw,4,4] i16, recon_y [nbh,nbw,8,8] u8, recon_u,
        recon_v) — the reference's output tuple with dynamic-q dtypes.
    """
    if bd != 8:
        raise NotImplementedError("bit_depth=10 is not ported")
    dev = sy.device
    nbh, nbw = sy.shape[:2]
    cands = tuple(intra.ALL_MODES)
    ar_pad, bl_pad, mode_ids, d203 = _static_maps(nbh, nbw, dev)
    # staircase wavefront d = 2r + c: the above-right neighbor (r-1, c+1)
    # lands on d-1, so spec-available above-right rows are real recon
    B = min(nbh, (nbw + 1) // 2)
    ndiag = 2 * nbh + nbw - 2
    sy = sy.to(torch.int32)
    su = su.to(torch.int32)
    sv = sv.to(torch.int32)
    z = lambda bs: torch.zeros((nbh + 1, nbw + 1, bs, bs), dtype=torch.int32,
                               device=dev)
    ry, ru, rv = z(LUMA_BS), z(CHROMA_BS), z(CHROMA_BS)
    ly, lu, lv = z(LUMA_BS), z(CHROMA_BS), z(CHROMA_BS)
    modes = torch.zeros((nbh + 1, nbw + 1), dtype=torch.int32, device=dev)
    ar_b = torch.arange(B, device=dev)

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

        # ---- luma: mode decision over all candidates ----
        above = ry[r_up, cs, LUMA_BS - 1, :]
        left = ry[rs, c_lf, :, LUMA_BS - 1]
        topleft = ry[r_up, c_lf, LUMA_BS - 1, LUMA_BS - 1]
        ar_avail = ar_pad[rs, cs]
        bl_avail = bl_pad[rs, cs]
        c_ar = torch.where(ar_avail, torch.clamp(cs + 1, max=nbw), nbw)
        above_ext = ry[r_up, c_ar, LUMA_BS - 1, :]
        preds = intra.predict_all_modes(
            above, left, topleft, ha, hl, LUMA_BS, LUMA_BS, bd,
            modes=cands, above_ext=above_ext, ar_avail=ar_avail)
        src = sy[rc, cc]
        sse = ((preds - src[:, None]) ** 2).sum((-1, -2), dtype=torch.int32)
        # D203 reads below-left pixels the wavefront cannot provide where
        # the spec makes them available: exclude it there
        sse = sse + (d203[None, :] & bl_avail[:, None]).to(torch.int32) \
            * (1 << 30)
        best = torch.argmin(sse, dim=1)
        pred = preds[torch.arange(preds.shape[0], device=dev), best]
        lvls, recon = _encode_plane_batch(src, pred, qindex, T.TX_8X8, bd)
        ry[rs, cs] = recon
        ly[rs, cs] = lvls
        modes[rs, cs] = mode_ids[best]

        # ---- chroma: DC prediction, derived DCT ----
        for rp, lp, sp in ((ru, lu, su), (rv, lv, sv)):
            above_c = rp[r_up, cs, CHROMA_BS - 1, :]
            left_c = rp[rs, c_lf, :, CHROMA_BS - 1]
            tl_c = rp[r_up, c_lf, CHROMA_BS - 1, CHROMA_BS - 1]
            cpred = intra.predict_all_modes(
                above_c, left_c, tl_c, ha, hl, CHROMA_BS, CHROMA_BS, bd,
                modes=(intra.DC,))[:, 0]
            lc, rec_c = _encode_plane_batch(sp[rc, cc], cpred, qindex,
                                            T.TX_4X4, bd, T.DCT_DCT)
            rp[rs, cs] = rec_c
            lp[rs, cs] = lc

    trim = lambda a: a[:nbh, :nbw]
    return (trim(modes).to(torch.uint8),
            trim(ly).to(torch.int16), trim(lu).to(torch.int16),
            trim(lv).to(torch.int16),
            trim(ry).to(torch.uint8), trim(ru).to(torch.uint8),
            trim(rv).to(torch.uint8))


def block_planes(plane, bs: int):
    """[H, W] -> [H/bs, W/bs, bs, bs] block grid (numpy or torch)."""
    h, w = plane.shape
    if h % bs or w % bs:
        raise ValueError(f"plane {h}x{w} is not a multiple of {bs}")
    b = plane.reshape(h // bs, bs, w // bs, bs)
    return b.transpose(1, 2) if isinstance(b, torch.Tensor) \
        else b.transpose(0, 2, 1, 3)


def unblock_planes(blocks):
    """[nbh, nbw, bs, bs] -> [H, W] (numpy or torch)."""
    nbh, nbw, bs, _ = blocks.shape
    b = blocks.transpose(1, 2) if isinstance(blocks, torch.Tensor) \
        else blocks.transpose(0, 2, 1, 3)
    return b.reshape(nbh * bs, nbw * bs)


def pad_plane(plane: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Edge-replicate pad (ref PadPictureToMultipleOfLcuDimensions)."""
    h, w = plane.shape
    return np.pad(plane, ((0, target_h - h), (0, target_w - w)), mode="edge")
