"""Intra prediction in PyTorch (port of svt_av1_tpu/ops/intra.py).

Full AV1 base-mode set (spec §7.11.2): DC, V, H, the six directional
base angles (D45/D67/D113/D135/D157/D203, angle delta 0; the sequence
header signals enable_intra_edge_filter=0 so no edge filter/upsample),
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH.

Batched shape: predictions for a whole wavefront batch of same-size blocks
are computed for ALL candidate modes at once ([B, M, H, W]) and selected
by distortion — the reference's per-candidate fast loop
(perform_fast_loop, EbProductCodingLoop.c:1152) becomes one fused tensor
program.  Directional modes with a fixed angle have STATIC interpolation
index/weight tables (zone math from av1_dr_prediction_z1/z2/z3_c,
EbIntraPrediction.c:370-500), so they lower to gathers + multiplies.

Edge availability beyond the block (above-right / below-left rows)
follows the spec's BlockDecoded z-order rule (5.11.5); availability maps
are static for the uniform 8x8 grid and shared with the mirror decoder.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# spec Sm_Weights_Tx (indexed by block dim)
SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64], np.int32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], np.int32),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33,
                  26, 20, 17, 16], np.int32),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
                  101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14,
                  12, 10, 9, 8, 8], np.int32),
    64: np.array([255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176,
                  169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
                  101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44,
                  41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10,
                  9, 8, 7, 6, 6, 5, 5, 4, 4, 4], np.int32),
}

# mode ids (must match entropy.syntax enum)
DC, V, H = 0, 1, 2
D45, D135, D113, D157, D203, D67 = 3, 4, 5, 6, 7, 8
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = 9, 10, 11, 12
V1_MODES = (DC, V, H, SMOOTH, PAETH)
ALL_MODES = (DC, V, H, D45, D135, D113, D157, D203, D67,
             SMOOTH, SMOOTH_V, SMOOTH_H, PAETH)

# normative Dr_Intra_Derivative (spec; ref EbIntraPrediction.c:299) —
# only the angles reachable from base modes with delta 0
DR_DERIVATIVE = {23: 151, 45: 64, 67: 27}

# base angle per directional mode (spec Mode_To_Angle)
MODE_ANGLE = {V: 90, H: 180, D45: 45, D135: 135, D113: 113, D157: 157,
              D203: 203, D67: 67}


def _deriv(angle: int) -> int:
    table = {3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151,
             26: 132, 29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64,
             48: 57, 51: 51, 54: 45, 58: 40, 61: 35, 64: 31, 67: 27,
             70: 23, 73: 19, 76: 15, 81: 11, 84: 7, 87: 3}
    return table[angle]


@functools.lru_cache(maxsize=None)
def dir_tables(angle: int, h: int, w: int):
    """Static (use_above, idx, shift) tables for a fixed prediction
    angle (base mode angle + 3 * angle_delta; spec 7.11.2.4).

    idx indexes the concatenated edge array [topleft, edge[0..w+h-1]]
    (so stored index = spec base + 1); semantics are the C reference's
    av1_dr_prediction_z{1,2,3}_c with upsample 0.
    """
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    if angle < 90:                      # zone 1: above only
        dx = _deriv(angle)
        x = (r + 1) * dx + 0 * c
        base = (x >> 6) + c
        shift = (x & 63) >> 1
        max_base = w + h - 1
        clip = base >= max_base
        base = np.where(clip, max_base, base)
        shift = np.where(clip, 0, shift)
        return (np.ones((h, w), bool), (base + 1).astype(np.int32),
                shift.astype(np.int32))
    if angle > 180:                     # zone 3: left only
        dy = _deriv(270 - angle)
        y = (c + 1) * dy + 0 * r
        base = (y >> 6) + r
        shift = (y & 63) >> 1
        max_base = w + h - 1
        clip = base >= max_base
        base = np.where(clip, max_base, base)
        shift = np.where(clip, 0, shift)
        return (np.zeros((h, w), bool), (base + 1).astype(np.int32),
                shift.astype(np.int32))
    # zone 2: 90 < angle < 180, above for base1 >= -1, else left
    dx = _deriv(180 - angle)
    dy = _deriv(angle - 90)
    x = -(r + 1) * dx + 0 * c
    base1 = (x >> 6) + c
    shift1 = (x & 63) >> 1
    use_above = base1 >= -1
    y = (r << 6) - (c + 1) * dy
    base2 = y >> 6
    shift2 = (y & 63) >> 1
    idx = np.where(use_above, base1 + 1, base2 + 1)
    shift = np.where(use_above, shift1, shift2)
    return use_above, idx.astype(np.int32), shift.astype(np.int32)


def z_order(rr: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Z-scan index of 8x8-block coords within a 64px SB (3 bit pairs)."""
    z = np.zeros_like(rr)
    for k in range(3):
        z |= (((cc >> k) & 1) << (2 * k)) | (((rr >> k) & 1) << (2 * k + 1))
    return z


@functools.lru_cache(maxsize=None)
def edge_availability(nbh: int, nbw: int, per_sb: int = 8):
    """(above_right, below_left) static availability maps for a uniform
    square-block grid (spec BlockDecoded rule: decoded-earlier in Z
    order, with superblock-boundary guards).

    per_sb: blocks per 64px superblock side — 8 for the 8x8 grid, 4 for
    the 16x16 unit grid.  The z-order comparison is exact for MIXED
    partitions too: a merged parent covers a contiguous z-span, so
    per-position precedence equals whole-block precedence."""
    r = np.arange(nbh)[:, None] * np.ones((1, nbw), np.int64)
    c = np.ones((nbh, 1), np.int64) * np.arange(nbw)[None, :]
    rr = (r % per_sb).astype(np.int64)
    cc = (c % per_sb).astype(np.int64)
    z = z_order(rr, cc)

    in_ar = (r - 1 >= 0) & (c + 1 < nbw)
    same_sb_ar = z_order(rr - 1, cc + 1) < z
    ar = in_ar & (cc < per_sb - 1) & np.where(rr == 0, True, same_sb_ar)

    in_bl = (r + 1 < nbh) & (c - 1 >= 0)
    same_sb_bl = z_order(rr + 1, cc - 1) < z
    bl = in_bl & (rr < per_sb - 1) & np.where(cc == 0, True, same_sb_bl)

    ar.setflags(write=False)
    bl.setflags(write=False)
    return ar, bl


def prepare_edges(above, left, topleft, have_above, have_left, bd: int = 8):
    """Spec edge fill for batched blocks.

    above: [B, W], left: [B, H], topleft: [B], have_*: [B] bool.
    Returns filled (above, left, topleft) int32.
    """
    base = 1 << (bd - 1)
    ha = have_above[:, None]
    hl = have_left[:, None]
    above_f = torch.where(ha, above,
                          torch.where(hl, left[:, :1], base - 1))
    left_f = torch.where(hl, left,
                         torch.where(ha, above[:, :1], base + 1))
    tl = torch.where(have_above & have_left, topleft,
                     torch.where(have_above, above[:, 0],
                                 torch.where(have_left, left[:, 0], base)))
    return above_f, left_f, tl


@functools.lru_cache(maxsize=None)
def _dir_tables_on(angle: int, h: int, w: int, device: torch.device):
    use_above, idx, shift = dir_tables(angle, h, w)
    return (torch.as_tensor(use_above, device=device),
            torch.as_tensor(idx, dtype=torch.long, device=device),
            torch.as_tensor(np.minimum(idx + 1, w + h), dtype=torch.long,
                            device=device),
            torch.as_tensor(shift, device=device))


def predict_all_modes(above, left, topleft, have_above, have_left,
                      h: int, w: int, bd: int = 8, modes=V1_MODES,
                      above_ext=None, left_ext=None,
                      ar_avail=None, bl_avail=None):
    """Mode predictions for a batch: returns [B, len(modes), h, w] int32.

    above_ext [B, h] / left_ext [B, w]: raw above-right / below-left
    extension rows; used where ar_avail/bl_avail [B] say the spec makes
    them available, else the filled edge's last sample is replicated
    (spec intra edge preparation, numTopRight/numBottomLeft).
    """
    dev = above.device
    B = above.shape[0]
    above, left, tl = prepare_edges(above, left, topleft,
                                    have_above, have_left, bd)
    a = above[:, None, :]          # [B, 1, W]
    l = left[:, :, None]           # [B, H, 1]
    ones = torch.ones((B, h, w), dtype=torch.int32, device=dev)

    def _md(m):
        return (m[0], m[1]) if isinstance(m, tuple) else (m, 0)

    need_dir = any(mm in MODE_ANGLE and (mm not in (V, H) or d != 0)
                   for mm, d in (_md(m) for m in modes))
    if need_dir:
        rep_a = above[:, -1:].expand(B, h)
        rep_l = left[:, -1:].expand(B, w)
        if above_ext is None or ar_avail is None:
            above_ext = rep_a
        else:
            above_ext = torch.where(ar_avail[:, None], above_ext, rep_a)
        if left_ext is None or bl_avail is None:
            left_ext = rep_l
        else:
            left_ext = torch.where(bl_avail[:, None], left_ext, rep_l)
        cat_above = torch.cat([tl[:, None], above, above_ext], dim=1)
        cat_left = torch.cat([tl[:, None], left, left_ext], dim=1)

    sm_h = torch.as_tensor(SM_WEIGHTS[h], device=dev)
    sm_w = torch.as_tensor(SM_WEIGHTS[w], device=dev)
    out = []
    for m in modes:
        delta = 0
        if isinstance(m, tuple):
            m, delta = m
        if m == DC:
            s_a = above.sum(dim=1, dtype=torch.int32)
            s_l = left.sum(dim=1, dtype=torch.int32)
            both = have_above & have_left
            dc = torch.where(
                both, (s_a + s_l + ((w + h) >> 1)) // (w + h),
                torch.where(have_above,
                            (s_a + (w >> 1)) >> int(np.log2(w)),
                            torch.where(have_left,
                                        (s_l + (h >> 1)) >> int(np.log2(h)),
                                        1 << (bd - 1))))
            out.append(dc[:, None, None] * ones)
        elif m == V and delta == 0:
            out.append(a * ones)
        elif m == H and delta == 0:
            out.append(l * ones)
        elif m == SMOOTH:
            wy = sm_h[None, :, None]
            wx = sm_w[None, None, :]
            below = left[:, -1][:, None, None]
            right = above[:, -1][:, None, None]
            out.append((wy * a + (256 - wy) * below + wx * l
                        + (256 - wx) * right + 256) >> 9)
        elif m == SMOOTH_V:
            wy = sm_h[None, :, None]
            below = left[:, -1][:, None, None]
            out.append((wy * a + (256 - wy) * below + 128) >> 8)
        elif m == SMOOTH_H:
            wx = sm_w[None, None, :]
            right = above[:, -1][:, None, None]
            out.append((wx * l + (256 - wx) * right + 128) >> 8)
        elif m == PAETH:
            tl3 = tl[:, None, None]
            base = a + l - tl3
            pa = (base - a).abs()
            pl = (base - l).abs()
            ptl = (base - tl3).abs()
            out.append(torch.where((pl <= pa) & (pl <= ptl), l * ones,
                                   torch.where(pa <= ptl, a * ones,
                                               tl3 * ones)))
        else:  # directional angle (base + 3*delta)
            use_above, idx, idx1, shift = _dir_tables_on(
                MODE_ANGLE[m] + 3 * delta, h, w, dev)
            src = torch.where(use_above[None], cat_above[:, idx],
                              cat_left[:, idx])
            src1 = torch.where(use_above[None], cat_above[:, idx1],
                               cat_left[:, idx1])
            sh = shift[None]
            out.append((src * (32 - sh) + src1 * sh + 16) >> 5)
    return torch.stack(out, dim=1).to(torch.int32)
