"""CDEF (constrained directional enhancement filter) in PyTorch.

Port of svt_av1_tpu/ops/cdef.py (encoder side: direction search, the
filter, and the per-64x64 strength search).  Exact integer arithmetic of
the reference kernels (cdef_find_dir_c, EbCdef.c:129; cdef_filter_block_c
:204; constrain :101):

- direction search: each 8x8 block's eight partial-sum families are
  integer scatter-adds of its pixels into static bins (``index_add_``),
  not the reference package's int32 einsum — CUDA has no integer matmul;
- filter: the per-pixel taps are statically shifted planes selected by
  direction; every unit reads only PRE-CDEF pixels, so the whole plane
  filters in one pass;
- out-of-frame samples are CDEF_VERY_LARGE, which self-masks in
  constrain() and is excluded from the min/max clamp.

Planes and maps may carry leading frame dims ([..., H, W]): a batched
step filters S frames at once, and the strength search still picks per
frame and per 64x64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

VERY_LARGE = 30000
PRI_TAPS = ((4, 2), (3, 3))   # indexed by pri_strength & 1
SEC_TAPS = (2, 1)
# (dy, dx) per direction, k = 0 (near) / 1 (far); ref cdef_directions
DIRS = np.array([
    [[-1, 1], [-2, 2]],
    [[0, 1], [-1, 2]],
    [[0, 1], [0, 2]],
    [[0, 1], [1, 2]],
    [[1, 1], [2, 2]],
    [[1, 0], [2, 1]],
    [[1, 0], [2, 0]],
    [[1, 0], [2, -1]],
], np.int32)

_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)

# fixed frame strength lists (signaled in the frame header; cdef_bits=2).
# Index 0 must be (0,0) so all-flat superblocks can opt out cheaply.
Y_STRENGTHS = ((0, 0), (3, 1), (7, 2), (12, 2))
UV_STRENGTHS = ((0, 0), (2, 1), (4, 1), (6, 2))
CDEF_BITS = 2


@functools.lru_cache(maxsize=1)
def _partial_bins() -> np.ndarray:
    """[8 families][64 pixels] bin index of each pixel of an 8x8 block
    (the reference's partial-sum masks, one bin per pixel and family)."""
    b = np.zeros((8, 8, 8), np.int64)
    for i in range(8):
        for j in range(8):
            b[0, i, j] = i + j
            b[1, i, j] = i + j // 2
            b[2, i, j] = i
            b[3, i, j] = 3 + i - j // 2
            b[4, i, j] = 7 + i - j
            b[5, i, j] = 3 - i // 2 + j
            b[6, i, j] = j
            b[7, i, j] = i // 2 + j
    return b.reshape(8, 64)


@functools.lru_cache(maxsize=None)
def _bins_on(device: torch.device):
    return torch.as_tensor(_partial_bins(), device=device)


def find_dir_grid(luma, coeff_shift: int = 0):
    """Per-8x8-block (direction, variance) over a whole plane.

    luma: [..., H, W] int32 (H, W multiples of 8).  Returns (dir
    [..., h8, w8], var [..., h8, w8]) int32 — exact cdef_find_dir_c
    semantics (x = (img >> coeff_shift) - 128, EbCdef.c:146)."""
    *lead, H, W = luma.shape
    h8, w8 = H // 8, W // 8
    x = ((luma.reshape(*lead, h8, 8, w8, 8).transpose(-3, -2)
          .reshape(-1, 64).to(torch.int32) >> coeff_shift) - 128)
    bins = _bins_on(luma.device)
    # partial[f][:, b] = sum of the block's pixels in bin b of family f
    # (integer adds: exact in any order)
    p = []
    for f in range(8):
        acc = torch.zeros((x.shape[0], 15), dtype=torch.int32,
                          device=luma.device)
        p.append(acc.index_add_(1, bins[f], x).reshape(*lead, h8, w8, 15))

    div = _DIV_TABLE
    cost = [None] * 8
    for d in (2, 6):
        cost[d] = (p[d][..., :8] ** 2).sum(-1, dtype=torch.int32) * div[8]
    for d in (0, 4):
        c = torch.zeros_like(cost[2])
        for i in range(7):
            c = c + (p[d][..., i] ** 2 + p[d][..., 14 - i] ** 2) * div[i + 1]
        cost[d] = c + p[d][..., 7] ** 2 * div[8]
    for d in (1, 3, 5, 7):
        c = (p[d][..., 3:8] ** 2).sum(-1, dtype=torch.int32) * div[8]
        for j in range(3):
            c = c + (p[d][..., j] ** 2 + p[d][..., 10 - j] ** 2) \
                * div[2 * j + 2]
        cost[d] = c
    costs = torch.stack(cost, dim=-1)               # [..., h8, w8, 8]
    # best_dir: first maximum with cost > 0 (C scans in order with >)
    best = torch.zeros(costs.shape[:-1], dtype=torch.int32,
                       device=luma.device)
    best_cost = torch.zeros_like(best)
    for d in range(8):
        better = costs[..., d] > best_cost
        best = torch.where(better, d, best)
        best_cost = torch.where(better, costs[..., d], best_cost)
    opp = torch.gather(costs, -1, ((best + 4) & 7).long()[..., None])[..., 0]
    var = ((best_cost - opp) >> 10).to(torch.int32)
    return best.to(torch.int32), var


def _msb6(v):
    """floor(log2(v)) for 1 <= v <= 63 as a compare chain; returns 0 for
    v == 0 (masked out by callers)."""
    return ((v > 1).to(v.dtype) + (v > 3) + (v > 7) + (v > 15)
            + (v > 31))


def _constrain(diff, threshold, damping: int):
    """ref constrain(): threshold may be a per-pixel tensor."""
    shift = torch.clamp(damping - _msb6(threshold), min=0)
    mag = torch.minimum(diff.abs(),
                        torch.clamp(threshold - (diff.abs() >> shift), min=0))
    return torch.sign(diff) * mag * (threshold > 0)


def adjust_strength(strength, var):
    """ref adjust_strength: luma primary strength scaled by direction
    variance."""
    v6 = torch.clamp(var >> 6, max=63)
    i = torch.clamp(_msb6(v6), max=12)
    i = torch.where(v6 > 0, i, 0)
    return torch.where(var > 0, (strength * (4 + i) + 8) >> 4, 0)


def _up(a, k: int):
    """[..., h, w] -> [..., h*k, w*k]."""
    return a.repeat_interleave(k, -2).repeat_interleave(k, -1)


def _shifted_planes(plane):
    """{(d, k, sign): plane shifted by sign * DIRS[d, k]} with
    VERY_LARGE outside the frame."""
    *lead, H, W = plane.shape
    pad = torch.full((*lead, H + 4, W + 4), VERY_LARGE, dtype=torch.int32,
                     device=plane.device)
    pad[..., 2:-2, 2:-2] = plane
    shifted = {}
    for d in range(8):
        for k in range(2):
            for sgn in (1, -1):
                dy = int(DIRS[d, k, 0]) * sgn
                dx = int(DIRS[d, k, 1]) * sgn
                shifted[(d, k, sgn)] = pad[..., 2 + dy: 2 + dy + H,
                                           2 + dx: 2 + dx + W]
    return shifted


def _taps_for(shifted, dsel, k: int):
    a = shifted[(0, k, 1)]
    b = shifted[(0, k, -1)]
    for d in range(1, 8):
        m = dsel == d
        a = torch.where(m, shifted[(d, k, 1)], a)
        b = torch.where(m, shifted[(d, k, -1)], b)
    return a, b


def _extract_taps(plane, dir_px):
    """Direction-indexed taps of one plane (they depend on the direction
    field only, so the strength search evaluates every candidate off one
    extraction).  Returns (x0, taps, vmin, vmax) with taps[k] = (p0, p1,
    s0a, s0b, s1a, s1b)."""
    shifted = _shifted_planes(plane)
    taps = []
    vmax = plane
    vmin = plane
    for k in range(2):
        p0, p1 = _taps_for(shifted, dir_px, k)
        s0a, s0b = _taps_for(shifted, (dir_px + 2) & 7, k)
        s1a, s1b = _taps_for(shifted, (dir_px + 6) & 7, k)
        taps.append((p0, p1, s0a, s0b, s1a, s1b))
        for s in (p0, p1, s0a, s0b, s1a, s1b):
            valid = s != VERY_LARGE
            vmax = torch.where(valid, torch.maximum(vmax, s), vmax)
            vmin = torch.minimum(vmin, s)
    return plane, taps, vmin, vmax


def _filter_from_taps(x0, taps, vmin, vmax, pri_px, sec_px, tap_sel,
                      damping: int, plane):
    """Apply one (pri, sec) strength candidate on pre-extracted taps."""
    total = torch.zeros_like(x0)
    for k in range(2):
        p0, p1, s0a, s0b, s1a, s1b = taps[k]
        t = torch.where(tap_sel == 1, PRI_TAPS[1][k], PRI_TAPS[0][k])
        total = total + t * _constrain(p0 - x0, pri_px, damping)
        total = total + t * _constrain(p1 - x0, pri_px, damping)
        st = SEC_TAPS[k]
        for s in (s0a, s0b, s1a, s1b):
            total = total + st * _constrain(s - x0, sec_px, damping)
    out = x0 + ((8 + total - (total < 0).to(total.dtype)) >> 4)
    out = torch.minimum(torch.maximum(out, vmin), vmax)
    active = (pri_px > 0) | (sec_px > 0)
    return torch.where(active, out, plane).to(torch.int32)


def filter_plane(plane, dir_units, pri, sec, damping: int, bs: int,
                 coeff_shift: int = 0):
    """Apply CDEF to a whole plane.

    plane:     [H, W] int32 pre-CDEF pixels
    dir_units: [H/bs, W/bs] direction per filter unit (0 where the
               primary strength is 0 — ref `t ? dir : 0`)
    pri, sec:  [H/bs, W/bs] strengths per unit (0 = unfiltered; luma
               pri must already be var-adjusted)
    damping:   already plane-adjusted (luma d, chroma d-1)
    bs:        8 (luma) or 4 (chroma 4:2:0)
    """
    dir_px = _up(dir_units, bs)
    pri_px = _up(pri, bs)
    sec_px = _up(sec, bs)
    # tap parity from the UNSCALED strength (ref EbCdef.c:212)
    tap_sel = ((pri_px >> coeff_shift) & 1).to(torch.int32)
    x0, taps, vmin, vmax = _extract_taps(plane, dir_px)
    return _filter_from_taps(x0, taps, vmin, vmax, pri_px, sec_px, tap_sel,
                             damping, plane)


def pick_damping(qindex: int) -> int:
    """Encoder damping choice (3..6), scaling with q like libaom's
    pickcdef default."""
    return 3 + (qindex >> 6)


def _unit_strengths(idx_sb, skip_units, strengths, h_units, w_units,
                    units_per_sb: int, coeff_shift: int = 0):
    """Per-unit (pri, sec) from the per-64x64 strength index (scaled
    << coeff_shift for high bit depth; ref EbCdef.c:284-285)."""
    pri_tab = [s[0] << coeff_shift for s in strengths]
    sec_tab = [(s[1] + (s[1] == 3)) << coeff_shift for s in strengths]
    idx_u = _up(idx_sb, units_per_sb)[..., :h_units, :w_units]
    pri = torch.full_like(idx_u, pri_tab[0])
    sec = torch.full_like(idx_u, sec_tab[0])
    for i in range(1, len(strengths)):
        pri = torch.where(idx_u == i, pri_tab[i], pri)
        sec = torch.where(idx_u == i, sec_tab[i], sec)
    pri = torch.where(skip_units, 0, pri)
    sec = torch.where(skip_units, 0, sec)
    return pri, sec


def cdef_search_and_apply(planes, srcs, skip8, damping: int,
                          coeff_shift: int = 0):
    """Encoder: try every frame-list strength per 64x64, pick by SSE
    against the source, return (filtered planes, idx_sb int32).

    planes / srcs: (y, u, v) int32 [..., H, W] / [..., H/2, W/2]; skip8
    [..., H/8, W/8] bool; any leading frame dims, each frame searched on
    its own.  Luma is filtered per candidate off one tap extraction;
    chroma once with the chosen per-SB indices (as the reference
    package)."""
    y, u, v = planes
    *lead, H, W = y.shape
    dev = y.device
    nsb_h, nsb_w = -(-H // 64), -(-W // 64)

    def sb_sse(a, b):
        d = (a - b) ** 2
        full = torch.zeros((*lead, nsb_h * 64, nsb_w * 64), dtype=d.dtype,
                           device=dev)
        full[..., :H, :W] = d
        return full.reshape(*lead, nsb_h, 64, nsb_w, 64).sum(
            (-3, -1), dtype=torch.int32)

    cs = coeff_shift
    dirs, var = find_dir_grid(y, cs)
    h8, w8 = H // 8, W // 8
    pris, secs = [], []
    for i in range(1, len(Y_STRENGTHS)):
        idx = torch.full((*lead, nsb_h, nsb_w), i, dtype=torch.int32,
                         device=dev)
        pri, sec = _unit_strengths(idx, skip8, Y_STRENGTHS, h8, w8, 8, cs)
        pris.append(adjust_strength(pri, var))
        secs.append(sec)
    dir_px = _up(torch.where(pris[0] > 0, dirs, 0), 8)
    x0, taps, vmin, vmax = _extract_taps(y, dir_px)
    lumas = [y]
    costs = [sb_sse(y, srcs[0])]
    for pri, sec in zip(pris, secs):
        pri_px, sec_px = _up(pri, 8), _up(sec, 8)
        tap_sel = ((pri_px >> cs) & 1).to(torch.int32)
        fy = _filter_from_taps(x0, taps, vmin, vmax, pri_px, sec_px,
                               tap_sel, damping + cs, y)
        lumas.append(fy)
        costs.append(sb_sse(fy, srcs[0]))
    cost = torch.stack(costs, dim=-1)          # [..., nsb_h, nsb_w, 4]
    idx_sb = torch.argmin(cost, dim=-1).to(torch.int32)

    m = _up(idx_sb, 64)[..., :H, :W]
    out_y = lumas[0]
    for i in range(1, len(lumas)):
        out_y = torch.where(m == i, lumas[i], out_y)

    pri_c, sec_c = _unit_strengths(idx_sb, skip8, UV_STRENGTHS,
                                   h8, w8, 8, cs)
    dir_c = torch.where(pri_c > 0, dirs, 0)
    out_u = filter_plane(u, dir_c, pri_c, sec_c, damping + cs - 1, 4, cs)
    out_v = filter_plane(v, dir_c, pri_c, sec_c, damping + cs - 1, 4, cs)
    return (out_y, out_u, out_v), idx_sb
