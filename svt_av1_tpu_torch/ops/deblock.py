"""AV1 deblocking (loop) filter in PyTorch (port of svt_av1_tpu/ops/deblock.py).

Exact integer port of the reference filter math (filter4/6/8/14 and the
filter/flat/hev masks, EbDeblockingFilter.c:51-415) restructured for batched
devices: instead of the reference's per-SB parameter walk
(av1_filter_block_plane_vert :1013), every candidate edge column of the
whole frame is evaluated as a batched strip gather -> mask select ->
disjoint scatter.  Valid AV1 edges never write into another valid edge's
taps, and candidate columns 16px apart never share a 14-wide strip, so
the frame partitions into 4 residue classes per direction, each a single
data-parallel pass.

Simplifications matching this encoder's streams: tx size == prediction
block size (every tx edge is a block edge, so edges always filter when
the level is nonzero), no delta LF / segments / ref deltas (uniform
level per plane+direction), sharpness 0.

Planes may carry leading frame dims ([..., H, W]; a batched step
filters its S frames at once); size maps are [..., H, W] or [H, W].
"""

from __future__ import annotations

import numpy as np
import torch


def limits_for_level(level: int, sharpness: int = 0):
    """(blimit, limit, thresh) — ref update_sharpness / hev init."""
    lim = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        lim = min(lim, 9 - sharpness)
    lim = max(lim, 1)
    return 2 * (level + 2) + lim, lim, level >> 4


def pick_filter_levels(qindex: int, is_key: bool, bd: int = 8):
    """(level_y, level_u, level_v) — ref av1_pick_filter_level
    LPF_PICK_FROM_Q (EbDeblockingFilter.c:1867-1911), 8-bit path."""
    from svt_av1_tpu_torch import tables
    q = tables.ac_q(qindex, bd)
    if is_key:
        guess = (q * 17563 - 421574 + (1 << 17)) >> 18
    else:
        guess = (q * 6017 + 650707 + (1 << 17)) >> 18
    guess = guess - 2 if guess > 2 else (guess - 1 if guess > 1 else guess)
    chroma = guess // 2 if guess > 1 else guess
    clamp = lambda v: int(np.clip(v, 0, 63))
    return clamp(guess), clamp(chroma), clamp(chroma)


def _abs(a):
    return a.abs()


def _round2(v, n):
    return (v + (1 << (n - 1))) >> n


def _filter_strip(s, flen, blimit, limit, thresh, bd: int = 8):
    """Filter one batch of vertical-edge strips.

    s:    [..., 14] int32 pixel strip (p6..p0, q0..q6 at index 7)
    flen: [...] int32 filter length (0 = no filter, 4/6/8/14)
    bd:   bit depth; thresholds/offsets scale << (bd-8) and the filter4
          clamp widens (ref aom_highbd_lpf_* / signed_char_clamp_high)
    Returns the filtered strip (same shape).
    """
    p6, p5, p4, p3, p2, p1, p0 = (s[..., i] for i in range(7))
    q0, q1, q2, q3, q4, q5, q6 = (s[..., 7 + i] for i in range(7))
    sh = bd - 8
    blimit = blimit << sh
    limit = limit << sh
    thresh = thresh << sh
    ft = 1 << sh                     # highbd flat threshold (1 << (bd-8))
    off = 128 << sh                  # 0x80 << shift
    clamp_hi = lambda v: torch.clamp(v, -off, off - 1)

    # --- masks (ref filter_mask2 / filter_mask3_chroma / filter_mask) ----
    base = (_abs(p0 - q0) * 2 + _abs(p1 - q1) // 2 <= blimit)
    m2 = ((_abs(p1 - p0) <= limit) & (_abs(q1 - q0) <= limit) & base)
    m3 = (m2 & (_abs(p2 - p1) <= limit) & (_abs(q2 - q1) <= limit))
    m8 = (m3 & (_abs(p3 - p2) <= limit) & (_abs(q3 - q2) <= limit))
    flat3 = ((_abs(p1 - p0) <= ft) & (_abs(q1 - q0) <= ft)
             & (_abs(p2 - p0) <= ft) & (_abs(q2 - q0) <= ft))
    flat4 = (flat3 & (_abs(p3 - p0) <= ft) & (_abs(q3 - q0) <= ft))
    flat2_ = ((_abs(p4 - p0) <= ft) & (_abs(q4 - q0) <= ft)
              & (_abs(p5 - p0) <= ft) & (_abs(q5 - q0) <= ft)
              & (_abs(p6 - p0) <= ft) & (_abs(q6 - q0) <= ft))

    sel_mask = torch.where(flen == 4, m2, torch.where(flen == 6, m3, m8))
    use13 = (flen == 14) & flat2_ & flat4 & sel_mask
    use7 = (flen >= 8) & flat4 & sel_mask & ~use13
    use5 = (flen == 6) & flat3 & sel_mask
    use4 = (flen > 0) & sel_mask & ~use13 & ~use7 & ~use5

    # --- filter4 (ref :133 / highbd_filter4 :454) -------------------------
    ps1, ps0, qs0, qs1 = p1 - off, p0 - off, q0 - off, q1 - off
    hev = (_abs(p1 - p0) > thresh) | (_abs(q1 - q0) > thresh)
    f = torch.where(hev, clamp_hi(ps1 - qs1), 0)
    f = clamp_hi(f + 3 * (qs0 - ps0))  # mask applied via use4 select
    f1 = clamp_hi(f + 4) >> 3
    f2 = clamp_hi(f + 3) >> 3
    o4_q0 = clamp_hi(qs0 - f1) + off
    o4_p0 = clamp_hi(ps0 + f2) + off
    fo = torch.where(hev, 0, _round2(f1, 1))
    o4_q1 = clamp_hi(qs1 - fo) + off
    o4_p1 = clamp_hi(ps1 + fo) + off

    # --- filter6 5-tap (ref :207) ------------------------------------------
    o5_p1 = _round2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3)
    o5_p0 = _round2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3)
    o5_q0 = _round2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3)
    o5_q1 = _round2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3)

    # --- filter8 7-tap (ref :225) ------------------------------------------
    o7_p2 = _round2(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0, 3)
    o7_p1 = _round2(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1, 3)
    o7_p0 = _round2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2, 3)
    o7_q0 = _round2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3, 3)
    o7_q1 = _round2(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3, 3)
    o7_q2 = _round2(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3, 3)

    # --- filter14 13-tap (ref :319) ------------------------------------------
    o13_p5 = _round2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4)
    o13_p4 = _round2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0
                     + q1, 4)
    o13_p3 = _round2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0
                     + q1 + q2, 4)
    o13_p2 = _round2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0
                     + q1 + q2 + q3, 4)
    o13_p1 = _round2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0
                     + q1 + q2 + q3 + q4, 4)
    o13_p0 = _round2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1
                     + q2 + q3 + q4 + q5, 4)
    o13_q0 = _round2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2
                     + q3 + q4 + q5 + q6, 4)
    o13_q1 = _round2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3
                     + q4 + q5 + q6 * 2, 4)
    o13_q2 = _round2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4
                     + q5 + q6 * 3, 4)
    o13_q3 = _round2(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5
                     + q6 * 4, 4)
    o13_q4 = _round2(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                     + q6 * 5, 4)
    o13_q5 = _round2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4)

    def sel(orig, tap13, tap7, tap5, tap4):
        out = orig
        if tap4 is not None:
            out = torch.where(use4, tap4, out)
        if tap5 is not None:
            out = torch.where(use5, tap5, out)
        if tap7 is not None:
            out = torch.where(use7, tap7, out)
        if tap13 is not None:
            out = torch.where(use13, tap13, out)
        return out

    out = [
        s[..., 0],
        sel(p5, o13_p5, None, None, None),
        sel(p4, o13_p4, None, None, None),
        sel(p3, o13_p3, None, None, None),
        sel(p2, o13_p2, o7_p2, None, None),
        sel(p1, o13_p1, o7_p1, o5_p1, o4_p1),
        sel(p0, o13_p0, o7_p0, o5_p0, o4_p0),
        sel(q0, o13_q0, o7_q0, o5_q0, o4_q0),
        sel(q1, o13_q1, o7_q1, o5_q1, o4_q1),
        sel(q2, o13_q2, o7_q2, None, None),
        sel(q3, o13_q3, None, None, None),
        sel(q4, o13_q4, None, None, None),
        sel(q5, o13_q5, None, None, None),
        s[..., 13],
    ]
    return torch.stack(out, dim=-1)


def _flen_for(min_sz, is_luma: bool):
    if is_luma:
        return torch.where(min_sz <= 4, 4, torch.where(min_sz == 8, 8, 14))
    return torch.where(min_sz <= 4, 4, 6)


def deblock_plane_vertical(plane, sizes_px, level: int, is_luma: bool,
                           sharpness: int = 0, bd: int = 8):
    """Filter all vertical edges of one plane.

    plane:    [..., H, W] int32
    sizes_px: [..., H, W] or [H, W] int32 tx/block size (px) of the
              block covering each pixel (uniform within each block).
              level <= 0 disables filtering.
    """
    if level <= 0:
        return plane
    *lead, H, W = plane.shape
    dev = plane.device
    blimit, limit, thresh = limits_for_level(level, sharpness)
    out = torch.cat([plane[..., :1].expand(*lead, H, 8), plane,
                     plane[..., -1:].expand(*lead, H, 8)], dim=-1)
    # residue classes: candidate columns 16 apart never share a strip
    for cls in range(4):
        xs = np.arange(4 + cls * 4, W, 16)
        if xs.size == 0:
            continue
        idx = torch.as_tensor(
            xs[:, None] + np.arange(-7, 7)[None, :] + 8, device=dev)
        xs_t = torch.as_tensor(xs, device=dev)
        strips = out[..., idx]                    # [..., H, n, 14]
        sz_r = sizes_px[..., xs_t]                # [..., H, n]
        sz_l = sizes_px[..., xs_t - 1]
        exists = (xs_t[None, :] % sz_r) == 0
        flen = torch.where(exists,
                           _flen_for(torch.minimum(sz_l, sz_r), is_luma), 0)
        out[..., idx] = _filter_strip(strips, flen, blimit, limit, thresh,
                                      bd)
    return out[..., 8 : 8 + W]


def deblock_plane(plane, sizes_px, level_v: int, level_h: int,
                  is_luma: bool, sharpness: int = 0, bd: int = 8,
                  sizes_px_h=None):
    """Both directions: all vertical edges, then all horizontal (spec
    loop-filter pass order).  With rectangular transforms the two
    directions see different block extents: sizes_px is the tx WIDTH
    map (vertical edges), sizes_px_h the tx HEIGHT map (horizontal
    edges; defaults to sizes_px for square-only streams)."""
    if sizes_px_h is None:
        sizes_px_h = sizes_px
    t = lambda a: a.transpose(-1, -2)
    p = deblock_plane_vertical(plane, sizes_px, level_v, is_luma,
                               sharpness, bd)
    p = deblock_plane_vertical(t(p).contiguous(), t(sizes_px_h), level_h,
                               is_luma, sharpness, bd)
    return t(p).contiguous()
