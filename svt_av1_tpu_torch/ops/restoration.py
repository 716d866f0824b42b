"""Loop restoration: Wiener and self-guided filters, applied per
restoration unit, and their per-unit searches (a host numpy stage).

Copy of svt_av1_tpu/ops/restoration.py (numpy only, no device work):
the port runs restoration on the host as the reference package does, so
the restored reference planes and the coded filter parameters are the
reference's.  Spec 7.17; ref EbRestoration.c
(av1_wiener_convolve_add_src_c, setup_processing_stripe_boundary,
save_deblock_boundary_lines) and EbPickRestoration.c (search_wiener,
search_sgrproj).

Stripe rule: filtering proceeds in 64-row stripes (offset 8; chroma 32
offset 4).  The 3 context rows above/below each interior stripe edge are
the DEBLOCKED (pre-CDEF) rows at that edge, expanded [a0 a0 a1] above
and [b0 b1 b1] below; frame edges replicate.
"""

from __future__ import annotations

import numpy as np

WIENER_TAPS_MID = (3, -7, 15)
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_SUBEXP_K = (1, 2, 3)
ROUND0, ROUND1 = 3, 11      # wiener conv rounding (all bit depths)
CLAMP_LIMIT = 1 << 13       # WIENER_CLAMP_LIMIT(3, bd=8); bd-param below
STRIPE = 64
STRIPE_OFF = 8
BORDER = 3


def wiener_kernel(taps) -> np.ndarray:
    """[w0 w1 w2 -2*(w0+w1+w2) w2 w1 w0] + implicit 128 center add-src."""
    w0, w1, w2 = (int(t) for t in taps)
    return np.array([w0, w1, w2, -2 * (w0 + w1 + w2), w2, w1, w0],
                    np.int32)


def _conv7_h(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    out = None
    for i in range(7):
        t = k[i] * x[:, i : x.shape[1] - 6 + i]
        out = t if out is None else out + t
    return out


def _conv7_v(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    out = None
    for i in range(7):
        t = k[i] * x[i : x.shape[0] - 6 + i, :]
        out = t if out is None else out + t
    return out


def wiener_block(ext: np.ndarray, taps_h, taps_v,
                 bd: int = 8) -> np.ndarray:
    """Filter one extended block: ext is int32 [h+6, w+6] (3-pixel halo
    already holds the correct stripe/frame context).  Returns [h, w]
    pixels (ref av1_wiener_convolve_add_src_c /
    av1_highbd_wiener_convolve_add_src_c, convolve.c:145-222: horiz
    offset 1<<(bd+6), clamp (1<<(bd+5))-1; vert offset -(1<<(bd+10)),
    clip to pixel range)."""
    kx = wiener_kernel(taps_h)
    ky = wiener_kernel(taps_v)
    # horizontal: add-src (center << 7) + offset, clamp to bd+5 bits
    center = ext[:, 3 : ext.shape[1] - 3]
    s = _conv7_h(ext, kx) + (center << 7) + (1 << (bd + 6))
    im = np.clip((s + (1 << (ROUND0 - 1))) >> ROUND0, 0,
                 (1 << (bd + 5)) - 1)
    # vertical: add-src - offset, clip to pixel range
    vcen = im[3 : im.shape[0] - 3, :]
    s = _conv7_v(im, ky) + (vcen << 7) - (1 << (bd + 10))
    return np.clip((s + (1 << (ROUND1 - 1))) >> ROUND1, 0,
                   (1 << bd) - 1)


def _stripe_spans(h: int, ss_y: int):
    """[(y0, y1)] stripe rows for a plane of height h."""
    sh = STRIPE >> ss_y
    off = STRIPE_OFF >> ss_y
    spans = []
    y1 = 0
    s = 0
    while y1 < h:
        y0 = max(0, s * sh - off)
        y1 = min((s + 1) * sh - off, h)
        spans.append((y0, y1))
        s += 1
    return spans


def _extend_stripe(cdef: np.ndarray, deblock: np.ndarray, y0: int,
                   y1: int) -> np.ndarray:
    """Extended stripe [y1-y0+6, w+6]: CDEF pixels inside, deblocked
    context rows at interior stripe edges ([a0 a0 a1] above,
    [b0 b1 b1] below), frame edges replicated; 3-col edge padding."""
    h, w = cdef.shape
    rows = [None] * 3
    if y0 == 0:
        rows = [cdef[0], cdef[0], cdef[0]]
    else:
        a0, a1 = deblock[y0 - 2], deblock[y0 - 1]
        rows = [a0, a0, a1]
    below = [None] * 3
    if y1 >= h:
        below = [cdef[h - 1]] * 3
    else:
        b0 = deblock[y1]
        b1 = deblock[min(y1 + 1, h - 1)]
        below = [b0, b1, b1]
    core = np.concatenate([np.stack(rows), cdef[y0:y1], np.stack(below)])
    return np.pad(core, ((0, 0), (3, 3)), mode="edge").astype(np.int32)


def ru_grid(size: int, unit: int):
    """count_units_in_tile: round-to-nearest RU count (last RU may
    stretch to 150%)."""
    n = max((size + (unit >> 1)) // unit, 1)
    starts = [i * unit for i in range(n)]
    ends = [starts[i + 1] if i + 1 < n else size for i in range(n)]
    return list(zip(starts, ends))


def apply_wiener_plane(cdef: np.ndarray, deblock: np.ndarray,
                       unit: int, ss_y: int,
                       ru_use: np.ndarray, ru_taps: np.ndarray,
                       bd: int = 8) -> np.ndarray:
    """Apply per-RU Wiener filters over a full plane (stripe-aware).

    ru_use:  [nrow, ncol] bool — RESTORE unit on/off
    ru_taps: [nrow, ncol, 6]   — (h0 h1 h2 v0 v1 v2)
    """
    h, w = cdef.shape
    out = cdef.astype(np.int32).copy()
    rows = ru_grid(h, unit)
    cols = ru_grid(w, unit)
    for y0s, y1s in _stripe_spans(h, ss_y):
        ext = _extend_stripe(cdef, deblock, y0s, y1s)
        for ri, (ry0, ry1) in enumerate(rows):
            iy0, iy1 = max(ry0, y0s), min(ry1, y1s)
            if iy0 >= iy1:
                continue
            for ci, (cx0, cx1) in enumerate(cols):
                if not ru_use[ri, ci]:
                    continue
                t = ru_taps[ri, ci]
                blk = ext[iy0 - y0s : iy1 - y0s + 6, cx0 : cx1 + 6]
                out[iy0:iy1, cx0:cx1] = wiener_block(blk, t[:3], t[3:],
                                                     bd)
    return out


def search_wiener_plane(src: np.ndarray, cdef: np.ndarray,
                        deblock: np.ndarray, unit: int, ss_y: int,
                        bd: int = 8):
    """Per-RU Wiener search: separable normal-equation fit (the
    reference's search_wiener compute_stats + wiener_decompose), taps
    quantized to the coded ranges, kept only when SSE improves.

    Returns (ru_use [nr,nc] bool, ru_taps [nr,nc,6] int32).
    """
    h, w = cdef.shape
    rows = ru_grid(h, unit)
    cols = ru_grid(w, unit)
    use = np.zeros((len(rows), len(cols)), bool)
    taps = np.zeros((len(rows), len(cols), 6), np.int32)
    # stripe extensions built ONCE per plane: the former per-unit
    # apply_wiener_plane call filtered the WHOLE plane per candidate
    # (O(units x plane) — 53 s on a 4K luma), where only the unit's
    # stripe-aware filtered block is needed
    exts = [(_extend_stripe(cdef, deblock, y0s, y1s), y0s, y1s)
            for y0s, y1s in _stripe_spans(h, ss_y)]
    for ri, (ry0, ry1) in enumerate(rows):
        for ci, (cx0, cx1) in enumerate(cols):
            s = src[ry0:ry1, cx0:cx1].astype(np.float64)
            d = np.pad(cdef[ry0:ry1, cx0:cx1].astype(np.float64),
                       3, mode="edge")
            t = _fit_separable(s, d)
            if t is None:
                continue
            cand = np.array(t, np.int32)
            got = np.empty((ry1 - ry0, cx1 - cx0), np.int32)
            for ext, y0s, y1s in exts:
                iy0, iy1 = max(ry0, y0s), min(ry1, y1s)
                if iy0 >= iy1:
                    continue
                blk = ext[iy0 - y0s : iy1 - y0s + 6, cx0 : cx1 + 6]
                got[iy0 - ry0 : iy1 - ry0, :] = wiener_block(
                    blk, cand[:3], cand[3:], bd)
            a = src[ry0:ry1, cx0:cx1].astype(np.int64)
            sse_new = ((got.astype(np.int64) - a) ** 2).sum()
            sse_old = ((cdef[ry0:ry1, cx0:cx1].astype(np.int64) - a)
                       ** 2).sum()
            if sse_new < sse_old:
                use[ri, ci] = True
                taps[ri, ci] = cand
    return use, taps


def _fit_separable(src: np.ndarray, dgd_pad: np.ndarray):
    """Least-squares symmetric 7-tap fit, one pass per axis, quantized
    to (MIN..MAX) with the 128-sum constraint."""
    h, w = src.shape

    def fit_axis(vertical: bool):
        # design matrix columns: symmetric tap pairs at offsets 3,2,1
        feats = []
        for off in (3, 2, 1):
            if vertical:
                a = dgd_pad[3 - off : 3 - off + h, 3 : 3 + w]
                b = dgd_pad[3 + off : 3 + off + h, 3 : 3 + w]
            else:
                a = dgd_pad[3 : 3 + h, 3 - off : 3 - off + w]
                b = dgd_pad[3 : 3 + h, 3 + off : 3 + off + w]
            feats.append((a + b).ravel())
        center = dgd_pad[3 : 3 + h, 3 : 3 + w].ravel()
        target = src.ravel() - center
        A = np.stack(feats, 1)
        # out = center + (1/128) * sum_i tap_i * (pair_i - 2*center)
        M = A - 2 * center[:, None]
        try:
            x, *_ = np.linalg.lstsq(M, target, rcond=None)
        except np.linalg.LinAlgError:
            return None
        q = []
        for i in range(3):
            qi = int(round(float(x[i]) * 128.0))
            qi = max(WIENER_TAPS_MIN[i], min(WIENER_TAPS_MAX[i], qi))
            q.append(qi)
        return q

    fh = fit_axis(False)
    fv = fit_axis(True)
    if fh is None or fv is None:
        return None
    return fh + fv


# ---------------------------------------------------------------------------
# Self-guided restoration (SGR).  Spec 7.17.3; ref EbRestoration.c:727-1100
# (av1_selfguided_restoration_c / apply_selfguided_restoration_c) and
# EbRestorationPick.c:705 (search_sgrproj).  One numpy implementation is
# shared by encoder and mirror decoder (like Wiener above).
# ---------------------------------------------------------------------------

# (r0, r1, s0, s1) per 4-bit ep index (ref sgr_params, EbRestoration.c:163)
SGR_PARAMS = (
    (2, 1, 140, 3236), (2, 1, 112, 2158), (2, 1, 93, 1618), (2, 1, 80, 1438),
    (2, 1, 70, 1295), (2, 1, 58, 1177), (2, 1, 47, 1079), (2, 1, 37, 996),
    (2, 1, 30, 925), (2, 1, 25, 863), (0, 1, -1, 2589), (0, 1, -1, 1618),
    (0, 1, -1, 1177), (0, 1, -1, 925), (2, 0, 56, -1), (2, 0, 22, -1))
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR = 256
SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0 = -96, 31
SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1 = -32, 95
SGR_XQD_REF = (-32, 31)     # set_default_sgrproj (C trunc-toward-zero)

# normative LUTs (ref x_by_xplus1 / one_by_x, EbRestoration.c:743-775)
X_BY_XPLUS1 = np.array(
    [1, 128, 171, 192, 205, 213, 219, 224, 228, 230, 233, 235, 236,
     238, 239, 240, 241, 242, 243, 243, 244, 244, 245, 245, 246, 246,
     247, 247, 247, 247, 248, 248, 248, 248, 249, 249, 249, 249, 249,
     250, 250, 250, 250, 250, 250, 250, 251, 251, 251, 251, 251, 251,
     251, 251, 251, 251, 252, 252, 252, 252, 252, 252, 252, 252, 252,
     252, 252, 252, 252, 252, 252, 252, 252, 253, 253, 253, 253, 253,
     253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253,
     253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 254, 254,
     254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 256],
    np.int64)
ONE_BY_X = np.array([4096, 2048, 1365, 1024, 819, 683, 585, 512, 455, 410,
                     372, 341, 315, 293, 273, 256, 241, 228, 216, 205, 195,
                     186, 178, 171, 164], np.int64)


def _rpt(x, n: int):
    """ROUND_POWER_OF_TWO (arithmetic shift; exact for signed ints)."""
    if n <= 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _boxsum(x: np.ndarray, r: int) -> np.ndarray:
    """Sliding (2r+1)^2 box sum with truncated (zero-padded) edges —
    identical to ref boxsum1/boxsum2 at every position the SGR loops
    read (their reads always have full support inside the extended
    block, so truncation never reaches them)."""
    k = 2 * r + 1
    v = np.pad(x.astype(np.int64), r)
    c = np.vstack([np.zeros((1, v.shape[1]), np.int64), v.cumsum(0)])
    v = c[k:] - c[:-k]
    c = np.hstack([np.zeros((v.shape[0], 1), np.int64), v.cumsum(1)])
    return c[:, k:] - c[:, :-k]


def _sgr_ab(ext: np.ndarray, r: int, s: int, bd: int):
    """A (blend factor) and B planes over the extended grid (ref
    selfguided_restoration_internal A/B computation)."""
    n = (2 * r + 1) ** 2
    e = ext.astype(np.int64)
    B0 = _boxsum(e, r)
    A0 = _boxsum(e * e, r)
    a = _rpt(A0, 2 * (bd - 8))
    b = _rpt(B0, bd - 8)
    p = np.maximum(a * n - b * b, 0)
    z = _rpt(p * s, 20)                       # SGRPROJ_MTABLE_BITS
    A = X_BY_XPLUS1[np.minimum(z, 255)]
    B = _rpt((SGRPROJ_SGR - A) * B0 * ONE_BY_X[n - 1], 12)
    return A, B


def _sgr_flt(ext: np.ndarray, r: int, s: int, fast: bool, bd: int):
    """One guided-filter pass; ext [h+6, w+6] -> flt [h, w] in the
    (pixel << SGRPROJ_RST_BITS) domain."""
    h, w = ext.shape[0] - 6, ext.shape[1] - 6
    A, B = _sgr_ab(ext, r, s, bd)
    dgd = ext[3 : 3 + h, 3 : 3 + w].astype(np.int64)

    def at(M, di, dj):
        return M[3 + di : 3 + di + h, 3 + dj : 3 + dj + w]

    if not fast:
        a = ((at(A, 0, 0) + at(A, 0, -1) + at(A, 0, 1)
              + at(A, -1, 0) + at(A, 1, 0)) * 4
             + (at(A, -1, -1) + at(A, 1, -1) + at(A, -1, 1)
                + at(A, 1, 1)) * 3)
        b = ((at(B, 0, 0) + at(B, 0, -1) + at(B, 0, 1)
              + at(B, -1, 0) + at(B, 1, 0)) * 4
             + (at(B, -1, -1) + at(B, 1, -1) + at(B, -1, 1)
                + at(B, 1, 1)) * 3)
        return _rpt(a * dgd + b, 8 + 5 - SGRPROJ_RST_BITS)
    # fast (r=2) variant: even rows blend rows +-1 (nb=5), odd rows
    # their own row (nb=4) — A/B are only ever read at odd offsets
    a_e = ((at(A, -1, 0) + at(A, 1, 0)) * 6
           + (at(A, -1, -1) + at(A, 1, -1) + at(A, -1, 1)
              + at(A, 1, 1)) * 5)
    b_e = ((at(B, -1, 0) + at(B, 1, 0)) * 6
           + (at(B, -1, -1) + at(B, 1, -1) + at(B, -1, 1)
              + at(B, 1, 1)) * 5)
    a_o = at(A, 0, 0) * 6 + (at(A, 0, -1) + at(A, 0, 1)) * 5
    b_o = at(B, 0, 0) * 6 + (at(B, 0, -1) + at(B, 0, 1)) * 5
    out_e = _rpt(a_e * dgd + b_e, 8 + 5 - SGRPROJ_RST_BITS)
    out_o = _rpt(a_o * dgd + b_o, 8 + 4 - SGRPROJ_RST_BITS)
    rows = np.arange(h)[:, None]
    return np.where(rows % 2 == 0, out_e, out_o)


def decode_xq(xqd, ep: int):
    """ref decode_xq (EbRestoration.c:727)."""
    r0, r1 = SGR_PARAMS[ep][0], SGR_PARAMS[ep][1]
    if r0 == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r1 == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def apply_sgr_block(ext: np.ndarray, ep: int, xqd, bd: int = 8):
    """apply_selfguided_restoration on one extended block (stripe/frame
    context already in the 3-pixel halo)."""
    r0, r1, s0, s1 = SGR_PARAMS[ep]
    dgd = ext[3:-3, 3:-3].astype(np.int64)
    u = dgd << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    xq = decode_xq(xqd, ep)
    if r0 > 0:
        v = v + xq[0] * (_sgr_flt(ext, r0, s0, True, bd) - u)
    if r1 > 0:
        v = v + xq[1] * (_sgr_flt(ext, r1, s1, False, bd) - u)
    w = _rpt(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(w, 0, (1 << bd) - 1).astype(np.int32)


def apply_sgr_plane(cdef: np.ndarray, deblock: np.ndarray, unit: int,
                    ss_y: int, ru_use: np.ndarray, ru_ep: np.ndarray,
                    ru_xqd: np.ndarray, bd: int = 8) -> np.ndarray:
    """Apply per-RU SGR over a full plane (stripe-aware, same stripe
    context rules as apply_wiener_plane)."""
    h, w = cdef.shape
    out = cdef.astype(np.int32).copy()
    rows = ru_grid(h, unit)
    cols = ru_grid(w, unit)
    for y0s, y1s in _stripe_spans(h, ss_y):
        ext = _extend_stripe(cdef, deblock, y0s, y1s)
        for ri, (ry0, ry1) in enumerate(rows):
            iy0, iy1 = max(ry0, y0s), min(ry1, y1s)
            if iy0 >= iy1:
                continue
            for ci, (cx0, cx1) in enumerate(cols):
                if not ru_use[ri, ci]:
                    continue
                blk = ext[iy0 - y0s : iy1 - y0s + 6, cx0 : cx1 + 6]
                out[iy0:iy1, cx0:cx1] = apply_sgr_block(
                    blk, int(ru_ep[ri, ci]), tuple(ru_xqd[ri, ci]), bd)
    return out


def _fit_xq(src, dgd, f0, f1, r0, r1):
    """ref get_proj_subspace: least-squares xq over the flt-u planes,
    quantized into the coded xqd ranges."""
    u = (dgd.astype(np.int64) << SGRPROJ_RST_BITS)
    t = ((src.astype(np.int64) << SGRPROJ_RST_BITS) - u).astype(np.float64)
    t *= 1 << SGRPROJ_PRJ_BITS
    cols = []
    if r0 > 0:
        cols.append((f0 - u).astype(np.float64).ravel())
    if r1 > 0:
        cols.append((f1 - u).astype(np.float64).ravel())
    A = np.stack(cols, 1)
    try:
        x, *_ = np.linalg.lstsq(A, t.ravel(), rcond=None)
    except np.linalg.LinAlgError:
        return None
    xq = [0, 0]
    k = 0
    if r0 > 0:
        xq[0] = int(round(float(x[k])))
        k += 1
    if r1 > 0:
        xq[1] = int(round(float(x[k])))
    # quantize to coded xqd (inverse of decode_xq)
    if r0 == 0:
        xqd1 = (1 << SGRPROJ_PRJ_BITS) - xq[1]
        return (0, int(np.clip(xqd1, SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1)))
    if r1 == 0:
        return (int(np.clip(xq[0], SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0)),
                SGR_XQD_REF[1])
    xqd0 = int(np.clip(xq[0], SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0))
    xqd1 = (1 << SGRPROJ_PRJ_BITS) - xqd0 - xq[1]
    return (xqd0, int(np.clip(xqd1, SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1)))


def search_sgr_plane(src: np.ndarray, cdef: np.ndarray,
                     deblock: np.ndarray, unit: int, ss_y: int,
                     eps=(0, 4, 7, 9, 11, 13, 14, 15), bd: int = 8):
    """Per-RU SGR search over a candidate ep subset (ref search_sgrproj,
    EbRestorationPick.c:705).  Returns (use, ep, xqd, sse) grids; sse
    holds the winning SSE per RU (self SSE when off)."""
    h, w = cdef.shape
    rows = ru_grid(h, unit)
    cols = ru_grid(w, unit)
    nr, nc = len(rows), len(cols)
    use = np.zeros((nr, nc), bool)
    ru_ep = np.zeros((nr, nc), np.int32)
    ru_xqd = np.zeros((nr, nc, 2), np.int32)
    ru_xqd[..., 0] = SGR_XQD_REF[0]
    ru_xqd[..., 1] = SGR_XQD_REF[1]
    sse = np.zeros((nr, nc), np.int64)
    for ri, (ry0, ry1) in enumerate(rows):
        for ci, (cx0, cx1) in enumerate(cols):
            s = src[ry0:ry1, cx0:cx1].astype(np.int64)
            d = cdef[ry0:ry1, cx0:cx1]
            best = ((d.astype(np.int64) - s) ** 2).sum()
            sse[ri, ci] = best
            ext = np.pad(d.astype(np.int32), 3, mode="edge")
            for ep in eps:
                r0, r1, s0, s1 = SGR_PARAMS[ep]
                u = d.astype(np.int64) << SGRPROJ_RST_BITS
                f0 = (_sgr_flt(ext, r0, s0, True, bd) if r0 > 0 else u)
                f1 = (_sgr_flt(ext, r1, s1, False, bd) if r1 > 0 else u)
                xqd = _fit_xq(s, d, f0, f1, r0, r1)
                if xqd is None:
                    continue
                got = apply_sgr_block(ext, ep, xqd, bd)
                e = ((got.astype(np.int64) - s) ** 2).sum()
                if e < best:
                    best = e
                    use[ri, ci] = True
                    ru_ep[ri, ci] = ep
                    ru_xqd[ri, ci] = xqd
                    sse[ri, ci] = e
    return use, ru_ep, ru_xqd, sse
