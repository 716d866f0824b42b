"""Picture analysis: decimation pyramids, block variance, histograms,
noise estimation — feeding adaptive quantization and the lookahead.

ref picture_analysis_kernel (EbPictureAnalysisProcess.c:5010): the
reference builds 1/4 + 1/16 decimated planes (DecimateInputPicture:4907),
per-block means/variances (ComputeBlockMeanComputeVariance:2066), luma
histograms (:4146) and a noise level (DetectInputPictureNoise:3261) on
its picture-analysis thread pool.  Here the same statistics are batched
array ops (numpy on the host) — one call
per frame, no wavefronts or segment queues.

Adaptive quantization (ref SourceBasedOperationsProcess.c content
classifiers -> QP scaling): a frame-level q offset derived from spatial
activity (variance masking: busy frames hide quantization noise, flat
frames band) and the noise floor.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PictureStats:
    """Per-frame analysis products (ref PictureParentControlSet's
    pa fields)."""
    mean: float            # luma mean
    variance: float        # frame mean of per-SB variance
    var_sb: np.ndarray     # [sb_rows, sb_cols] per-64x64 luma variance
    hist: np.ndarray       # [64] 4-bit-binned luma histogram
    noise: float           # high-frequency noise level estimate
    pyr4: np.ndarray       # 1/4-decimated luma
    pyr16: np.ndarray      # 1/16-decimated luma
    # content classifiers (ref SourceBasedOperations grass/skin/dark
    # detectors); None when analyze() ran luma-only
    protect_sb: np.ndarray | None = None   # [sb_rows, sb_cols] bool


def decimate(xp, plane, factor: int):
    """Box-filtered decimation (ref Decimation2D, EbPictureAnalysis
    Process.c:170 uses subsampling; the box filter is the quality
    variant the reference gates behind DOWN_SAMPLING_FILTER_MODE)."""
    h, w = plane.shape
    h2, w2 = h // factor * factor, w // factor * factor
    p = plane[:h2, :w2].reshape(h2 // factor, factor, w2 // factor, factor)
    return p.astype(xp.int32).sum((1, 3)) // (factor * factor)


def block_variance(xp, plane, bs: int = 64):
    """Per-[bs x bs]-block luma variance (integer, like the reference's
    variance16x16..64x64 ladder)."""
    h, w = plane.shape
    ph, pw = -(-h // bs) * bs, -(-w // bs) * bs
    if (ph, pw) != (h, w):
        p32 = plane.astype(xp.int64)
        pad = ((0, ph - h), (0, pw - w))
        p32 = xp.pad(p32, pad, mode="edge")
    else:
        p32 = plane.astype(xp.int64)
    b = p32.reshape(ph // bs, bs, pw // bs, bs)
    n = bs * bs
    s = b.sum((1, 3))
    s2 = (b * b).sum((1, 3))
    return (s2 // n - (s // n) ** 2).astype(xp.int32)


def luma_histogram(xp, plane):
    """64-bin (>>2) luma histogram (ref SubSampleLumaGeneratePixel
    IntensityHistogramBins subsamples 4:1; full count here)."""
    return np.bincount((plane >> 2).reshape(-1), minlength=64)[:64]


def noise_level(xp, plane):
    """Noise estimate: mean |laplacian|/6 on the interior (the same
    high-pass family the reference's DetectInputPictureNoise uses)."""
    p = plane.astype(xp.int32)
    lap = (4 * p[1:-1, 1:-1] - p[:-2, 1:-1] - p[2:, 1:-1]
           - p[1:-1, :-2] - p[1:-1, 2:])
    return xp.abs(lap).mean() / 6.0


def block_mean(xp, plane, bs: int):
    """Per-[bs x bs]-block mean (edge-padded like block_variance)."""
    h, w = plane.shape
    ph, pw = -(-h // bs) * bs, -(-w // bs) * bs
    p = plane.astype(xp.int64)
    if (ph, pw) != (h, w):
        p = xp.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
    return (p.reshape(ph // bs, bs, pw // bs, bs).sum((1, 3))
            // (bs * bs)).astype(xp.int32)


def content_class_map(y, u, v, bd: int = 8) -> np.ndarray:
    """Per-superblock grass / skin / dark classifier union.

    Behavioral port of the reference's source-based content detectors
    (EbSourceBasedOperationsProcess.c:405-470 GrassLcu grass+skin mean
    conditions, :394 dark-region DARK_FRM_TH=45): SBs whose luma/chroma
    means fall in the grass (y 70..130, cb 80..115, cr 110..135) or
    skin (y 70..130, cb 100..120, cr 135..160) windows, or whose luma
    is dark (< 45), are artifact-sensitive and get protected by the AQ
    map.  Means are taken per 64x64 luma SB (the reference classifies
    per 16x16 CU and ORs up the tree; our delta-q granularity is the
    SB).  Thresholds live in the 8-bit domain.
    """
    sh = bd - 8
    ym = block_mean(np, np.asarray(y) >> sh if sh else np.asarray(y), 64)
    cb = block_mean(np, np.asarray(u) >> sh if sh else np.asarray(u), 32)
    cr = block_mean(np, np.asarray(v) >> sh if sh else np.asarray(v), 32)
    n = min(ym.shape[0], cb.shape[0]), min(ym.shape[1], cb.shape[1])
    ym = ym[: n[0], : n[1]]
    cb = cb[: n[0], : n[1]]
    cr = cr[: n[0], : n[1]]
    ymid = (ym > 70) & (ym < 130)
    grass = ymid & (cb > 80) & (cb < 115) & (cr > 110) & (cr < 135)
    skin = ymid & (cb > 100) & (cb < 120) & (cr > 135) & (cr < 160)
    dark = ym < 45
    return grass | skin | dark


def analyze(frame_y: np.ndarray, frame_u=None, frame_v=None,
            bd: int = 8) -> PictureStats:
    """Host-side picture analysis of one luma plane; pass the chroma
    planes to also run the grass/skin/dark content classifiers."""
    y = np.asarray(frame_y)
    var_sb = block_variance(np, y, 64)
    protect = (content_class_map(y, frame_u, frame_v, bd)
               if frame_u is not None else None)
    return PictureStats(
        mean=float(y.mean()),
        variance=float(var_sb.mean()),
        var_sb=var_sb,
        hist=np.asarray(luma_histogram(np, y)),
        noise=float(noise_level(np, y)),
        pyr4=np.asarray(decimate(np, y, 4)),
        pyr16=np.asarray(decimate(np, y, 16)),
        protect_sb=protect,
    )


def aq_frame_offset(stats: PictureStats, bd: int = 8) -> int:
    """Frame-level adaptive-q offset (qindex units, +-12).

    Variance masking: high spatial activity hides coding noise -> spend
    fewer bits (positive offset); flat content bands -> spend more
    (negative offset).  Noise lifts the floor so grain is not chased.
    ref analog: SourceBasedOperationsProcess QP scaling inputs
    (EbSourceBasedOperationsProcess.c:89-283) reduced to frame level.
    """
    sc = 1 << (2 * (bd - 8))
    # noise discounts apparent activity (it is not structural masking)
    act = max(1.0, stats.variance / sc / (1.0 + stats.noise))
    # ~0 offset at activity 1000; +-3 qindex per octave away from it
    off = 3.0 * (np.log2(act) - np.log2(1000.0))
    return int(np.clip(round(off), -12, 12))


def aq_sb_qmap(stats: PictureStats, base_q: int, res: int = 2,
               bd: int = 8) -> np.ndarray:
    """Per-superblock qindex map for delta-q AQ (spec 5.9.17 per-SB
    deltas; ref per-SB QP from the BEA/variance classifiers,
    EbSourceBasedOperationsProcess.c:89-703 + EbModeDecisionConfiguration
    budgeting, reduced to variance masking).

    Offsets follow log-variance relative to the frame's geometric mean
    (busy SBs hide noise -> higher q; flat SBs show it -> lower q),
    quantized to the delta_q_res grid so base_q + off stays exactly
    representable by the coded deltas (no Clip3 drift), and bounded so
    the absolute qindex remains in [1, 255]."""
    sc = 1 << (2 * (bd - 8))
    v = np.maximum(stats.var_sb / sc, 1.0)
    g = float(np.exp(np.mean(np.log(v))))
    off = 4.0 * np.log2(v / max(g, 1.0))
    if stats.protect_sb is not None:
        # grass/skin/dark SBs (content_class_map) are artifact-
        # sensitive: bias one delta-q step finer regardless of their
        # variance masking (ref SourceBasedOperations classifier ->
        # QP scaling direction)
        pr = stats.protect_sb
        h = min(off.shape[0], pr.shape[0])
        w = min(off.shape[1], pr.shape[1])
        off[:h, :w] -= 4.0 * pr[:h, :w]
    step = 1 << res
    off = np.clip(np.round(off / step) * step, -16, 16).astype(np.int32)
    lo = -((base_q - 1) // step) * step
    hi = ((255 - base_q) // step) * step
    return base_q + np.clip(off, lo, hi)


def pick_interp_filter(stats: PictureStats, qindex: int,
                       bd: int = 8) -> int:
    """Frame-level interpolation-filter decision (0 REGULAR, 1 SMOOTH,
    2 SHARP).

    The reference searches regular/smooth/sharp per block inside mode
    decision (interpolation filter search, EbProductCodingLoop.c:1138);
    the TPU steps are compiled per filter, so the choice is made ONCE
    per stream from open-loop source stats: SMOOTH when the reference
    pictures are dominated by sensor noise at low rates (the softer
    half-band response stops MC from copying noise into every
    prediction), SHARP for high-detail content coded at high rates
    (preserves the edges RD pays to keep), REGULAR otherwise.
    """
    sc = float(1 << (bd - 8))
    noise = stats.noise / sc
    detail = stats.variance / (sc * sc)
    if noise > 3.0 and qindex >= 120:
        return 1
    if noise < 1.0 and detail > 3000 and qindex <= 100:
        return 2
    return 0


def estimate_global_translation(prev_y: np.ndarray, cur_y: np.ndarray,
                                max_fullpel: int = 15):
    """Open-loop global TRANSLATION estimate between consecutive source
    frames (ref global-motion detection on source ME fields,
    EbInitialRateControlProcess.c:252; here a coarse-to-fine decimated
    search so it runs before any device dispatch).

    Returns (row8, col8) in 1/8-pel units (full-pel, so always even) or
    None when the frame is not dominated by one translation.
    """
    p = prev_y.astype(np.int32)
    c = cur_y.astype(np.int32)
    h, w = c.shape
    if h < 64 or w < 64:
        return None

    def sad_at(a, b, dy, dx, margin, step=1):
        # overlap windows of b shifted by (dy, dx) against a; step
        # subsamples the window (full-pel precision is unaffected and
        # the decision is a coarse hypothesis test — keeps the per-frame
        # host cost ~8 ms instead of ~120 ms at 720p)
        y0, y1 = margin + dy, a.shape[0] - margin + dy
        x0, x1 = margin + dx, a.shape[1] - margin + dx
        return np.abs(a[y0:y1:step, x0:x1:step]
                      - b[margin:-margin:step,
                          margin:-margin:step]).mean()

    # 1/8-subsampled exhaustive +-2 (covers +-16 full-pel), then refine
    # (plain subsampling like the reference's decimation mode 0 —
    # strided views are free, and the full-res refine below fixes any
    # aliasing in the coarse winner)
    p8, c8 = p[::8, ::8], c[::8, ::8]
    m = 3
    best, bdy, bdx = None, 0, 0
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            s = sad_at(p8, c8, dy, dx, m)
            if best is None or s < best:
                best, bdy, bdx = s, dy, dx
    dy, dx = bdy * 8, bdx * 8
    # full-res refine +-4 around the coarse winner
    m = 20
    best, bdy, bdx = None, dy, dx
    for ddy in range(-4, 5):
        for ddx in range(-4, 5):
            ty, tx = dy + ddy, dx + ddx
            if abs(ty) > max_fullpel or abs(tx) > max_fullpel:
                continue
            if abs(ty) >= m or abs(tx) >= m:
                continue
            s = sad_at(p, c, ty, tx, m, step=4)
            if best is None or s < best:
                best, bdy, bdx = s, ty, tx
    if best is None:
        return None
    # +-1 polish at an ODD stride: the step=4 strided SAD can alias one
    # pel off on textured content (a wrong-by-one global vector never
    # wins a GLOBALMV block, silently disabling the tool); stride 3
    # breaks the even-shift aliasing pattern at 1/9 pixel cost
    dy, dx = bdy, bdx
    best = None
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            ty, tx = dy + ddy, dx + ddx
            if max(abs(ty), abs(tx)) > min(max_fullpel, 19):
                continue
            s = sad_at(p, c, ty, tx, m, step=3)
            if best is None or s < best:
                best, bdy, bdx = s, ty, tx
    if best is None or (bdy, bdx) == (0, 0):
        return None
    # require the translation to explain the frame: clearly better than
    # the zero-motion hypothesis
    zero = sad_at(p, c, 0, 0, 20, step=3)
    if best > 0.8 * zero:
        return None
    return (bdy * 8, bdx * 8)
