"""Motion estimation in PyTorch: batched full-pel SAD search.

Port of svt_av1_tpu/ops/me.py.  Every block of the frame is scored
against every candidate offset as dense tensor work: for each offset d,
|src - shift(ref, d)| is reduced per aligned block by a reshape block
sum.  The reference package's ``fori_loop`` sweeps become loops over
the offset rows with the offset columns stacked as a batch dimension;
its one-hot selector matmuls become indexing (integer matmuls do not
exist on CUDA).

SAD tie-breaking follows raster order over (dy, dx), matching a
'first-best-wins' scan (``torch.argmin`` returns the first minimum).
"""

from __future__ import annotations

import torch

from svt_av1_tpu_torch.ops import gather as G
from svt_av1_tpu_torch.ops.mc import edge_pad


def mv_rate_bits(mv8):
    """Approximate MV coding cost in bits for a (0,0) predictor prior.

    Rough model of av1_encode_mv's sign+class+offset+fraction bins; used
    only as the encoder-side rate bias, never in the bitstream.  The
    magnitude term is bit_length(|v|), taken exactly from the binary
    exponent (|v| < 2^24)."""
    a = mv8.abs().to(torch.int32)
    nbits = torch.frexp(a.to(torch.float32)).exponent.to(torch.int32)
    comp = torch.where(a == 0, 0, 5 + nbits)
    return 2 + comp.sum(-1, dtype=torch.int32)


def _blocksum(d, bs: int):
    """[..., H, W] -> [..., H/bs, W/bs] sums over bs x bs blocks."""
    *lead, h, w = d.shape
    return d.reshape(*lead, h // bs, bs, w // bs, bs).sum(
        (-3, -1), dtype=torch.int32)


def _offset_sads(src, ref_pad, n: int, bs: int):
    """[n*n, H/bs, W/bs] block SADs of src against every (dy, dx) window
    of ref_pad (raster offset order)."""
    h, w = src.shape
    out = []
    for dy in range(n):
        wins = torch.stack([ref_pad[dy: dy + h, dx: dx + w]
                            for dx in range(n)])
        out.append(_blocksum((src[None] - wins).abs(), bs))
    return torch.cat(out)


def hme_centers(src, ref, search_reach: int = 12):
    """Hierarchical ME level 0: quarter-res full search -> per-32x32-tile
    full-pel center MVs (ref HmeLevel0, EbMotionEstimation.c:5689).

    src/ref: [H, W] int32, H, W multiples of 32.  Returns centers
    [H/32, W/32, 2] full-pel, clamped to +-search_reach."""
    sq = src[::4, ::4].to(torch.int32)
    rq = ref[::4, ::4].to(torch.int32)
    rq_ = (search_reach + 3) // 4 + 1
    n = 2 * rq_ + 1
    rq_pad = edge_pad(rq, rq_, rq_, rq_, rq_)
    best_k = torch.argmin(_offset_sads(sq, rq_pad, n, 8), 0)
    mv = torch.stack([best_k // n - rq_, best_k % n - rq_], dim=-1) * 4
    return torch.clamp(mv, -search_reach, search_reach).to(torch.int32)


def warp_by_centers(ref_pad, centers, tile: int, pad: int):
    """Tile-gather a center-compensated reference plane (one
    [tile, tile] tile per 32x32 grid cell; the CUDA tile gather)."""
    th, tw = centers.shape[:2]
    dev = ref_pad.device
    cen = centers.to(torch.int32)
    base_r = (torch.arange(th, dtype=torch.int32, device=dev)[:, None]
              * tile + pad + cen[..., 0]).reshape(-1)
    base_c = (torch.arange(tw, dtype=torch.int32, device=dev)[None, :]
              * tile + pad + cen[..., 1]).reshape(-1)
    tiles = G.gather_tiles(ref_pad, base_r, base_c, nbh=th, nbw=tw,
                           stride=tile, band_off=0,
                           band_h=2 * pad + tile, th=tile, tw=tile)
    return (tiles.reshape(th, tw, tile, tile)
            .permute(0, 2, 1, 3).reshape(th * tile, tw * tile))


def sad_lattice_multisize(src, warped, r2: int, bd: int = 8):
    """One +-r2 full-pel sweep on the center-warped reference, returning
    the FULL per-offset SAD lattice {bs: [(2r2+1)^2, H//bs, W//bs]}
    (offset axis major; the 16/32 levels are 2x2 sums of the 8 level)."""
    h, w = src.shape
    n = 2 * r2 + 1
    wpad = edge_pad(warped.to(torch.int32), r2, r2, r2, r2)
    lat8 = _offset_sads(src.to(torch.int32), wpad, n, 8)
    lat16 = _blocksum(lat8, 2)
    lat32 = _blocksum(lat16, 2)
    return {8: lat8, 16: lat16, 32: lat32}


def _offset_table(r2: int, device):
    n = 2 * r2 + 1
    k = torch.arange(n * n, device=device)
    return torch.stack([k // n - r2, k % n - r2], -1).to(torch.int32)


def _up(a, k: int):
    return a.repeat_interleave(k, 0).repeat_interleave(k, 1)


def select_from_lattice(lat, centers, tile: int, r2: int,
                        lam=None, priors=None):
    """Pick per-block winners from a sad_lattice_multisize result;
    returns {bs: (mv_fp, cost)}.  The winner's (dy, dx) is read from the
    offset table by index."""
    dyx = _offset_table(r2, centers.device)                  # [n*n, 2]
    out = {}
    for bs in (8, 16, 32):
        cen = _up(centers, tile // bs)
        cost = lat[bs]                                       # [n*n, h, w]
        if lam is not None:
            mv8 = (cen[None] + dyx[:, None, None, :]
                   - (priors[bs][None] if priors is not None else 0)) * 8
            cost = cost + ((lam * mv_rate_bits(mv8)) >> 4)
        kbest = torch.argmin(cost, 0)                        # [h, w]
        out[bs] = (cen + dyx[kbest], cost.min(0).values)
    return out


def refined_search_multisize(src, warped, centers, tile: int, r2: int,
                             lam=None, priors=None):
    """+-r2 full-pel sweep on the center-warped reference; returns
    {bs: (mv_fp, cost)} with mv_fp = tile center + delta (the sweep and
    the selection of select_from_lattice in one call)."""
    lat = sad_lattice_multisize(src, warped, r2)
    return select_from_lattice(lat, centers, tile, r2, lam, priors)


def median3_mv_field(mv):
    """Component-wise median of (left, up, up-right) neighbor MVs — a
    bulk-parallel approximation of the entropy coder's ref-MV-stack
    predictor (the reference's spatial MVP)."""
    left = torch.roll(mv, 1, dims=1)
    left[:, 0] = 0
    up = torch.roll(mv, 1, dims=0)
    up[0, :] = 0
    upr = torch.roll(torch.roll(mv, 1, dims=0), -1, dims=1)
    upr[0, :] = 0
    upr[:, -1] = 0
    return left + up + upr - torch.minimum(torch.minimum(left, up), upr) \
        - torch.maximum(torch.maximum(left, up), upr)
