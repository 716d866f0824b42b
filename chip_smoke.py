#!/usr/bin/env python3
"""Smoke run of svt_av1_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout on a machine with a CUDA card (nvcc on
PATH or under /usr/local/cuda).  Phases, one line of seconds each:

  1. device   — a CUDA card must be present (else exit 1, no result);
                prints nvidia-smi's name and power limit;
  2. build    — nvcc builds csrc/gather_tiles.cu and g++ builds the C++
                entropy coder into build/svt_av1_tpu_torch/, together;
  3. kernel   — both designs of the tile-gather kernel (the main
                path's and the first port's v1, a yardstick) against its
                plain PyTorch version at every call-site shape of a
                720p P frame, of a 1080p B frame, of a 1080p preset-6 B
                frame and of a 4K 10-bit preset-6 B frame (the 4K sites
                also on int16 planes), at the sites a 1080p preset-5 B
                frame adds (the rect leaves' MC patches at cell
                granularity), and at awkward shapes (odd
                widths, edge and off-contract starts, three dtypes),
                exact equality (tolerance 0); then the gather on stacks
                of S planes (one launch for all S) at every site of a
                4-stream 1080p P slot for S = 1, 2, 4 (u8 ME warp, int32
                refine and MC patches), on stacks of awkward shapes, and
                at the 32-bit limit (a 2^31-byte plane must raise; a
                2.18 GB stack of two planes must gather exactly);
  4. main     — the 720p low-delay-P encode (1 keyframe + 7 P frames,
                qp 40, preset 8) through Encoder.send_picture/get_packet;
                the gather must launch 6 times per P frame;
  5. main-B   — the 1080p hierarchical-B encode (qp 40, preset 8,
                hierarchical_levels=3, compound_mode=1, deblock + CDEF):
                a keyframe and one mini-GOP (base P + 7 B frames) of a
                moving clip through send_picture/flush/get_packet, 9
                coded and 8 show-existing TUs; the gather must launch 5
                times for the base P frame and 13 per B frame, and the
                B frames must hold compound cells;
  6. main-LDB — the 1080p low-delay-B encode (qp 40, preset 8,
                pred_structure=1, deblock + CDEF, scene-change detection
                on): a keyframe and 7 LAST + GOLDEN frames of the moving
                clip through send_picture/get_packet; every frame after
                the keyframe must be an inter frame (the clip has no
                cut), and the gather must launch 10 times per LDB frame;
  7. main-RD  — the 1080p hierarchical-B encode at the RD preset 6
                (qp 40, hierarchical_levels=3, compound_mode=1,
                multi_ref=-1: the coding tools of bench.py's 4K 10-bit
                VOD config at 8-bit 1080p): a keyframe and one mini-GOP
                of the moving clip; the keyframe must hold 16x16 leaves,
                4 interior frames must be coded from three references
                (display 1, 2, 3, 5), the gather must launch exactly 20 /
                60 / 80 times for a frame of 1 / 2 / 3 references, and
                the B frames must hold compound cells;
  7b. main-P5 — the same 1080p hier-B encode at preset 5 (the tx-type
                search, rect leaves, the rich intra keyframe): 9 frames;
                the keyframe must hold 16x16 leaves, 4 frames must be
                coded from three references, the gather must launch 32 /
                96 / 128 times for a frame of 1 / 2 / 3 references (the
                rect leaves' MC adds 12 / 36 / 48), the inter frames
                must hold rect and compound cells; per frame the wall
                split into device step, host entropy (the Python tile
                writer on tiles with rect leaves) and the rest, bytes,
                PSNR-Y, rect and IDTX cells, gathers, peak memory;
  7c. main-RC — the 720p low-delay-P config (bench.py:136) under VBR
                (rate control 2, 2000 kbps at 30 fps), 8 frames: q per
                frame, bytes and the achieved rate; 6 gathers per P frame;
  8. main-VOD — bench.py:185's 4K 10-bit VOD config and clip
                (3840x2160, 10-bit, qp 40, hierarchical_levels=3,
                compound, preset 6, loop restoration, adaptive
                quantization; io.yuv.vod_clip, cut to 5 frames: a
                keyframe and a truncated span of 4): decode order, 16x16
                keyframe leaves, a three-reference frame, 0 / 20 / 60 /
                80 gathers per frame of 0 / 1 / 2 / 3 references,
                restoration switched
                on, AQ analysis on every inter frame, PSNR-Y (10-bit
                peak) in range; per frame the wall ms split into device
                step, host restoration, host analysis, host entropy and
                the rest, bytes, PSNR-Y, the restoration type per plane,
                gathers and peak device memory;
 8b. main-batch — bench.py:115's all-intra config at its own size
                (854x480, qp 40, device_batch 32, no recon): a 32-frame
                warm-up batch, then 64 timed frames; per batch the wall
                split into wavefront step, in-loop filters, host entropy
                (thread pool) and the rest, frames/s, peak memory;
 8c. main-live — bench.py:221's live config at its own size: 4
                lockstep 1920x1080 IPPP streams (qp 40, global motion
                off) through MultiStreamEncoder, 2 warm-up and 12 timed
                slots; the gather must launch 5 times per P slot for
                the 4 streams (as for one stream's P frame); aggregate
                frames/s, per slot the wall split into the batched step,
                host entropy and the rest, peak memory;
  9. parity   — encoded on the card and on the CPU, each must give
                byte-identical TUs and equal recon: a 320x192 IPPP clip
                (1 keyframe + 2 P), a 192x128 hier-B clip (levels 2, 6
                frames: a truncated span at flush), a 320x192 LDB clip,
                a 320x192 IPPP clip with a 2x2 tile grid, a 3-frame
                look-ahead window and push_qp overrides, and at the RD
                presets a 192x128 hier-B clip (preset 6, levels 3, 9
                frames, three-reference frames), a 320x192 IPPP clip and
                a 320x192 LDB clip (preset 7), a 192x128 hier-B clip
                with AQ 2 (per-SB delta-q) and the 4K VOD config at
                200x136 (9 frames of its clip), at presets <= 5 a
                192x128 hier-B clip (preset 5, levels 2) and a 192x128
                IPPP clip (preset 0), under rate control a 192x128
                hier-B VBR clip (9 frames) and a 320x192 LDB CVBR clip;
                and the port's CLI
                (--pred-struct 1 --tiles-log2 1 --qp-file; hier-B at
                --preset 7; IPPP at --bit-depth 10) run in this process
                at --device cuda and at --device cpu on the same
                synthetic input must write byte-identical IVF files;
                and the batched entry points: a 192x128 all-intra clip
                at device_batch 4 (6 frames, a partial last batch),
                three lockstep 192x128 streams, two GOPs of 4 frames in
                lockstep (GopShardedEncoder), two lockstep 192x128 VBR
                streams (4 slots) and the CLI at --nch 2;
 10. timing   — at each call site, for both designs, one torch.take
                call and the plain version: event ms (CUDA events around
                20 back-to-back calls) and host us per call (perf_counter
                around 200 calls issued without a synchronise) at every
                site, then device us per call (torch.profiler kernel
                time over 20 calls) at every site, beside the byte
                bound; at the batched 4x1080p P-slot sites also S
                separate 2-D launches.  Late, because a profiler session
                may slow every later launch;
 11. kernels  — CUDA kernels of the 480p all-intra device work for one
                32-frame batch and for one frame (torch.profiler).

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  For gather_tiles, launches counts the
main-path launches of phases 4 to 8c; ms, device_ms, host_us,
plain_ms, bound_ms and library_ms are sums over the six launches of one
720p P frame, "per_1080p_b_frame" holds the same sums over the 13
launches of one 1080p B frame, "per_1080p_ldb_frame" over the 10 of
one 1080p LDB frame (the B frame's sites without the compound
patches) and "per_1080p_rd_b_frame" over the 80 of one 1080p preset-6
B frame coded from three references with compound prediction, and
"per_4k_10bit_rd_b_frame" over the 80 of one 4K 10-bit preset-6 B
frame of the same kind, "per_1080p_p5_b_frame" over the 128 of one
1080p preset-5 B frame of the same kind (the preset-6 frame's 80 and
the rect leaves' 48), and "per_4x1080p_p_slot" over the 5 batched
launches of one 4-stream 1080p P slot (with the 20 launches four
separate streams would make beside them).  --out
DIR also writes the per-shape and per-frame numbers to
DIR/chip_smoke.json.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
W720, H720, N_MAIN = 1280, 720, 8
W1080, H1080, N_HIERB = 1920, 1080, 9
# gather launches per frame of each call site on the main paths
P720 = {"warp_by_centers": 1, "globalmv_copy": 1, "cell_refine": 1,
        "mc_patch_luma": 1, "mc_patch_chroma": 2}
# a B frame: ME warp and cell refine per reference, and per plane the
# ref0 patch, the ref1 single-ref patch and the ref1 compound patch;
# the mini-GOP's base P frame has no global-motion copy
B1080 = {"warp_by_centers": 2, "cell_refine": 2, "mc_patch_luma": 3,
         "mc_patch_chroma": 6}
BASE_P_LAUNCHES = 5
# a low-delay-B frame: the two-reference step without compound
# prediction (ME warp and cell refine per reference, and per plane the
# LAST patch and the GOLDEN single-ref patch), at the B frame's shapes
LDB1080 = {"warp_by_centers": 2, "cell_refine": 2, "mc_patch_luma": 2,
           "mc_patch_chroma": 4}
N_LDB = 8
# a preset-6 B frame from three references with compound prediction:
# per reference the ME warp, the dense quarter-pel refine at 8/16/32 and
# the four 64x64 candidates; the compound candidate's two patches per
# size; per size the MC of ref0, ref1, ref2 and ref1's compound patch on
# luma, and on each chroma plane
RD1080 = {"warp_by_centers": 3, "subpel_refine_dense_8": 3,
          "subpel_refine_dense_16": 3, "subpel_refine_dense_32": 3,
          "mc_patch_luma_8": 6, "mc_patch_luma_16": 6,
          "mc_patch_luma_32": 6, "mc_patch_luma_64": 18,
          "mc_patch_chroma_4": 8, "mc_patch_chroma_8": 8,
          "mc_patch_chroma_16": 8, "mc_patch_chroma_32": 8}
# preset 6: gather launches per coded frame by its reference count (the
# base P frame 20, a two-reference compound B frame 60), and the
# references of each display index of a levels-3 mini-GOP after a
# keyframe (the span base 8 joins as ALTREF where it is neither
# reference)
RD_LAUNCHES = {1: 20, 2: 60, 3: sum(RD1080.values())}
RD_NREFS = {8: 1, 4: 2, 2: 3, 1: 3, 3: 3, 6: 2, 5: 3, 7: 2}
# presets <= 5 add the rect hypotheses (HORZ / VERT at the 16 and 32
# nodes, 4 kinds): each kind's MC at 8x8 luma / 4x4 chroma cells, per
# plane one patch per reference and ref1's compound patch; for a
# three-reference compound B frame 4 x 4 luma and 4 x 8 chroma patches
P5_RECT = {"rect_mc_patch_luma": 16, "rect_mc_patch_chroma": 32}
P5_LAUNCHES = {n: RD_LAUNCHES[n] + 12 * (n + (n >= 2)) for n in (1, 2, 3)}
# bench.py:185 run_vod_4k10, "Config 4": its EncoderConfig and its clip
# (io.yuv.vod_clip), cut from 9 frames (a keyframe and one levels-3
# mini-GOP) to 5: a keyframe and the truncated span of 4 (display 4 from
# one reference, 2 and 3 from two, 1 from three), to leave room in the
# run for the preset-5 and rate-control phases
W4K, H4K, N_VOD = 3840, 2160, 5
VOD_ORDER = [0, 4, 2, 1, 3]
VOD_NREFS = {4: 1, 2: 2, 1: 3, 3: 2}
# the 720p low-delay-P config (bench.py:136) under VBR (rate control 2)
N_RC, RC_TBR, RC_FPS = 8, 2_000_000, 30
# bench.py:115 run_intra_480p ("Config 1"): all-intra 854x480, qp 40,
# device_batch 32; a 32-frame warm-up batch, then 64 timed frames
W480, H480, B480, N480 = 854, 480, 32, 64
# bench.py:221 run_live_4x1080 ("Config 5"): 4 lockstep 1080p IPPP
# streams, 2 warm-up slots and 12 timed slots; gather launches per P slot
# (the batched P step without global motion: ME warp, cell refine, and
# per plane the MC patch), the same for 1 stream as for 4
N_STREAMS, LIVE_WARM, LIVE_TIMED = 4, 2, 12
LIVE1080 = {"warp_by_centers": 1, "cell_refine": 1, "mc_patch_luma": 1,
            "mc_patch_chroma": 2}
LIVE_S = (1, 2, 4)          # stack sizes the batched gather is held at
VOD_KW = dict(width=W4K, height=H4K, qp=40, bit_depth=10, intra_period=-1,
              pred_structure=2, hierarchical_levels=3, compound_mode=1,
              enc_mode=6, enable_restoration=True,
              enable_adaptive_quantization=True, recon_output=False,
              scene_change_detection=False)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.time() - t0:.2f} s", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() in ms from CUDA events over iters calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, iters: int = 20):
    """Kernel time per call in us from torch.profiler (sum of every CUDA
    kernel of iters calls / iters); None if the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / iters if total > 0 else None


def host_us(fn, calls: int = 200) -> float:
    """Host time per call in us: calls issued without a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def call_sites(torch, MC, G, gen, dev, w, h, per_frame, rd=False, bd=8,
               rect=False):
    """(name, launches per frame on the main path, plane, base_r, base_c,
    gather_tiles kwargs) at the shapes every call site of per_frame has
    in a w x h frame (rd: the RD presets' sites — the per-size MC patches
    and the dense refine — in place of the preset-8 grid sites; rect:
    only the sites presets <= 5 add, the rect leaves' MC at cell
    granularity, its motion constant over 16x8 halves), with
    bd-bit pixels in the main path's containers (u8, or int16 at 10 bits,
    for the ME warp; int32 padded planes for the rest).  Motion is drawn
    uniformly within each site's reach."""
    ph, pw = -(-h // 64) * 64, -(-w // 64) * 64    # 64-padded geometry
    px = MC.pixel_dtype(bd)
    ry = torch.randint(0, 1 << bd, (ph, pw), generator=gen,
                       dtype=px).to(dev)
    ru = torch.randint(0, 1 << bd, (ph // 2, pw // 2), generator=gen,
                       dtype=px).to(dev)
    pad, cpad, search = 17, 9, 16
    py_pad = MC.pad_for_filter(ry, pad)
    pu_pad = MC.pad_for_filter(ru, cpad)

    def mv(shape, reach):
        return torch.randint(-reach, reach + 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    sites = []
    # me.warp_by_centers: one 32x32 pixel tile per 32x32 cell
    ref_pad = MC.edge_pad(ry, search, search, search, search)
    th, tw = ph // 32, pw // 32
    cen = mv((th, tw, 2), 13)
    ar = lambda k: torch.arange(k, dtype=torch.int32, device=dev)
    br = (ar(th)[:, None] * 32 + search + cen[..., 0]).reshape(-1)
    bc = (ar(tw)[None, :] * 32 + search + cen[..., 1]).reshape(-1)
    sites.append(("warp_by_centers", per_frame.get("warp_by_centers", 0),
                  ref_pad,
                  br, bc, dict(nbh=th, nbw=tw, stride=32, band_off=0,
                               band_h=2 * search + 32, th=32, tw=32)))
    nb8 = (ph // 8, pw // 8)
    g = mv((2,), 15)
    grid = [  # name, plane, mv, bs, pad, reach, halo, off
        ("globalmv_copy", py_pad,
         (g[0].expand(nb8), g[1].expand(nb8)), 8, pad, pad - 1, 0, 0),
        ("cell_refine", py_pad, (mv(nb8, 16), mv(nb8, 16)),
         8, pad, pad - 1, 8, -4),
        ("mc_patch_luma", py_pad, (mv(nb8, 17), mv(nb8, 17)),
         8, pad, pad, 7, -3),
        ("mc_patch_chroma", pu_pad, (mv(nb8, 9), mv(nb8, 9)),
         4, cpad, cpad, 7, -3),
    ]
    grid = [x for x in grid if x[0] in per_frame]
    if rd:   # the MC patches of every leaf size, the dense refine per size
        grid = []
        for bs in (8, 16, 32, 64):
            nb = (ph // bs, pw // bs)
            grid.append((f"mc_patch_luma_{bs}", py_pad,
                         (mv(nb, 17), mv(nb, 17)), bs, pad, pad, 7, -3))
            grid.append((f"mc_patch_chroma_{bs // 2}", pu_pad,
                         (mv(nb, 9), mv(nb, 9)), bs // 2, cpad, cpad, 7, -3))
        for bs in (8, 16, 32):
            nb = (ph // bs, pw // bs)
            grid.append((f"subpel_refine_dense_{bs}", py_pad,
                         (mv(nb, 16), mv(nb, 16)), bs, pad, pad - 1, 8, -4))
    if rect:
        half = lambda reach: mv((ph // 8, pw // 16), reach).repeat_interleave(
            2, 1)
        grid = [("rect_mc_patch_luma", py_pad, (half(17), half(17)), 8, pad,
                 pad, 7, -3),
                ("rect_mc_patch_chroma", pu_pad, (half(9), half(9)), 4, cpad,
                 cpad, 7, -3)]
        sites = []
    for name, plane, (mr, mc), bs, pd, reach, halo, off in grid:
        br, bc, kw = G.grid_tile_args(plane, mr, mc, bs, pd, reach, halo,
                                      off)
        sites.append((name, per_frame.get(name, 0), plane, br, bc, kw))
    return sites


def flat_index(torch, plane, br, bc, th, tw):
    """Flat indices into plane (one plane, or a stack [S, Hp, Wp] with
    [S, N] starts) of every tile element (starts mapped as the kernel
    maps them)."""
    from svt_av1_tpu_torch.ops.gather import clamp_starts
    hp, wp = plane.shape[-2:]
    r, c = clamp_starts(br, bc, hp, wp, th, tw)
    rows = r[..., None] + torch.arange(th, device=plane.device)
    cols = c[..., None] + torch.arange(tw, device=plane.device)
    idx = rows[..., :, None] * wp + cols[..., None, :]
    if plane.dim() == 3:
        s = torch.arange(plane.shape[0], device=plane.device)
        idx = idx + (s * hp * wp).reshape(-1, 1, 1, 1)
    return idx


# (dtype, Hp, Wp, th, tw, nbh, nbw): odd and word-sized tile widths,
# rows that are and are not 4- and 16-byte aligned, tile counts that are
# not a multiple of a CTA's four
AWKWARD = [
    ("uint8", 45, 100, 32, 32, 3, 21),
    ("uint8", 45, 96, 12, 16, 2, 37),
    ("uint8", 37, 53, 11, 11, 3, 21),
    ("int16", 40, 66, 15, 15, 2, 37),
    ("int16", 40, 66, 16, 16, 3, 21),
    ("int32", 49, 177, 15, 15, 3, 21),
    ("int32", 49, 177, 11, 11, 2, 37),
    ("int32", 29, 89, 8, 8, 1, 16),
]


def awkward_starts(torch, gen, n, hp, wp, th, tw):
    """Starts on every edge, negative (counted from the end), past the
    end, and random in [-Hp-2, Hp+2] x [-Wp-2, Wp+2]."""
    fixed_r = [0, hp - th, -1, -hp, hp + 5, -th, hp - th + 1, 3]
    fixed_c = [0, wp - tw, -wp, -1, wp + 7, wp - tw + 1, -tw, 5]
    br = torch.randint(-hp - 2, hp + 3, (n,), generator=gen,
                       dtype=torch.int32)
    bc = torch.randint(-wp - 2, wp + 3, (n,), generator=gen,
                       dtype=torch.int32)
    k = min(n, len(fixed_r))
    br[:k] = torch.tensor(fixed_r[:k], dtype=torch.int32)
    bc[:k] = torch.tensor(fixed_c[:k], dtype=torch.int32)
    return br, bc


def designs_of(G, plane, br, bc, kw):
    """name -> zero-argument launch of the main path's gather (through
    gather_tiles) and of the other designs at the same geometry."""
    th, tw = kw["th"], kw["tw"]
    out = {"main": lambda: G.gather_tiles(plane, br, bc, **kw)}
    for d in G.DESIGNS:
        if d != G.MAIN_DESIGN:
            out[d] = (lambda d=d: G.gather_tiles_design(d, plane, br, bc, th,
                                                        tw))
    return out


def exact(torch, got, want, what):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise AssertionError(f"{what}: max |err| {err}")
    return err


def kernel_phase(torch, MC, G, dev):
    """Hold every gather design against gather_tiles_ref at each
    call-site shape of a 720p P frame, of a 1080p B frame, of a 1080p
    preset-6 B frame and of a 4K 10-bit preset-6 B frame (its sites also
    on int16 planes), and at the awkward shapes; returns the per-site
    records (with the byte bound) and the launches to time at each
    site."""
    gen = torch.Generator().manual_seed(0)
    recs, timed = [], []
    sites = [("720p P", s) for s in call_sites(torch, MC, G, gen, dev, W720,
                                               H720, P720)]
    sites += [("1080p B", s) for s in call_sites(torch, MC, G, gen, dev,
                                                 W1080, H1080, B1080)]
    sites += [("1080p RD B", s) for s in call_sites(
        torch, MC, G, gen, dev, W1080, H1080, RD1080, rd=True)]
    sites += [("4K RD B", s) for s in call_sites(
        torch, MC, G, gen, dev, W4K, H4K, RD1080, rd=True, bd=10)]
    sites += [("1080p P5 rect", s) for s in call_sites(
        torch, MC, G, gen, dev, W1080, H1080, P5_RECT, rd=True, rect=True)]
    for frame, (name, per_frame, plane, br, bc, kw) in sites:
        th, tw = kw["th"], kw["tw"]
        want = G.gather_tiles_ref(plane, br, bc, th, tw)
        impls = designs_of(G, plane, br, bc, kw)
        err = max(exact(torch, fn(), want, f"{d} gather at {name}")
                  for d, fn in impls.items())
        idx = flat_index(torch, plane, br, bc, th, tw)
        touched = torch.zeros(plane.numel(), dtype=torch.bool, device=dev)
        touched[idx.reshape(-1)] = True
        n = br.shape[0]
        nbytes = (int(touched.sum()) * plane.element_size() + 8 * n
                  + n * th * tw * plane.element_size())
        flat = idx.reshape(n, th, tw)
        impls["take"] = lambda flat=flat, plane=plane: torch.take(plane,
                                                                  flat)
        impls["plain"] = (lambda plane=plane, br=br, bc=bc, th=th, tw=tw:
                          G.gather_tiles_ref(plane, br, bc, th, tw))
        recs.append(dict(frame=frame, site=name,
                         launches_per_frame=per_frame,
                         dtype=str(plane.dtype).replace("torch.", ""),
                         plane=list(plane.shape), tiles=n, tile=[th, tw],
                         max_abs_err=err, bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
        timed.append(impls)
    # the 4K sites again on int16 planes (10-bit pixels in the port's
    # container; the path pads its MC and refine planes to int32)
    for frame, (name, _, plane, br, bc, kw) in sites:
        if frame == "4K RD B" and plane.dtype == torch.int32:
            p16 = plane.to(torch.int16)
            exact(torch, G.gather_tiles(p16, br, bc, **kw),
                  G.gather_tiles_ref(p16, br, bc, kw["th"], kw["tw"]),
                  f"main gather at {name}, int16 4K plane")
    for dt, hp, wp, th, tw, nbh, nbw in AWKWARD:
        dtype = getattr(torch, dt)
        plane = torch.randint(0, 256 if dt == "uint8" else 30000, (hp, wp),
                              generator=gen, dtype=torch.int32).to(dtype)
        br, bc = awkward_starts(torch, gen, nbh * nbw, hp, wp, th, tw)
        plane, br, bc = plane.to(dev), br.to(dev), bc.to(dev)
        want = G.gather_tiles_ref(plane, br, bc, th, tw)
        kw = dict(nbh=nbh, nbw=nbw, stride=0, band_off=0, band_h=hp, th=th,
                  tw=tw)
        impls = designs_of(G, plane, br, bc, kw)
        impls["cuda"] = lambda: G.gather_tiles_cuda(plane, br, bc, th, tw)
        for d, fn in impls.items():
            exact(torch, fn(), want, f"{d} gather, {dt} {hp}x{wp} "
                  f"{th}x{tw} x{nbh * nbw}")
    return recs, timed


def live_sites(torch, MC, G, gen, dev, S):
    """(name, launches per P slot, plane stack, base_r, base_c,
    gather_tiles kwargs) at every gather site of the 4-stream 1080p P
    slot (bench.py:221; the batched P step at preset 8 without global
    motion: the u8 ME warp, the i32 cell refine, luma and chroma MC
    patches) with S streams stacked; motion uniform within each site's
    reach."""
    ph, pw = -(-H1080 // 64) * 64, -(-W1080 // 64) * 64
    ry = torch.randint(0, 256, (S, ph, pw), generator=gen,
                       dtype=torch.uint8).to(dev)
    ru = torch.randint(0, 256, (S, ph // 2, pw // 2), generator=gen,
                       dtype=torch.uint8).to(dev)
    pad, cpad, search = 17, 9, 16

    def mv(shape, reach):
        return torch.randint(-reach, reach + 1, (S, *shape), generator=gen,
                             dtype=torch.int32).to(dev)

    ref_pad = MC.edge_pad(ry, search, search, search, search)
    th, tw = ph // 32, pw // 32
    cen = mv((th, tw, 2), 13)
    ar = lambda k: torch.arange(k, dtype=torch.int32, device=dev)
    br = (ar(th)[:, None] * 32 + search + cen[..., 0]).reshape(S, -1)
    bc = (ar(tw)[None, :] * 32 + search + cen[..., 1]).reshape(S, -1)
    sites = [("warp_by_centers", LIVE1080["warp_by_centers"], ref_pad, br,
              bc, dict(nbh=th, nbw=tw, stride=32, band_off=0,
                       band_h=2 * search + 32, th=32, tw=32))]
    py_pad = MC.pad_for_filter(ry, pad)
    pu_pad = MC.pad_for_filter(ru, cpad)
    nb8 = (ph // 8, pw // 8)
    for name, plane, reach, bs, pd, rch, halo, off in (
            ("cell_refine", py_pad, 16, 8, pad, pad - 1, 8, -4),
            ("mc_patch_luma", py_pad, 17, 8, pad, pad, 7, -3),
            ("mc_patch_chroma", pu_pad, 9, 4, cpad, cpad, 7, -3)):
        br, bc, kw = G.grid_tile_args(plane, mv(nb8, reach), mv(nb8, reach),
                                      bs, pd, rch, halo, off)
        sites.append((name, LIVE1080[name], plane, br, bc, kw))
    return sites


def batched_kernel_phase(torch, MC, G, dev):
    """The gather on stacks of planes: exact against gather_tiles_ref at
    every 4-stream 1080p P-slot site for S = 1, 2, 4 in one launch each,
    on stacks of awkward shapes (negative, clamped and past-the-end
    starts, odd tile widths, u8 / int16 / int32 planes), and at the
    32-bit limit (a plane of 2^31 bytes must raise; a stack past 2^31
    bytes whose planes are each below it must gather exactly).  Returns
    the S = 4 records (with the byte bound) and the launches to time at
    each site: the batched launch, S separate launches of the plain
    2-D entry, torch.take and the plain version."""
    gen = torch.Generator().manual_seed(1)
    recs, timed = [], []
    for S in LIVE_S:
        for name, per_slot, plane, br, bc, kw in live_sites(
                torch, MC, G, gen, dev, S):
            th, tw = kw["th"], kw["tw"]
            want = G.gather_tiles_ref(plane, br, bc, th, tw)
            n0 = G.gather_tiles.launches
            got = G.gather_tiles(plane, br, bc, **kw)
            if G.gather_tiles.launches != n0 + 1:
                raise AssertionError(f"batched gather at {name}, S={S}: "
                                     f"not one launch")
            err = exact(torch, got, want, f"batched gather at {name}, "
                        f"S={S}")
            if S != LIVE_S[-1]:
                continue
            idx = flat_index(torch, plane, br, bc, th, tw)
            touched = torch.zeros(plane.numel(), dtype=torch.bool,
                                  device=dev)
            touched[idx.reshape(-1)] = True
            n = br.numel()
            es = plane.element_size()
            nbytes = int(touched.sum()) * es + 8 * n + n * th * tw * es
            flat = idx.reshape(S, -1, th, tw)
            impls = {
                "main": (lambda plane=plane, br=br, bc=bc, kw=kw:
                         G.gather_tiles(plane, br, bc, **kw)),
                "separate": (lambda plane=plane, br=br, bc=bc, kw=kw:
                             [G.gather_tiles(plane[s], br[s], bc[s], **kw)
                              for s in range(plane.shape[0])]),
                "take": (lambda flat=flat, plane=plane:
                         torch.take(plane, flat)),
                "plain": (lambda plane=plane, br=br, bc=bc, th=th, tw=tw:
                          G.gather_tiles_ref(plane, br, bc, th, tw))}
            recs.append(dict(frame="4x1080p P slot", site=name,
                             launches_per_frame=per_slot, streams=S,
                             dtype=str(plane.dtype).replace("torch.", ""),
                             plane=list(plane.shape), tiles=n,
                             tile=[th, tw], max_abs_err=err, bytes=nbytes,
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
            timed.append(impls)
    for dt, hp, wp, th, tw, nbh, nbw in AWKWARD:
        dtype = getattr(torch, dt)
        S = 3
        plane = torch.randint(0, 256 if dt == "uint8" else 30000,
                              (S, hp, wp), generator=gen,
                              dtype=torch.int32).to(dtype).to(dev)
        st = [awkward_starts(torch, gen, nbh * nbw, hp, wp, th, tw)
              for _ in range(S)]
        br = torch.stack([a for a, _ in st]).to(dev)
        bc = torch.stack([b for _, b in st]).to(dev)
        want = G.gather_tiles_ref(plane, br, bc, th, tw)
        kw = dict(nbh=nbh, nbw=nbw, stride=0, band_off=0, band_h=hp, th=th,
                  tw=tw)
        impls = designs_of(G, plane, br, bc, kw)
        impls["cuda"] = lambda: G.gather_tiles_cuda(plane, br, bc, th, tw)
        for d, fn in impls.items():
            exact(torch, fn(), want, f"{d} gather, stack of {S} {dt} "
                  f"{hp}x{wp} {th}x{tw} x{nbh * nbw}")
    limit_checks(torch, G, dev)
    return recs, timed


def limit_checks(torch, G, dev):
    """The 32-bit limit: the wrapper and the extension both refuse a
    plane of 2^31 bytes; a stack past 2^31 bytes (two planes of 1.09 GB)
    gathers through 64-bit plane offsets, exactly."""
    side = 46341
    big = torch.zeros((1, side, side), dtype=torch.uint8, device=dev)
    r = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    try:
        G.gather_tiles_cuda(big, r, r, 8, 8)
    except ValueError:
        pass
    else:
        raise AssertionError("a 2^31-byte plane did not raise")
    out = torch.empty((1, 4, 8, 8), dtype=torch.uint8, device=dev)
    try:
        G._kernel()(0, big.data_ptr(), 1, side, side, 1, r.data_ptr(),
                    r.data_ptr(), out.data_ptr(), 4, 8, 8,
                    G._raw_stream(big.get_device()))
    except RuntimeError:
        pass
    else:
        raise AssertionError("the extension took a 2^31-byte plane")
    del big
    hw = 33000
    stack = torch.randint(0, 256, (2, hw, hw), dtype=torch.uint8,
                          device=dev)
    br = torch.tensor([[0, hw - 16, -1], [hw - 64, hw - 8, 7]],
                      dtype=torch.int32, device=dev)
    bc = torch.tensor([[0, hw - 16, hw + 3], [hw - 64, hw - 8, -5]],
                      dtype=torch.int32, device=dev)
    exact(torch, G.gather_tiles_cuda(stack, br, bc, 8, 8),
          G.gather_tiles_ref(stack, br, bc, 8, 8),
          "gather from a 2.18 GB stack of two planes")
    del stack
    torch.cuda.empty_cache()


def intra_batch_path(torch, svt):
    """bench.py:115 at its own size: 854x480 all-intra, qp 40,
    device_batch 32, no recon; one 32-frame warm-up batch, then 64 timed
    frames (two batches) sent and drained.  Each batch's wall is read
    around Encoder._dispatch_inbox and split into the wavefront step and
    the in-loop filters (each synchronised), the host entropy (the
    thread pool's wall: from the device outputs' arrival to the last
    packet) and the rest (the uploads and the device->host copies).
    Returns (timed packets, per-batch records, timed seconds, peak
    GiB)."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline import intra_encoder as IE
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    frames = [synthetic_frame(W480, H480, seed=i) for i in range(N480)]
    enc = Encoder(svt.EncoderConfig(width=W480, height=H480, qp=40,
                                    device_batch=B480, recon_output=False),
                  device="cuda")
    recs, cur = [], [{}]

    def sync_timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            cur[0][key] = cur[0].get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    inbox, batch = enc._dispatch_inbox, enc._intra_batch

    def dispatch():
        cur[0] = {"frames": len(enc._inbox)}
        torch.cuda.synchronize()
        t = time.perf_counter()
        inbox()
        cur[0]["total_s"] = time.perf_counter() - t
        recs.append(cur[0])

    step_plain = IE.frame_step
    IE.frame_step = sync_timed("step_s", step_plain)
    enc._intra_postproc = sync_timed("postproc_s", enc._intra_postproc)
    enc._intra_batch = sync_timed("device_s", batch)
    enc._dispatch_inbox = dispatch
    try:
        for f in frames[:B480]:
            enc.send_picture(f)
        warm = [enc.get_packet() for _ in range(B480)]
        recs.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for f in frames:
            enc.send_picture(f)
        pkts = [enc.get_packet() for _ in frames]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        IE.frame_step = step_plain
    if any(p is None for p in warm + pkts) or enc.get_packet() is not None:
        raise AssertionError("the 480p batches held back or lost packets")
    for r in recs:
        r["entropy_s"] = r["total_s"] - r["device_s"]
        r["other_s"] = r["device_s"] - r["step_s"] - r["postproc_s"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return pkts, recs, secs, peak


def live_path(torch, G, svt):
    """bench.py:221 at its own size: 4 lockstep 1920x1080 IPPP streams
    (qp 40, global motion off) through MultiStreamEncoder.send, 2
    warm-up slots (the keyframe and a P slot), then 12 timed P slots.
    Per slot: the wall, the batched P step (synchronised), the host
    entropy of the 4 streams (the thread pool's wall) and the gather
    launches.  The source frames are made before the timed part.
    Returns (per-slot records, timed seconds, peak GiB, gather launches
    of the whole run, the packets of every slot)."""
    import numpy as np
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline import inter_encoder as PE
    from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder
    cfg = svt.EncoderConfig(width=W1080, height=H1080, qp=40,
                            intra_period=-1, pred_structure=0,
                            recon_output=False,
                            scene_change_detection=False,
                            enable_global_motion=False)
    bases = [synthetic_frame(W1080, H1080, seed=s)
             for s in range(N_STREAMS)]

    def slot(i):
        out = []
        for s in range(N_STREAMS):
            f = synthetic_frame(W1080, H1080, seed=s)
            f.y[:] = np.roll(bases[s].y, (i, 2 * i + s), (0, 1))
            out.append(f)
        return out

    slots = [slot(i) for i in range(LIVE_WARM + LIVE_TIMED)]
    ms = MultiStreamEncoder(cfg, N_STREAMS, device="cuda")
    cur = [{}]
    build = PE.build_p_frame_encoder_dyn

    def timed_build(*a, **kw):
        step = build(*a, **kw)

        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            cur[0]["step_s"] = time.perf_counter() - t
            return out
        return run

    code = ms._code

    def timed_code(make):
        t = time.perf_counter()
        out = code(make)
        cur[0]["entropy_s"] = time.perf_counter() - t
        return out

    PE.build_p_frame_encoder_dyn = timed_build
    ms._code = timed_code
    recs, pkts = [], []
    G.gather_tiles.launches = 0
    try:
        for i, fr in enumerate(slots):
            if i == LIVE_WARM:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t_timed = time.perf_counter()
            cur[0] = {}
            n0 = G.gather_tiles.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            pkts.append(ms.send(fr))
            torch.cuda.synchronize()
            cur[0]["total_s"] = time.perf_counter() - t
            cur[0]["gathers"] = G.gather_tiles.launches - n0
            cur[0]["bytes"] = [len(p.payload) for p in pkts[-1]]
            recs.append(cur[0])
        secs = time.perf_counter() - t_timed
    finally:
        PE.build_p_frame_encoder_dyn = build
    launches = G.gather_tiles.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return recs, secs, peak, launches, pkts


def batch_parity(svt):
    """The batched entry points on the card and on the CPU: a 192x128
    all-intra clip of 6 frames at device_batch 4 (a partial last batch
    flushed by get_packet), three lockstep 192x128 streams
    (MultiStreamEncoder, 3 slots), two 192x128 GOPs of 4 frames in
    lockstep (GopShardedEncoder), two lockstep 192x128 streams under
    VBR (4 slots) and the CLI at --nch 2; TUs and IVF
    files must be identical.  Returns the TU byte sizes."""
    from svt_av1_tpu_torch.app import enc_app
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.parallel import GopShardedEncoder
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder
    w, h = 192, 128
    flat = dict(width=w, height=h, qp=40, intra_period=-1, pred_structure=0,
                scene_change_detection=False, recon_output=True)

    def intra(device):
        enc = Encoder(svt.EncoderConfig(width=w, height=h, qp=40,
                                        device_batch=4, recon_output=True),
                      device=device)
        for i in range(6):
            enc.send_picture(synthetic_frame(w, h, seed=100 + i))
        enc.send_picture(None)
        return list(iter(enc.get_packet, None))

    def multi(device):
        ms = MultiStreamEncoder(svt.EncoderConfig(**flat), 3, device=device)
        return [p for i in range(3) for p in ms.send(
            [synthetic_frame(w, h, seed=110 + 10 * s + i)
             for s in range(3)])]

    def gop(device):
        enc = GopShardedEncoder(svt.EncoderConfig(**flat), 2, 4,
                                device=device)
        return list(enc.encode_all([synthetic_frame(w, h, seed=130 + i)
                                    for i in range(8)]))

    def multi_vbr(device):
        ms = MultiStreamEncoder(svt.EncoderConfig(
            **flat, rate_control_mode=2, target_bit_rate=300_000), 2,
            device=device)
        return [p for i in range(4) for p in ms.send(
            [synthetic_frame(w, h, seed=160 + 10 * s + i)
             for s in range(2)])]

    sizes = {}
    for name, run, n in (("192x128 all-intra, device_batch 4, 6 frames",
                          intra, 6),
                         ("3 x 192x128 MultiStreamEncoder, 3 slots",
                          multi, 9),
                         ("192x128 GopShardedEncoder G=2 L=4", gop, 8),
                         ("2 x 192x128 MultiStreamEncoder VBR, 4 slots",
                          multi_vbr, 8)):
        out = {d: run(d) for d in ("cuda", "cpu")}
        if len(out["cuda"]) != n or len(out["cpu"]) != n:
            raise AssertionError(f"{name}: expected {n} TUs")
        for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
            if a.payload != b.payload or a.pts != b.pts:
                raise AssertionError(f"{name}: card and CPU TUs differ at "
                                     f"{i}")
            for p in ("y", "u", "v") if a.recon is not None else ():
                if (getattr(a.recon, p) != getattr(b.recon, p)).any():
                    raise AssertionError(f"{name}: card/CPU recon differ: "
                                         f"TU {i} {p}")
        sizes[name] = [len(p.payload) for p in out["cuda"]]
    with tempfile.TemporaryDirectory() as d:
        ins = []
        for ch in range(2):
            path = Path(d) / f"in{ch}.yuv"
            with open(path, "wb") as fh:
                for i in range(3):
                    f = synthetic_frame(w, h, seed=150 + 10 * ch + i)
                    for pl in (f.y, f.u, f.v):
                        fh.write(pl.tobytes())
            ins.append(str(path))
        ivf = {}
        for device in ("cuda", "cpu"):
            outs = [str(Path(d) / f"{device}{ch}.ivf") for ch in range(2)]
            rc = enc_app.main(["-i", ",".join(ins), "-b", ",".join(outs),
                               "-w", str(w), "-h", str(h), "-q", "40",
                               "--intra-period", "2", "--nch", "2",
                               "--device", device])
            if rc != 0:
                raise AssertionError(f"enc_app --nch 2 --device {device} "
                                     f"exited {rc}")
            ivf[device] = [Path(o).read_bytes() for o in outs]
        if ivf["cuda"] != ivf["cpu"]:
            raise AssertionError("CLI --nch 2: card and CPU IVF files differ")
        sizes["192x128 CLI --nch 2 (IVF bytes)"] = [len(b) for b in
                                                     ivf["cuda"]]
    return sizes


def kernel_counts(torch, svt):
    """Device operations (kernels, copies, fills) of the 480p all-intra
    device work (wavefront and in-loop filters) for one 32-frame batch
    and for one frame, from one torch.profiler session each, read from
    the raw trace events (key_averages() takes tens of seconds over
    200k events); run last (a profiler session slows later launches).
    Returns {frames: (operations, profiled seconds)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(svt.EncoderConfig(width=W480, height=H480, qp=40,
                                    device_batch=B480, recon_output=False),
                  device="cuda")
    frames = [synthetic_frame(W480, H480, seed=i) for i in range(B480)]
    out = {}
    for fr in (frames, frames[:1]):
        enc._intra_batch(fr, 160, part16=False, postproc=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enc._intra_batch(fr, 160, part16=False, postproc=True)
            torch.cuda.synchronize()
        n = sum(e.device_type() == DeviceType.CUDA
                for e in prof.profiler.kineto_results.events())
        out[len(fr)] = (n, time.perf_counter() - t)
    return out


def timing_phase(recs, timed):
    """Time each design, torch.take and the plain version at each call
    site: event ms and host us at every site first, then device us at
    every site (a profiler session may slow every later launch).  Two
    rounds in turns, forward then reversed; each figure is the mean of
    both.  One profiler session whose figure is dropped comes before the
    device rounds: the first session of a process may report no kernel."""
    runs = []
    for impls in timed:
        order = list(impls)
        r = {d: [] for d in order}
        for rnd in (order, order[::-1]):
            for d in rnd:
                r[d].append((cuda_ms(impls[d]), host_us(impls[d])))
        runs.append(r)
    device_us(timed[0]["main"])
    for impls, r in zip(timed, runs):
        order = list(impls)
        for rnd in (order, order[::-1]):
            for d in rnd:
                r[d].append(device_us(impls[d]))
    for rec, impls, r in zip(recs, timed, runs):
        for d in impls:
            (ev0, hs0), (ev1, hs1), dv0, dv1 = r[d]
            rec[d] = dict(ms=(ev0 + ev1) / 2, host_us=(hs0 + hs1) / 2,
                          device_us=None if None in (dv0, dv1)
                          else (dv0 + dv1) / 2)
        rec["plain_ms"] = rec["plain"]["ms"]
        print(f"  {rec['frame']} {rec['site']:24s} {rec['dtype']:5s} "
              f"N={rec['tiles']:5d} "
              f"{rec['tile'][0]}x{rec['tile'][1]} bound "
              f"{rec['bound_ms'] * 1e3:.2f} us", flush=True)
        for d in impls:
            x = rec[d]
            dv = ("not measured" if x["device_us"] is None
                  else f"{x['device_us']:8.2f} us")
            print(f"      {d:6s} device {dv}  event {x['ms']:.4f} ms  "
                  f"host {x['host_us']:6.2f} us", flush=True)


def main_path(torch, G, svt, cfg_kw):
    """720p IPPP through the user entry points; returns (packets,
    per-frame seconds, gather launches during the run)."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    frames = [synthetic_frame(W720, H720, seed=i) for i in range(N_MAIN)]
    enc = Encoder(svt.EncoderConfig(**cfg_kw), device="cuda")
    pkts, secs = [], []
    G.gather_tiles.launches = 0
    for f in frames:
        t = time.time()
        enc.send_picture(f)
        pkt = enc.get_packet()
        torch.cuda.synchronize()
        secs.append(time.time() - t)
        pkts.append(pkt)
    enc.send_picture(None)
    launches = G.gather_tiles.launches
    if enc.get_packet() is not None:
        raise AssertionError("IPPP encoder held back a packet")
    return pkts, secs, launches


def hierb_path(torch, G, svt, cfg_kw):
    """1080p hier-B through the user entry points: a keyframe, then one
    mini-GOP sent frame by frame and flushed.  Returns (TUs in decode
    order, keyframe seconds, {display index: seconds} and {display index:
    gather launches} of each coded frame, gather launches during the
    run, the encoder).  Each coded frame's time (device step + host
    entropy) is read around Encoder._dispatch_code, with the card
    synchronised."""
    from svt_av1_tpu_torch.io.yuv import synthetic_clip
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    frames = synthetic_clip(W1080, H1080, N_HIERB)
    enc = Encoder(svt.EncoderConfig(**cfg_kw), device="cuda")
    code = enc._dispatch_code
    secs, counts = {}, {}

    def timed_code(step, *args, **kw):
        torch.cuda.synchronize()
        n0 = G.gather_tiles.launches
        t = time.time()
        code(step, *args, **kw)
        torch.cuda.synchronize()
        secs[step.disp] = time.time() - t
        counts[step.disp] = G.gather_tiles.launches - n0

    enc._dispatch_code = timed_code
    G.gather_tiles.launches = 0
    t = time.time()
    enc.send_picture(frames[0])
    torch.cuda.synchronize()
    key_s = time.time() - t
    for f in frames[1:]:
        enc.send_picture(f)
    enc.send_picture(None)
    launches = G.gather_tiles.launches
    tus = []
    while True:
        pkt = enc.get_packet()
        if pkt is None:
            break
        tus.append(pkt)
    return tus, key_s, secs, counts, launches, enc


def ldb_path(torch, G, svt, cfg_kw):
    """1080p low-delay B through the user entry points, frame by frame.
    Returns (packets, per-frame seconds, per-frame gather launches)."""
    from svt_av1_tpu_torch.io.yuv import synthetic_clip
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    frames = synthetic_clip(W1080, H1080, N_LDB)
    enc = Encoder(svt.EncoderConfig(**cfg_kw), device="cuda")
    pkts, secs, launches = [], [], []
    for f in frames:
        G.gather_tiles.launches = 0
        t = time.time()
        enc.send_picture(f)
        pkt = enc.get_packet()
        torch.cuda.synchronize()
        secs.append(time.time() - t)
        launches.append(G.gather_tiles.launches)
        pkts.append(pkt)
    enc.send_picture(None)
    if enc.get_packet() is not None:
        raise AssertionError("low-delay-B encoder held back a packet")
    return pkts, secs, launches


def vod_path(torch, G, svt, cfg_kw, frames):
    """The 4K 10-bit VOD config through the user entry points: a
    keyframe, then one mini-GOP sent frame by frame and flushed.  Each
    coded frame's wall time is read around Encoder._code_key_anchor /
    _dispatch_code with the card synchronised, and split into the
    device step (the keyframe wavefront and in-loop filters with the
    fetch of its outputs, or the P / B step; synchronised), host
    restoration (_lr_process), host picture analysis for AQ
    (analysis.analyze: the analysis of frame d runs just before d is
    coded and is charged to d, its wall time included) and host entropy
    + OBUs (_make_packet / _make_inter_packet); the rest is the
    device->host copies, the uploads and glue.  Returns (TUs in decode order,
    {display index: record}, gather launches during the run, the
    encoder)."""
    from svt_av1_tpu_torch.pipeline import analysis as AN
    from svt_av1_tpu_torch.pipeline import inter_encoder as PE
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(svt.EncoderConfig(**cfg_kw), device="cuda")
    recs = {}
    cur = [{}]                     # the record time is charged to

    def timed(key, fn, sync):
        def run(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            cur[0][key] = cur[0].get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    def timed_builder(build):
        return lambda *a, **kw: timed("step", build(*a, **kw), True)

    def lr_process(frame, planes, deb):
        out = lr_plain(frame, planes, deb)
        cur[0]["lr_types"] = ["none" if p is None else
                              {2: "wiener", 3: "sgrproj"}[p["type"]]
                              for p in (out or [None] * 3)]
        cur[0]["lr_units_on"] = sum(int(p["use"].sum()) for p in out or ()
                                    if p is not None)
        return out

    def frame(disp, fn):
        def run(*args, **kw):
            rec = dict(cur[0])
            pre = rec.pop("analysis", 0.0)     # ran just before the frame
            rec["analysis_s"] = pre
            cur[0] = rec
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n0 = G.gather_tiles.launches
            t = time.perf_counter()
            fn(*args, **kw)
            torch.cuda.synchronize()
            rec["total_s"] = time.perf_counter() - t + pre
            rec["gathers"] = G.gather_tiles.launches - n0
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            rec["analysis_s"] += rec.pop("analysis", 0.0)
            recs[disp(args)] = rec
            cur[0] = {}
        return run

    saved = (AN.analyze, PE.build_p_frame_encoder_dyn,
             PE.build_b_frame_encoder_dyn)
    lr_plain = enc._lr_process
    AN.analyze = timed("analysis", AN.analyze, False)
    PE.build_p_frame_encoder_dyn = timed_builder(saved[1])
    PE.build_b_frame_encoder_dyn = timed_builder(saved[2])
    enc._lr_process = timed("lr", lr_process, False)
    enc._intra_dispatch = timed("step", enc._intra_dispatch, True)
    enc._make_packet = timed("entropy", enc._make_packet, False)
    enc._make_inter_packet = timed("entropy", enc._make_inter_packet, False)
    enc._code_key_anchor = frame(lambda a: a[0], enc._code_key_anchor)
    enc._dispatch_code = frame(lambda a: a[0].disp, enc._dispatch_code)
    G.gather_tiles.launches = 0
    try:
        for f in frames:
            enc.send_picture(f)
        enc.send_picture(None)
    finally:
        (AN.analyze, PE.build_p_frame_encoder_dyn,
         PE.build_b_frame_encoder_dyn) = saved
    launches = G.gather_tiles.launches
    tus = []
    while (pkt := enc.get_packet()) is not None:
        tus.append(pkt)
    for r in recs.values():
        r["step_s"] = r.pop("step", 0.0)
        r["lr_s"] = r.pop("lr", 0.0)
        r["entropy_s"] = r.pop("entropy", 0.0)
        r["other_s"] = r["total_s"] - r["step_s"] - r["lr_s"] \
            - r["entropy_s"] - r["analysis_s"]
    return tus, recs, launches, enc


def psnr_luma(frame, recon, bd: int) -> float:
    import numpy as np
    err = frame.y.astype(np.float64) - recon.y.astype(np.float64)
    mse = float((err * err).mean())
    return 99.0 if mse == 0 else 10 * np.log10(((1 << bd) - 1) ** 2 / mse)


def drive(enc, frames, qps=None):
    """Send frames (each after its push_qp override when qps is given),
    draining after every send and after the flush; TUs in decode
    order."""
    out = []
    for i, f in enumerate(frames):
        if qps is not None:
            enc.push_qp(qps[i] if i < len(qps) else None)
        enc.send_picture(f)
        while (p := enc.get_packet()) is not None:
            out.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


def cli_parity(flags):
    """The port's CLI in this process at --device cuda and --device cpu
    on the same synthetic input under flags (a QP file is written for
    "{qp}"); the IVF files must be byte-identical.  Returns their
    size."""
    from svt_av1_tpu_torch.app import enc_app
    with tempfile.TemporaryDirectory() as d:
        qp = Path(d) / "qp.txt"
        qp.write_text("30\n-1\n45\n20\n")
        ivf = {}
        for device in ("cuda", "cpu"):
            out = Path(d) / f"{device}.ivf"
            rc = enc_app.main([f.format(qp=qp) for f in flags]
                              + ["-b", str(out), "--device", device])
            if rc != 0:
                raise AssertionError(f"enc_app --device {device} exited {rc}")
            ivf[device] = out.read_bytes()
    if ivf["cuda"] != ivf["cpu"]:
        raise AssertionError(f"CLI {flags}: card and CPU IVF files differ")
    return len(ivf["cuda"])


def parity_phase(svt):
    """Small clips on the card and on the CPU: IPPP at 320x192, hier-B
    at 192x128 (levels 2, 6 frames, so the flush codes a truncated
    span), LDB at 320x192, tiled IPPP at 320x192 with look-ahead and
    push_qp, at the RD presets hier-B at 192x128 (preset 6, levels 3),
    IPPP and LDB at 320x192 (preset 7), hier-B with AQ 2 at 192x128, the
    4K VOD config at 200x136 (9 frames of its clip), hier-B at preset 5
    and IPPP at preset 0 at 192x128, and under rate control hier-B VBR
    at 192x128 and LDB CVBR at 320x192; TUs must be identical.  Then
    the CLI (also at --bit-depth 10).  Returns the TU byte sizes."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame, vod_clip
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    small = dict(width=320, height=192, qp=40, intra_period=-1,
                 recon_output=True)
    cases = [
        ("320x192 IPPP", dict(width=320, height=192, qp=40, intra_period=-1,
                              pred_structure=0,
                              scene_change_detection=False,
                              recon_output=True), 10, 3, 3),
        ("192x128 hier-B", dict(width=192, height=128, qp=40,
                                intra_period=-1, pred_structure=2,
                                hierarchical_levels=2, compound_mode=1,
                                scene_change_detection=False,
                                recon_output=True), 20, 6, 11),
        ("320x192 LDB", dict(small, pred_structure=1), 30, 4, 4),
        ("320x192 IPPP, 2x2 tiles, look-ahead 3, push_qp",
         dict(small, pred_structure=0, tile_columns_log2=1,
              tile_rows_log2=1, look_ahead_distance=3), 40, 5, 5),
        ("192x128 hier-B preset 6 (levels 3, three-reference frames)",
         dict(width=192, height=128, qp=40, intra_period=-1,
              pred_structure=2, hierarchical_levels=3, compound_mode=1,
              scene_change_detection=False, enc_mode=6,
              recon_output=True), 50, 9, 17),
        ("320x192 IPPP preset 7",
         dict(small, pred_structure=0, scene_change_detection=False,
              enc_mode=7), 60, 4, 4),
        ("320x192 LDB preset 7", dict(small, pred_structure=1, enc_mode=7),
         70, 4, 4),
    ]
    cases += [
        ("192x128 hier-B, AQ 2 (per-SB delta-q)",
         dict(width=192, height=128, qp=40, intra_period=-1,
              pred_structure=2, hierarchical_levels=2, compound_mode=1,
              enable_adaptive_quantization=2, scene_change_detection=False,
              recon_output=True), 80, 7, 13),
        ("200x136 4K-VOD config (10-bit, preset 6, restoration, AQ)",
         dict(VOD_KW, width=200, height=136), None, 9, 17),
        ("192x128 hier-B preset 5 (tx-type search, rect leaves, rich "
         "intra)", dict(width=192, height=128, qp=40, intra_period=-1,
                        pred_structure=2, hierarchical_levels=2,
                        compound_mode=1, scene_change_detection=False,
                        enc_mode=5, recon_output=True), 90, 5, 9),
        ("192x128 IPPP preset 0",
         dict(width=192, height=128, qp=40, intra_period=-1,
              pred_structure=0, scene_change_detection=False, enc_mode=0,
              recon_output=True), 95, 3, 3),
        ("192x128 hier-B VBR (the GOP planner)",
         dict(width=192, height=128, intra_period=-1, pred_structure=2,
              hierarchical_levels=2, compound_mode=1, rate_control_mode=2,
              target_bit_rate=400_000, scene_change_detection=False,
              recon_output=True), 100, 9, 17),
        ("320x192 LDB CVBR", dict(small, pred_structure=1,
                                  rate_control_mode=3,
                                  target_bit_rate=300_000), 105, 5, 5),
    ]
    qps = [30, None, 45, 20]
    sizes = {}
    for name, kw, seed, n, n_tus in cases:
        if seed is None:
            frames = vod_clip(kw["width"], kw["height"], n)
        else:
            frames = [synthetic_frame(kw["width"], kw["height"],
                                      seed=seed + i) for i in range(n)]
        out = {}
        for device in ("cuda", "cpu"):
            out[device] = drive(Encoder(svt.EncoderConfig(**kw),
                                        device=device), frames,
                                qps if "push_qp" in name else None)
        if len(out["cuda"]) != n_tus or len(out["cpu"]) != n_tus:
            raise AssertionError(f"{name}: expected {n_tus} TUs")
        for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
            if a.payload != b.payload:
                raise AssertionError(f"{name}: card and CPU TUs differ at "
                                     f"{i}")
            if (a.recon is None) != (b.recon is None):
                raise AssertionError(f"{name}: recon presence differs at {i}")
            for p in ("y", "u", "v") if a.recon is not None else ():
                if (getattr(a.recon, p) != getattr(b.recon, p)).any():
                    raise AssertionError(f"{name}: card/CPU recon differ: "
                                         f"TU {i} {p}")
        sizes[name] = [len(p.payload) for p in out["cuda"]]
    sizes["320x192 CLI LDB, tiles, QP file (IVF bytes)"] = [cli_parity(
        ["-w", "320", "-h", "192", "-q", "40", "--synthetic", "4",
         "--intra-period", "-1", "--pred-struct", "1", "--tiles-log2", "1",
         "--qp-file", "{qp}"])]
    sizes["192x128 CLI hier-B --preset 7 (IVF bytes)"] = [cli_parity(
        ["-w", "192", "-h", "128", "-q", "40", "--synthetic", "5",
         "--intra-period", "-1", "--pred-struct", "2",
         "--hierarchical-levels", "2", "--preset", "7"])]
    sizes["192x128 CLI IPPP --bit-depth 10 (IVF bytes)"] = [cli_parity(
        ["-w", "192", "-h", "128", "-q", "40", "--synthetic", "3",
         "--bit-depth", "10", "--intra-period", "-1", "--pred-struct",
         "0"])]
    return sizes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()

    t0 = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not (ROOT / "svt_av1_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(svt_av1_tpu_torch/ not found)")
    sys.path.insert(0, str(ROOT))
    import svt_av1_tpu_torch as svt
    from svt_av1_tpu_torch.entropy import backend
    from svt_av1_tpu_torch.ops import gather as G
    from svt_av1_tpu_torch.ops import mc as MC
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}", flush=True)
    phase("device", t0)

    t = time.time()
    with ThreadPoolExecutor(2) as ex:      # nvcc and g++ side by side
        jobs = [ex.submit(G.kernel_module), ex.submit(backend._lib)]
        for j in jobs:
            j.result()
    build_s = time.time() - t
    phase("build (nvcc gather_tiles.cu + g++ entropy.cpp)", t)

    t = time.time()
    dev = torch.device("cuda")
    sites, timed = kernel_phase(torch, MC, G, dev)
    phase("kernel designs vs plain (exact) at 720p P, 1080p B, 1080p RD B, "
          "4K 10-bit RD B call-site and awkward shapes", t)

    t = time.time()
    bsites, btimed = batched_kernel_phase(torch, MC, G, dev)
    phase("batched gather vs plain (exact) at the 4-stream 1080p P-slot "
          "sites for S = 1, 2, 4, on stacks of awkward shapes, at the "
          "32-bit limit", t)

    t = time.time()
    cfg_kw = dict(width=W720, height=H720, qp=40, intra_period=-1,
                  pred_structure=0, recon_output=False,
                  scene_change_detection=False, enc_mode=8,
                  stat_report=True)
    pkts, secs, launches = main_path(torch, G, svt, cfg_kw)
    if len(pkts) != N_MAIN or any(p is None or not p.payload for p in pkts):
        raise AssertionError("expected 8 non-empty packets")
    if not pkts[0].is_keyframe or any(p.is_keyframe for p in pkts[1:]):
        raise AssertionError("expected one keyframe then P frames")
    if launches != 6 * (N_MAIN - 1):
        raise AssertionError(f"the main path launched the gather kernel "
                             f"{launches} times, not 6 per P frame")
    psnr_y = [p.psnr[0] for p in pkts]
    if not all(25.0 < v < 60.0 for v in psnr_y):
        raise AssertionError(f"PSNR-Y out of range for qp 40: {psnr_y}")
    total = sum(secs)
    print(f"  720p IPPP: {N_MAIN} packets, {sum(len(p.payload) for p in pkts)}"
          f" bytes, PSNR-Y {min(psnr_y):.2f}..{max(psnr_y):.2f} dB, "
          f"gather launches {launches}", flush=True)
    print(f"  frame ms: key {secs[0] * 1e3:.1f}, P mean "
          f"{sum(secs[1:]) / (N_MAIN - 1) * 1e3:.1f}; "
          f"{N_MAIN / total:.3f} fps incl. first-call setup", flush=True)
    phase("main path 720p low-delay P (1 key + 7 P)", t)

    t = time.time()
    hierb_kw = dict(width=W1080, height=H1080, qp=40, intra_period=-1,
                    pred_structure=2, hierarchical_levels=3,
                    compound_mode=1, enable_deblocking=True,
                    enable_cdef=True, recon_output=False,
                    scene_change_detection=False, enc_mode=8,
                    stat_report=True)
    tus, key_s, bsecs, _, b_launches, _ = hierb_path(torch, G, svt,
                                                     hierb_kw)
    coded = [p for p in tus if p.recon is not None]
    shows = [p for p in tus if p.recon is None]
    if (len(tus) != 2 * N_HIERB - 1 or len(coded) != N_HIERB
            or not all(p.payload for p in tus)):
        raise AssertionError(f"expected {N_HIERB} coded and {N_HIERB - 1} "
                             f"show-existing TUs, got {len(coded)} and "
                             f"{len(shows)}")
    if ([p.display_idx for p in coded] != [0, 8, 4, 2, 1, 3, 6, 5, 7]
            or not coded[0].is_keyframe
            or any(p.show or p.is_keyframe for p in coded[1:])
            or sorted(p.display_idx for p in shows) != list(range(1, 9))):
        raise AssertionError("hier-B TUs out of the mini-GOP's decode order")
    want_b = BASE_P_LAUNCHES + sum(B1080.values()) * (N_HIERB - 2)
    if b_launches != want_b:
        raise AssertionError(f"the hier-B path launched the gather kernel "
                             f"{b_launches} times, not {want_b} (5 for the "
                             f"base P frame, 13 per B frame)")
    comp = sum(p.compound_cells for p in coded[2:])
    if comp <= 0:
        raise AssertionError("no compound cell in the B frames: the jnt "
                             "path ran on nothing")
    b_psnr = [p.psnr[0] for p in coded]
    if not all(25.0 < v < 60.0 for v in b_psnr):
        raise AssertionError(f"hier-B PSNR-Y out of range: {b_psnr}")
    b_mean = sum(bsecs[d] for d in range(1, 8)) / 7
    print(f"  1080p hier-B: {len(coded)} coded + {len(shows)} "
          f"show-existing TUs, {sum(len(p.payload) for p in tus)} bytes, "
          f"PSNR-Y {min(b_psnr):.2f}..{max(b_psnr):.2f} dB, gather "
          f"launches {b_launches}, compound cells {comp} in 7 B frames "
          f"({comp / (7 * (H1080 // 8) * (W1080 // 8)):.4f} of their cells)",
          flush=True)
    print(f"  frame ms: key {key_s * 1e3:.1f}, base P {bsecs[8] * 1e3:.1f}, "
          f"B mean {b_mean * 1e3:.1f} (min "
          f"{min(bsecs[d] for d in range(1, 8)) * 1e3:.1f}, max "
          f"{max(bsecs[d] for d in range(1, 8)) * 1e3:.1f})", flush=True)
    phase("main path 1080p hier-B (1 key + base P + 7 B, compound)", t)

    t = time.time()
    ldb_kw = dict(width=W1080, height=H1080, qp=40, intra_period=-1,
                  pred_structure=1, enable_deblocking=True,
                  enable_cdef=True, recon_output=False,
                  scene_change_detection=True, enc_mode=8,
                  stat_report=True)
    lpkts, lsecs, lcounts = ldb_path(torch, G, svt, ldb_kw)
    if len(lpkts) != N_LDB or any(p is None or not p.payload for p in lpkts):
        raise AssertionError(f"expected {N_LDB} non-empty LDB packets")
    if not lpkts[0].is_keyframe or any(p.is_keyframe for p in lpkts[1:]):
        raise AssertionError("expected one keyframe then LDB inter frames "
                             "(the clip has no scene cut)")
    if [(p.pts, p.show) for p in lpkts] != [(i, True) for i in range(N_LDB)]:
        raise AssertionError("LDB packets not shown in order")
    want_l = sum(LDB1080.values())
    if lcounts != [0] + [want_l] * (N_LDB - 1):
        raise AssertionError(f"the LDB path launched the gather kernel "
                             f"{lcounts} times per frame, not 0 for the "
                             f"keyframe and {want_l} per LDB frame")
    ldb_launches = sum(lcounts)
    l_psnr = [p.psnr[0] for p in lpkts]
    if not all(25.0 < v < 60.0 for v in l_psnr):
        raise AssertionError(f"LDB PSNR-Y out of range: {l_psnr}")
    print(f"  1080p LDB: {N_LDB} packets, "
          f"{sum(len(p.payload) for p in lpkts)} bytes, gather launches "
          f"{ldb_launches} ({want_l} per LDB frame)", flush=True)
    for i, (p, sec) in enumerate(zip(lpkts, lsecs)):
        print(f"  frame {i} ({'key' if p.is_keyframe else 'LDB'}): "
              f"{sec * 1e3:.1f} ms, {len(p.payload)} bytes, PSNR-Y "
              f"{p.psnr[0]:.2f} dB", flush=True)
    l_mean = sum(lsecs[1:]) / (N_LDB - 1)
    print(f"  frame ms: key {lsecs[0] * 1e3:.1f}, LDB mean "
          f"{l_mean * 1e3:.1f} (min {min(lsecs[1:]) * 1e3:.1f}, max "
          f"{max(lsecs[1:]) * 1e3:.1f})", flush=True)
    phase("main path 1080p low-delay B (1 key + 7 LDB, scene cuts on)", t)

    t = time.time()
    rd_kw = dict(hierb_kw, enc_mode=6, multi_ref=-1)
    rtus, rkey_s, rsecs, rcounts, rd_launches, renc = hierb_path(
        torch, G, svt, rd_kw)
    rcoded = [p for p in rtus if p.recon is not None]
    if ([p.display_idx for p in rcoded] != [0, 8, 4, 2, 1, 3, 6, 5, 7]
            or len(rtus) != 2 * N_HIERB - 1
            or not all(p.payload for p in rtus)):
        raise AssertionError("preset-6 hier-B TUs out of the mini-GOP's "
                             "decode order")
    leaf16 = rcoded[0].leaf16_cells
    if not leaf16:
        raise AssertionError("the preset-6 keyframe holds no 16x16 leaf")
    if renc._nrefs3_frames != 4:
        raise AssertionError(f"{renc._nrefs3_frames} three-reference frames, "
                             f"not 4 (display 1, 2, 3, 5)")
    want_r = {d: RD_LAUNCHES[n] for d, n in RD_NREFS.items()}
    if rcounts != want_r or rd_launches != sum(want_r.values()):
        raise AssertionError(f"the preset-6 path launched the gather kernel "
                             f"{rcounts} times per frame, not {want_r}")
    rcomp = sum(p.compound_cells for p in rcoded[2:])
    if rcomp <= 0:
        raise AssertionError("no compound cell in the preset-6 B frames")
    r_psnr = [p.psnr[0] for p in rcoded]
    if not all(25.0 < v < 60.0 for v in r_psnr):
        raise AssertionError(f"preset-6 PSNR-Y out of range: {r_psnr}")
    print(f"  1080p hier-B preset 6: {len(rcoded)} coded + "
          f"{len(rtus) - len(rcoded)} show-existing TUs, "
          f"{sum(len(p.payload) for p in rtus)} bytes, PSNR-Y "
          f"{min(r_psnr):.2f}..{max(r_psnr):.2f} dB, keyframe 16x16-leaf "
          f"cells {leaf16} of {(H1080 // 8) * (W1080 // 8)}, three-reference "
          f"frames {renc._nrefs3_frames}, gather launches {rd_launches}, "
          f"compound cells {rcomp}", flush=True)
    for d in sorted(rsecs):
        print(f"  display {d} ({RD_NREFS[d]} ref): {rsecs[d] * 1e3:.1f} ms, "
              f"{rcounts[d]} gathers", flush=True)
    print(f"  frame ms: key {rkey_s * 1e3:.1f}, base P {rsecs[8] * 1e3:.1f}, "
          f"B mean {sum(rsecs[d] for d in range(1, 8)) / 7 * 1e3:.1f}",
          flush=True)
    phase("main path 1080p hier-B preset 6 (1 key + base P + 7 B, "
          "three references)", t)

    t = time.time()
    from svt_av1_tpu_torch.io.yuv import synthetic_clip
    p5_kw = dict(hierb_kw, enc_mode=5, multi_ref=-1)
    ptus, precs, p5_launches, penc = vod_path(
        torch, G, svt, p5_kw, synthetic_clip(W1080, H1080, N_HIERB))
    pcoded = [p for p in ptus if p.recon is not None]
    if ([p.display_idx for p in pcoded] != [0, 8, 4, 2, 1, 3, 6, 5, 7]
            or len(ptus) != 2 * N_HIERB - 1
            or not all(p.payload for p in ptus)):
        raise AssertionError("preset-5 hier-B TUs out of the mini-GOP's "
                             "decode order")
    if not pcoded[0].leaf16_cells or penc._nrefs3_frames != 4:
        raise AssertionError("preset 5: no 16x16 keyframe leaf, or not 4 "
                             "three-reference frames")
    want_p5 = {0: 0, **{d: P5_LAUNCHES[n] for d, n in RD_NREFS.items()}}
    pcounts = {d: r["gathers"] for d, r in precs.items()}
    if pcounts != want_p5 or p5_launches != sum(want_p5.values()):
        raise AssertionError(f"the preset-5 path launched the gather kernel "
                             f"{pcounts} times per frame, not {want_p5}")
    prect = sum(p.rect_cells for p in pcoded[1:])
    pidtx = sum(p.idtx_cells for p in pcoded[1:])
    pcomp = sum(p.compound_cells for p in pcoded[2:])
    if prect <= 0 or pcomp <= 0:
        raise AssertionError(f"preset 5: {prect} rect cells, {pcomp} "
                             f"compound cells in the inter frames")
    p_psnr = {p.display_idx: p.psnr[0] for p in pcoded}
    if not all(25.0 < v < 60.0 for v in p_psnr.values()):
        raise AssertionError(f"preset-5 PSNR-Y out of range: {p_psnr}")
    print(f"  1080p hier-B preset 5: {len(pcoded)} coded + "
          f"{len(ptus) - len(pcoded)} show-existing TUs, "
          f"{sum(len(p.payload) for p in ptus)} bytes, keyframe 16x16-leaf "
          f"cells {pcoded[0].leaf16_cells}, three-reference frames "
          f"{penc._nrefs3_frames}, rect cells {prect}, IDTX cells {pidtx}, "
          f"compound cells {pcomp}, gather launches {p5_launches}",
          flush=True)
    for p in pcoded:
        d = p.display_idx
        r = precs[d]
        refs = "key" if d == 0 else f"{RD_NREFS[d]} ref"
        tiles = ("" if d == 0 else f", rect cells {p.rect_cells} "
                 f"(entropy: {'Python writer' if p.rect_cells else 'C++'})"
                 f", IDTX cells {p.idtx_cells}")
        print(f"  display {d} ({refs}): {r['total_s'] * 1e3:.1f} ms = "
              f"step {r['step_s'] * 1e3:.1f} + entropy "
              f"{r['entropy_s'] * 1e3:.1f} + other {r['other_s'] * 1e3:.1f}"
              f"; {len(p.payload)} bytes, PSNR-Y {p_psnr[d]:.2f} dB"
              f"{tiles}, {r['gathers']} gathers, peak "
              f"{r['peak_gib']:.2f} GiB", flush=True)
    pb = [precs[d]["total_s"] for d in range(1, 8)]
    print(f"  frame ms: key {precs[0]['total_s'] * 1e3:.1f}, base P "
          f"{precs[8]['total_s'] * 1e3:.1f}, B mean "
          f"{sum(pb) / 7 * 1e3:.1f}", flush=True)
    phase("main path 1080p hier-B preset 5 (1 rich key + base P + 7 B, "
          "tx-type search, rect leaves, three references)", t)

    t = time.time()
    rc_kw = dict(cfg_kw, rate_control_mode=2, target_bit_rate=RC_TBR,
                 frame_rate_num=RC_FPS, stat_report=False)
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(svt.EncoderConfig(**rc_kw), device="cuda")
    rpk, rc_counts = [], []
    for f in synthetic_clip(W720, H720, N_RC):
        G.gather_tiles.launches = 0
        enc.send_picture(f)
        rpk.append(enc.get_packet())
        rc_counts.append(G.gather_tiles.launches)
    rc_launches = sum(rc_counts)
    if rc_counts != [0] + [sum(P720.values())] * (N_RC - 1):
        raise AssertionError(f"the VBR path launched the gather kernel "
                             f"{rc_counts} times per frame, not 6 per P")
    rc_q = [p.qindex for p in rpk]
    if len(set(rc_q[1:])) < 2:
        raise AssertionError(f"VBR did not move q: {rc_q}")
    kbps = sum(len(p.payload) for p in rpk) * 8 * RC_FPS / N_RC / 1e3
    print(f"  720p IPPP VBR at {RC_TBR / 1e3:.0f} kbps, {RC_FPS} fps: "
          f"qindex per frame {rc_q}, bytes {[len(p.payload) for p in rpk]}, "
          f"achieved {kbps:.1f} kbps, gather launches {rc_launches}",
          flush=True)
    phase("main path 720p IPPP VBR (rate control 2, 8 frames)", t)

    t = time.time()
    from svt_av1_tpu_torch.io.yuv import vod_clip
    vframes = vod_clip(W4K, H4K, N_VOD)
    vtus, vrecs, vod_launches, venc = vod_path(torch, G, svt, VOD_KW,
                                               vframes)
    vcoded = [p for p in vtus if p.recon is not None]
    if ([p.display_idx for p in vcoded] != VOD_ORDER
            or len(vtus) != 2 * N_VOD - 1
            or not all(p.payload for p in vtus)):
        raise AssertionError("4K VOD TUs out of the span's decode order")
    if any(p.recon.y.dtype.name != "uint16" for p in vcoded):
        raise AssertionError("4K VOD recon is not 10-bit (uint16)")
    n3 = sum(n == 3 for n in VOD_NREFS.values())
    if not vcoded[0].leaf16_cells or venc._nrefs3_frames != n3:
        raise AssertionError(f"4K VOD: no 16x16 keyframe leaf, or not {n3} "
                             f"three-reference frame(s)")
    want_v = {0: 0, **{d: RD_LAUNCHES[n] for d, n in VOD_NREFS.items()}}
    vcounts = {d: r["gathers"] for d, r in vrecs.items()}
    if vcounts != want_v or vod_launches != sum(want_v.values()):
        raise AssertionError(f"the 4K VOD path launched the gather kernel "
                             f"{vcounts} times per frame, not {want_v}")
    if not any(r.get("lr_units_on") for r in vrecs.values()):
        raise AssertionError("4K VOD: restoration switched no unit on")
    if not all(vrecs[d]["analysis_s"] > 0 for d in range(1, N_VOD)):
        raise AssertionError("4K VOD: AQ analysis did not run on every "
                             "inter frame")
    v_psnr = {p.display_idx: psnr_luma(vframes[p.display_idx], p.recon, 10)
              for p in vcoded}
    if not all(25.0 < v < 60.0 for v in v_psnr.values()):
        raise AssertionError(f"4K VOD PSNR-Y out of range: {v_psnr}")
    vcomp = sum(p.compound_cells for p in vcoded[2:])
    vbytes = {p.display_idx: len(p.payload) for p in vcoded}
    print(f"  4K 10-bit VOD: {len(vcoded)} coded + "
          f"{len(vtus) - len(vcoded)} show-existing TUs, "
          f"{sum(len(p.payload) for p in vtus)} bytes, keyframe "
          f"16x16-leaf cells {vcoded[0].leaf16_cells} of "
          f"{(H4K // 8) * (W4K // 8)}, three-reference frames "
          f"{venc._nrefs3_frames}, compound cells {vcomp}, gather "
          f"launches {vod_launches}", flush=True)
    for d in [p.display_idx for p in vcoded]:
        r = vrecs[d]
        refs = "key" if d == 0 else f"{VOD_NREFS[d]} ref"
        print(f"  display {d} ({refs}): {r['total_s'] * 1e3:.1f} ms = "
              f"step {r['step_s'] * 1e3:.1f} + restoration "
              f"{r['lr_s'] * 1e3:.1f} + analysis {r['analysis_s'] * 1e3:.1f}"
              f" + entropy {r['entropy_s'] * 1e3:.1f} + other "
              f"{r['other_s'] * 1e3:.1f}; {vbytes[d]} bytes, PSNR-Y "
              f"{v_psnr[d]:.2f} dB, restoration {r.get('lr_types')} "
              f"({r.get('lr_units_on', 0)} units on), {r['gathers']} "
              f"gathers, peak {r['peak_gib']:.2f} GiB", flush=True)
    vb = [vrecs[d]["total_s"] for d in range(1, N_VOD - 1)]
    print(f"  frame ms: key {vrecs[0]['total_s'] * 1e3:.1f}, base P "
          f"{vrecs[N_VOD - 1]['total_s'] * 1e3:.1f}, B mean "
          f"{sum(vb) / len(vb) * 1e3:.1f}; peak device memory "
          f"{max(r['peak_gib'] for r in vrecs.values()):.2f} GiB", flush=True)
    phase("main path 4K 10-bit VOD (bench.py:185: 1 key + base P + 3 B of "
          "a truncated span, preset 6, restoration, AQ)", t)

    t = time.time()
    ipkts, irecs, isecs, ipeak = intra_batch_path(torch, svt)
    if len(ipkts) != N480 or not all(p.is_keyframe and p.payload
                                     for p in ipkts):
        raise AssertionError(f"expected {N480} non-empty keyframes")
    if [p.pts for p in ipkts] != list(range(B480, B480 + N480)):
        raise AssertionError("480p batch packets out of order")
    if [r["frames"] for r in irecs] != [B480] * (N480 // B480):
        raise AssertionError(f"480p batches of {[r['frames'] for r in irecs]}"
                             f" frames, not {B480} each")
    print(f"  480p all-intra batch {B480}: {N480} timed frames, "
          f"{sum(len(p.payload) for p in ipkts)} bytes, "
          f"{N480 / isecs:.3f} frames/s, peak device memory {ipeak:.2f} GiB",
          flush=True)
    for i, r in enumerate(irecs):
        print(f"  batch {i}: {r['total_s'] * 1e3:.1f} ms = step "
              f"{r['step_s'] * 1e3:.1f} + postproc {r['postproc_s'] * 1e3:.1f}"
              f" + entropy {r['entropy_s'] * 1e3:.1f} + other "
              f"{r['other_s'] * 1e3:.1f} ({r['frames']} frames)", flush=True)
    phase("main path 480p all-intra batch (bench.py:115: device_batch 32, "
          "32 warm-up + 64 timed frames)", t)

    t = time.time()
    lrecs, lsecs_live, lpeak, live_launches, lslots = live_path(torch, G,
                                                                svt)
    want_live = [0] + [sum(LIVE1080.values())] * (LIVE_WARM + LIVE_TIMED - 1)
    if [r["gathers"] for r in lrecs] != want_live:
        raise AssertionError(f"the 4x1080p path launched the gather "
                             f"{[r['gathers'] for r in lrecs]} times per "
                             f"slot, not {want_live}")
    if (not all(p.is_keyframe for p in lslots[0])
            or any(p.is_keyframe for sl in lslots[1:] for p in sl)
            or any(len({p.payload for p in sl}) != N_STREAMS
                   for sl in lslots)):
        raise AssertionError("4x1080p: expected one keyframe slot, then P "
                             "slots of 4 distinct streams")
    print(f"  4x1080p live: {N_STREAMS * LIVE_TIMED / lsecs_live:.3f} "
          f"frames/s aggregate over {LIVE_TIMED} timed slots, peak device "
          f"memory {lpeak:.2f} GiB, gather launches {live_launches} "
          f"({sum(LIVE1080.values())} per P slot for {N_STREAMS} streams)",
          flush=True)
    for i, r in enumerate(lrecs):
        r["other_s"] = r["total_s"] - r.get("step_s", 0.0) - r["entropy_s"]
        print(f"  slot {i} ({'key' if i == 0 else 'P'}): "
              f"{r['total_s'] * 1e3:.1f} ms = step "
              f"{r.get('step_s', 0.0) * 1e3:.1f} + entropy "
              f"{r['entropy_s'] * 1e3:.1f} + other {r['other_s'] * 1e3:.1f}"
              f"; {r['gathers']} gathers, bytes {r['bytes']}", flush=True)
    phase("main path 4 x 1080p live IPPP in lockstep (bench.py:221: 2 "
          "warm-up + 12 timed slots)", t)

    t = time.time()
    sizes = parity_phase(svt)
    sizes.update(batch_parity(svt))
    for name, sz in sizes.items():
        print(f"  {name} card == CPU, bytes {sz}", flush=True)
    phase("card vs CPU: 320x192 IPPP, 192x128 hier-B, 320x192 LDB, tiled "
          "look-ahead push_qp IPPP, preset 6 hier-B, preset 7 IPPP and "
          "LDB, AQ 2 hier-B, 200x136 VOD config, preset 5 hier-B, preset "
          "0 IPPP, VBR hier-B, CVBR LDB, CLI (also 10-bit), all-intra "
          "batch, multistream (also VBR), GOP shards, CLI --nch 2", t)

    t = time.time()
    timing_phase(sites + bsites, timed + btimed)
    sites = sites + bsites
    phase("gather timings at the 720p P, 1080p B, 1080p RD B, 4K 10-bit "
          "RD B and batched 4x1080p P-slot call sites", t)

    t = time.time()
    kcount = kernel_counts(torch, svt)
    for nf, (n, sec) in kcount.items():
        print(f"  480p all-intra device work for {nf} frame(s): {n} device "
              f"operations (kernels, copies, fills; profiled {sec:.1f} s)",
              flush=True)
    phase("kernels of one 480p batch of 32 frames and of one frame "
          "(torch.profiler)", t)

    def tot(frame, get, per=None):
        """Sum of get(site) over one frame's main-path launches (per:
        launches by site name, else the sites' own per-frame counts)."""
        count = ((lambda s: per.get(s["site"], 0)) if per
                 else (lambda s: s["launches_per_frame"]))
        main_sites = [s for s in sites if s["frame"] == frame and count(s)]
        vals = [get(s) for s in main_sites]
        if None in vals:
            return None
        return sum(v * count(s) for v, s in zip(vals, main_sites))

    def per_frame(frame, per=None):
        dev_us = tot(frame, lambda s: s["main"]["device_us"], per)
        return {"ms": tot(frame, lambda s: s["main"]["ms"], per),
                "device_ms": None if dev_us is None else dev_us / 1e3,
                "host_us": tot(frame, lambda s: s["main"]["host_us"], per),
                "plain_ms": tot(frame, lambda s: s["plain_ms"], per),
                "bound_ms": tot(frame, lambda s: s["bound_ms"], per),
                "library_ms": tot(frame, lambda s: s["take"]["ms"], per)}

    kernels = {"kernels": [{
        "name": "gather_tiles",
        "route": "cuda",
        "source": "svt_av1_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "svt_av1_tpu/ops/gather.py:151",
        "launches": (launches + b_launches + ldb_launches + rd_launches
                     + p5_launches + rc_launches + vod_launches
                     + live_launches),
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        **per_frame("720p P"), "bound_by": "bytes",
        "per_1080p_b_frame": per_frame("1080p B"),
        "per_1080p_ldb_frame": per_frame("1080p B", LDB1080),
        "per_1080p_rd_b_frame": per_frame("1080p RD B"),
        "per_4k_10bit_rd_b_frame": per_frame("4K RD B"),
        "per_1080p_p5_b_frame": {
            k: None if None in (a, b) else a + b
            for (k, a), b in zip(per_frame("1080p RD B").items(),
                                 per_frame("1080p P5 rect").values())},
        "batched_entry": "gather_tiles on [S, Hp, Wp] planes, [S, N] starts",
        "per_4x1080p_p_slot": dict(
            per_frame("4x1080p P slot"),
            launches_batched=sum(LIVE1080.values()),
            launches_separate=N_STREAMS * sum(LIVE1080.values()),
            separate_ms=tot("4x1080p P slot",
                            lambda s: s["separate"]["ms"]))}]}
    for label, frame, per in (("720p P frame", "720p P", None),
                              ("1080p B frame", "1080p B", None),
                              ("1080p LDB frame", "1080p B", LDB1080),
                              ("1080p RD B frame", "1080p RD B", None),
                              ("4K 10-bit RD B frame", "4K RD B", None),
                              ("1080p preset-5 B frame, its rect sites",
                               "1080p P5 rect", None),
                              ("4x1080p P slot", "4x1080p P slot", None)):
        extra = ["separate"] if frame == "4x1080p P slot" else \
            [d for d in G.DESIGNS if d != G.MAIN_DESIGN]
        for d in ["main", *extra, "take", "plain"]:
            dv = tot(frame, lambda s: s[d]["device_us"], per)
            print(f"  per {label}, {d:6s}: event "
                  f"{tot(frame, lambda s: s[d]['ms'], per):.4f} ms, device "
                  f"{'not measured' if dv is None else f'{dv:.2f} us'}, "
                  f"host {tot(frame, lambda s: s[d]['host_us'], per):.2f} "
                  f"us; bound "
                  f"{tot(frame, lambda s: s['bound_ms'], per) * 1e3:.2f} us",
                  flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps({
            "nvidia_smi": smi, "device": kind, "torch": torch.__version__,
            "build_s": build_s, "sites": sites, "frame_s": secs,
            "packet_bytes": [len(p.payload) for p in pkts],
            "psnr_y": psnr_y, "launches": launches,
            "hierb": {"key_s": key_s, "coded_s": bsecs,
                      "tu_bytes": [len(p.payload) for p in tus],
                      "psnr_y": b_psnr, "launches": b_launches,
                      "compound_cells": comp},
            "ldb": {"frame_s": lsecs,
                    "packet_bytes": [len(p.payload) for p in lpkts],
                    "psnr_y": l_psnr, "launches": lcounts},
            "rd_hierb": {"key_s": rkey_s, "coded_s": rsecs,
                         "tu_bytes": [len(p.payload) for p in rtus],
                         "psnr_y": r_psnr, "launches": rcounts,
                         "leaf16_cells": leaf16,
                         "nrefs3_frames": renc._nrefs3_frames,
                         "compound_cells": rcomp},
            "p5_hierb": {"frames": {str(d): r for d, r in precs.items()},
                         "tu_bytes": [len(p.payload) for p in ptus],
                         "psnr_y": {str(d): v for d, v in p_psnr.items()},
                         "launches": p5_launches, "rect_cells": prect,
                         "idtx_cells": pidtx, "compound_cells": pcomp},
            "rc_720p": {"qindex": rc_q, "kbps": kbps,
                        "tu_bytes": [len(p.payload) for p in rpk],
                        "launches": rc_counts},
            "vod_4k10": {"frames": {str(d): r for d, r in vrecs.items()},
                         "tu_bytes": [len(p.payload) for p in vtus],
                         "psnr_y": {str(d): v for d, v in v_psnr.items()},
                         "launches": vod_launches,
                         "leaf16_cells": vcoded[0].leaf16_cells,
                         "compound_cells": vcomp},
            "intra_480p_batch": {"frames_per_s": N480 / isecs,
                                 "batches": irecs, "peak_gib": ipeak,
                                 "kernels": {str(k): v for k, v in
                                             kcount.items()}},
            "live_4x1080p": {"frames_per_s":
                             N_STREAMS * LIVE_TIMED / lsecs_live,
                             "slots": lrecs, "peak_gib": lpeak,
                             "launches": live_launches},
            "parity_tu_bytes": sizes,
            "kernels": kernels["kernels"],
            "total_s": time.time() - t0}, indent=1))
    phase("total", t0)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
