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
                plain PyTorch version at every 720p call-site shape and
                at awkward shapes (odd widths, edge and off-contract
                starts, three dtypes), exact equality (tolerance 0);
  4. main     — the 720p low-delay-P encode (1 keyframe + 7 P frames,
                qp 40, preset 8) through Encoder.send_picture/get_packet;
                the gather must launch 6 times per P frame;
  5. parity   — a 320x192 clip (1 keyframe + 2 P) encoded on the card
                and on the CPU must give byte-identical packets;
  6. timing   — at each call site, for both designs, one torch.take
                call and the plain version: event ms (CUDA events around
                20 back-to-back calls) and host us per call (perf_counter
                around 200 calls issued without a synchronise) at every
                site, then device us per call (torch.profiler kernel
                time over 20 calls) at every site, beside the byte
                bound.  Last, because a profiler session may slow every
                later launch.

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  For gather_tiles its ms, device_ms,
host_us, plain_ms, bound_ms and library_ms are sums over the six
launches of one 720p P frame.  --out DIR also writes the per-shape and
per-frame numbers to DIR/chip_smoke.json.  Imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
W720, H720, N_MAIN = 1280, 720, 8


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


def call_sites(torch, MC, G, gen, dev):
    """(name, per-P-frame launches on the main path, plane, base_r,
    base_c, gather_tiles kwargs) at the 720p shapes of every call site.
    Motion is drawn uniformly within each site's reach."""
    ph, pw = -(-H720 // 64) * 64, W720          # 64-padded geometry
    ry = torch.randint(0, 256, (ph, pw), generator=gen,
                       dtype=torch.uint8).to(dev)
    ru = torch.randint(0, 256, (ph // 2, pw // 2), generator=gen,
                       dtype=torch.uint8).to(dev)
    pad, cpad, search = 17, 9, 16
    py_pad = MC.pad_for_filter(ry, pad)
    pu_pad = MC.pad_for_filter(ru, cpad)

    def mv(shape, reach):
        return torch.randint(-reach, reach + 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    sites = []
    # me.warp_by_centers: one 32x32 u8 tile per 32x32 cell
    ref_pad = MC.edge_pad(ry, search, search, search, search)
    th, tw = ph // 32, pw // 32
    cen = mv((th, tw, 2), 13)
    ar = lambda k: torch.arange(k, dtype=torch.int32, device=dev)
    br = (ar(th)[:, None] * 32 + search + cen[..., 0]).reshape(-1)
    bc = (ar(tw)[None, :] * 32 + search + cen[..., 1]).reshape(-1)
    sites.append(("warp_by_centers", 1, ref_pad, br, bc,
                  dict(nbh=th, nbw=tw, stride=32, band_off=0,
                       band_h=2 * search + 32, th=32, tw=32)))
    nb8 = (ph // 8, pw // 8)
    g = mv((2,), 15)
    grid = [  # name, launches/P frame, plane, mv, bs, pad, reach, halo, off
        ("globalmv_copy", 1, py_pad,
         (g[0].expand(nb8), g[1].expand(nb8)), 8, pad, pad - 1, 0, 0),
        ("cell_refine", 1, py_pad, (mv(nb8, 16), mv(nb8, 16)),
         8, pad, pad - 1, 8, -4),
        ("mc_patch_luma", 1, py_pad, (mv(nb8, 17), mv(nb8, 17)),
         8, pad, pad, 7, -3),
        ("mc_patch_chroma", 2, pu_pad, (mv(nb8, 9), mv(nb8, 9)),
         4, cpad, cpad, 7, -3),
    ]
    for bs in (8, 16, 32):     # RD presets only: not on the main path
        nb = (ph // bs, pw // bs)
        grid.append((f"subpel_refine_dense_{bs}", 0, py_pad,
                     (mv(nb, 16), mv(nb, 16)), bs, pad, pad - 1, 8, -4))
    for name, per_frame, plane, (mr, mc), bs, pd, reach, halo, off in grid:
        br, bc, kw = G.grid_tile_args(plane, mr, mc, bs, pd, reach, halo,
                                      off)
        sites.append((name, per_frame, plane, br, bc, kw))
    return sites


def flat_index(torch, plane, br, bc, th, tw):
    """Flat plane indices of every tile element (starts mapped as the
    kernel maps them)."""
    from svt_av1_tpu_torch.ops.gather import clamp_starts
    hp, wp = plane.shape
    r, c = clamp_starts(br, bc, hp, wp, th, tw)
    rows = r[:, None] + torch.arange(th, device=plane.device)[None, :]
    cols = c[:, None] + torch.arange(tw, device=plane.device)[None, :]
    return rows[:, :, None] * wp + cols[:, None, :]


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
    call-site shape and the awkward shapes; returns the per-site records
    (with the byte bound) and the launches to time at each site."""
    gen = torch.Generator().manual_seed(0)
    recs, timed = [], []
    for name, per_frame, plane, br, bc, kw in call_sites(torch, MC, G, gen,
                                                         dev):
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
        recs.append(dict(site=name, launches_per_p_frame=per_frame,
                         dtype=str(plane.dtype).replace("torch.", ""),
                         plane=list(plane.shape), tiles=n, tile=[th, tw],
                         max_abs_err=err, bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
        timed.append(impls)
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
        print(f"  {rec['site']:24s} {rec['dtype']:5s} N={rec['tiles']:5d} "
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


def parity_phase(svt):
    """Small clip on the card and on the CPU: packets must be identical."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    kw = dict(width=320, height=192, qp=40, intra_period=-1,
              pred_structure=0, scene_change_detection=False,
              recon_output=True)
    frames = [synthetic_frame(320, 192, seed=10 + i) for i in range(3)]
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = list(Encoder(svt.EncoderConfig(**kw),
                                   device=device).encode_all(frames))
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        if a.payload != b.payload:
            raise AssertionError(f"card and CPU packets differ at frame {i}")
        for p in ("y", "u", "v"):
            if (getattr(a.recon, p) != getattr(b.recon, p)).any():
                raise AssertionError(f"card/CPU recon differ: frame {i} {p}")
    if len(out["cuda"]) != 3:
        raise AssertionError("expected 3 packets")
    return [len(p.payload) for p in out["cuda"]]


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
    phase("kernel designs vs plain (exact) at 720p call-site and "
          "awkward shapes", t)

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
    sizes = parity_phase(svt)
    print(f"  320x192 IPPP card == CPU, packet bytes {sizes}", flush=True)
    phase("card vs CPU packets, 320x192 1 key + 2 P", t)

    t = time.time()
    timing_phase(sites, timed)
    phase("gather timings at the 720p call sites", t)

    main_sites = [s for s in sites if s["launches_per_p_frame"]]

    def tot(get):
        vals = [get(s) for s in main_sites]
        if None in vals:
            return None
        return sum(v * s["launches_per_p_frame"]
                   for v, s in zip(vals, main_sites))

    dev_us = tot(lambda s: s["main"]["device_us"])
    kernels = {"kernels": [{
        "name": "gather_tiles",
        "route": "cuda",
        "source": "svt_av1_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "svt_av1_tpu/ops/gather.py:151",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        "ms": tot(lambda s: s["main"]["ms"]),
        "device_ms": None if dev_us is None else dev_us / 1e3,
        "host_us": tot(lambda s: s["main"]["host_us"]),
        "plain_ms": tot(lambda s: s["plain_ms"]),
        "bound_ms": tot(lambda s: s["bound_ms"]), "bound_by": "bytes",
        "library_ms": tot(lambda s: s["take"]["ms"])}]}
    for d in ["main", *(d for d in G.DESIGNS if d != G.MAIN_DESIGN),
              "take", "plain"]:
        dv = tot(lambda s: s[d]["device_us"])
        print(f"  per P frame, {d:6s}: event "
              f"{tot(lambda s: s[d]['ms']):.4f} ms, device "
              f"{'not measured' if dv is None else f'{dv:.2f} us'}, host "
              f"{tot(lambda s: s[d]['host_us']):.2f} us; bound "
              f"{tot(lambda s: s['bound_ms']) * 1e3:.2f} us", flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps({
            "nvidia_smi": smi, "device": kind, "torch": torch.__version__,
            "build_s": build_s, "sites": sites, "frame_s": secs,
            "packet_bytes": [len(p.payload) for p in pkts],
            "psnr_y": psnr_y, "launches": launches,
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
