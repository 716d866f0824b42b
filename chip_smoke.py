#!/usr/bin/env python3
"""Smoke run of svt_av1_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout on a machine with a CUDA card (nvcc on
PATH or under /usr/local/cuda).  Phases, one line of seconds each:

  1. device   — a CUDA card must be present (else exit 1, no result);
                prints nvidia-smi's name and power limit;
  2. build    — nvcc builds csrc/gather_tiles.cu and g++ builds the C++
                entropy coder into build/svt_av1_tpu_torch/, together;
  3. kernel   — the tile-gather kernel against its plain PyTorch version
                at every 720p call-site shape, exact equality (tolerance
                0), with CUDA-event times of the kernel, the plain
                version, one torch.take call and the byte bound;
  4. main     — the 720p low-delay-P encode (1 keyframe + 7 P frames,
                qp 40, preset 8) through Encoder.send_picture/get_packet;
                the gather launch count must be above 0;
  5. parity   — a 320x192 clip (1 keyframe + 2 P) encoded on the card
                and on the CPU must give byte-identical packets.

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  --out DIR also writes the per-shape and
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
    br = (torch.arange(th, device=dev)[:, None] * 32 + search
          + cen[..., 0]).reshape(-1)
    bc = (torch.arange(tw, device=dev)[None, :] * 32 + search
          + cen[..., 1]).reshape(-1)
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


def kernel_phase(torch, MC, G, dev):
    """Hold the CUDA gather against gather_tiles_ref at each call-site
    shape; returns the per-site records."""
    gen = torch.Generator().manual_seed(0)
    recs = []
    for name, per_frame, plane, br, bc, kw in call_sites(torch, MC, G, gen,
                                                         dev):
        th, tw = kw["th"], kw["tw"]
        got = G.gather_tiles(plane, br, bc, **kw)
        want = G.gather_tiles_ref(plane, br, bc, th, tw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"gather kernel != plain version at {name}:"
                                 f" max |err| {err}")
        idx = flat_index(torch, plane, br, bc, th, tw)
        touched = torch.zeros(plane.numel(), dtype=torch.bool, device=dev)
        touched[idx.reshape(-1)] = True
        n = br.shape[0]
        nbytes = (int(touched.sum()) * plane.element_size() + 8 * n
                  + n * th * tw * plane.element_size())
        rec = dict(site=name, launches_per_p_frame=per_frame,
                   dtype=str(plane.dtype).replace("torch.", ""),
                   plane=list(plane.shape), tiles=n, tile=[th, tw],
                   max_abs_err=err, bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        rec["ms"] = cuda_ms(lambda: G.gather_tiles(plane, br, bc, **kw))
        rec["plain_ms"] = cuda_ms(
            lambda: G.gather_tiles_ref(plane, br, bc, th, tw))
        flat = idx.reshape(n, th, tw)
        rec["library_ms"] = cuda_ms(lambda: torch.take(plane, flat))
        recs.append(rec)
        print(f"  {name:24s} {rec['dtype']:5s} N={n:5d} {th}x{tw} "
              f"err=0 kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f}"
              f" ms  take {rec['library_ms']:.4f} ms  bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
    # off-contract starts (negative, past the end) map like the plain one
    plane = torch.randint(0, 256, (40, 50), generator=gen,
                          dtype=torch.int32).to(dev)
    br = torch.tensor([-5, 0, 35, 100], dtype=torch.int32, device=dev)
    bc = torch.tensor([-9, 45, 3, -1], dtype=torch.int32, device=dev)
    got = G.gather_tiles_cuda(plane, br, bc, 8, 8)
    if not torch.equal(got, G.gather_tiles_ref(plane, br, bc, 8, 8)):
        raise AssertionError("gather kernel != plain version off-contract")
    return recs


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
        jobs = [ex.submit(G.kernel_library), ex.submit(backend._lib)]
        for j in jobs:
            j.result()
    build_s = time.time() - t
    phase("build (nvcc gather_tiles.cu + g++ entropy.cpp)", t)

    t = time.time()
    dev = torch.device("cuda")
    sites = kernel_phase(torch, MC, G, dev)
    phase("kernel vs plain (exact) at 720p call-site shapes", t)

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
    if launches <= 0:
        raise AssertionError("the main path never launched the gather kernel")
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

    main_sites = [s for s in sites if s["launches_per_p_frame"]]
    tot = lambda k: sum(s[k] * s["launches_per_p_frame"] for s in main_sites)
    kernels = {"kernels": [{
        "name": "gather_tiles",
        "route": "cuda",
        "source": "svt_av1_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "svt_av1_tpu/ops/gather.py:151",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"),
        "bound_ms": tot("bound_ms"), "bound_by": "bytes",
        "library_ms": tot("library_ms")}]}
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
