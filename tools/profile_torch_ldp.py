#!/usr/bin/env python3
"""Where the time goes in the port's encode on one GPU, per frame.

    python3 tools/profile_torch_ldp.py
        [--config ldp-720p|hierb-1080p|ldb-1080p|rd-hierb-1080p]
        [--frames N] [--out DIR]

Configs (qp 40, deblock + CDEF, the main paths of chip_smoke.py; preset
8 but for rd-hierb-1080p):

  ldp-720p     synthetic 1280x720 frames, low-delay P (IPPP): one
               keyframe, then N-1 P frames (--frames, default 4);
  hierb-1080p  the moving 1920x1080 clip, hierarchical_levels=3,
               compound_mode=1: a keyframe and one mini-GOP, base P
               frame + 7 B frames;
  ldb-1080p    the moving 1920x1080 clip, low-delay B with scene-change
               detection on: one keyframe, then N-1 LAST + GOLDEN
               frames (--frames);
  rd-hierb-1080p  hierb-1080p at the RD preset 6 (multi_ref=-1: display
               1, 2, 3 and 5 coded from three references).

For each frame (IPPP, LDB: send_picture + get_packet; hier-B: each
coded inter frame, read around Encoder._dispatch_code) it reports:

  - wall ms (host clock, ending in torch.cuda.synchronize), of which
    host entropy + packetization;
  - device-busy share: the summed CUDA kernel time of a torch.profiler
    window over the frame's wall time;
  - kernel launches, gather launches and the top kernels by device time.

A first stream warms the caches and is not reported (IPPP: keyframe +
P; hier-B: keyframe, P, B at hierarchical_levels=1; LDB: keyframe + one
LDB frame); the 1080p keyframes are timed without the profiler.  --out
DIR writes the tables to DIR/profile_torch_<config>.json.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(qp=40, intra_period=-1, recon_output=False,
            scene_change_detection=False, enc_mode=8)
CONFIGS = {
    "ldp-720p": dict(width=1280, height=720, pred_structure=0),
    "hierb-1080p": dict(width=1920, height=1080, pred_structure=2,
                        hierarchical_levels=3, compound_mode=1),
    "ldb-1080p": dict(width=1920, height=1080, pred_structure=1,
                      scene_change_detection=True),
    "rd-hierb-1080p": dict(width=1920, height=1080, pred_structure=2,
                           hierarchical_levels=3, compound_mode=1,
                           enc_mode=6, multi_ref=-1),
}


def profiled(torch, G, host_s, fn):
    """Run fn() in a torch.profiler window, the card synchronised before
    and after; returns (fn's result, the window's row)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host_s.clear()
    launches0 = G.gather_tiles.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.device_time for e in evs)
    kinds = {}
    for e in evs:
        k = kinds.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.device_time
    top = sorted(kinds.items(), key=lambda kv: -kv[1][1])[:12]
    return res, dict(wall_ms=wall * 1e3, host_entropy_ms=sum(host_s) * 1e3,
                     device_kernel_ms=dev_us / 1e3,
                     device_busy_share=dev_us / 1e6 / wall,
                     kernel_launches=len(evs),
                     gather_launches=G.gather_tiles.launches - launches0,
                     top_kernels=[dict(name=n[:90], launches=c, ms=us / 1e3)
                                  for n, (c, us) in top])


def report(label, row):
    print(f"{label} wall {row['wall_ms']:8.1f} ms  host entropy "
          f"{row['host_entropy_ms']:6.1f} ms  kernels "
          f"{row['kernel_launches']:6d} ({row['device_kernel_ms']:.1f} ms, "
          f"busy {row['device_busy_share']:.3f})  gather "
          f"{row['gather_launches']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="ldp-720p")
    ap.add_argument("--frames", type=int, default=4,
                    help="ldp-720p / ldb-1080p: frames of the measured "
                         "stream (1 key + N-1 inter frames)")
    ap.add_argument("--out", help="directory for profile_torch_<config>.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_ldp: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import synthetic_clip, synthetic_frame
    from svt_av1_tpu_torch.ops import gather as G
    from svt_av1_tpu_torch.pipeline import encoder as E

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    kw = {**BASE, **CONFIGS[args.config]}
    w, h = kw["width"], kw["height"]

    # host entropy + packetization time, measured around the writers
    host_s = []

    def timed(fn):
        def wrap(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host_s.append(time.perf_counter() - t)
        return wrap

    E.Encoder._make_packet = timed(E.Encoder._make_packet)
    E.Encoder._make_inter_packet = timed(E.Encoder._make_inter_packet)
    rows, extra = [], {}

    if kw["pred_structure"] == 0:
        frames = [synthetic_frame(w, h, seed=i) for i in range(args.frames)]
        warm = E.Encoder(EncoderConfig(**kw), device="cuda")
        for f in frames[:2]:
            warm.send_picture(f)
            warm.get_packet()
        enc = E.Encoder(EncoderConfig(**kw), device="cuda")

        def code(f):
            enc.send_picture(f)
            return enc.get_packet()

        for i, f in enumerate(frames):
            pkt, row = profiled(torch, G, host_s, lambda: code(f))
            row = dict(frame=i, kind="key" if pkt.is_keyframe else "P",
                       payload_bytes=len(pkt.payload), **row)
            rows.append(row)
            report(f"frame {i} {row['kind']:3s}", row)
    elif kw["pred_structure"] == 1:
        frames = synthetic_clip(w, h, args.frames)
        warm = E.Encoder(EncoderConfig(**kw), device="cuda")
        list(warm.encode_all(frames[:2]))
        enc = E.Encoder(EncoderConfig(**kw), device="cuda")

        def code(f):
            enc.send_picture(f)
            return enc.get_packet()

        torch.cuda.synchronize()
        t = time.perf_counter()
        code(frames[0])
        torch.cuda.synchronize()
        extra["keyframe_ms"] = (time.perf_counter() - t) * 1e3
        print(f"keyframe (no profiler) {extra['keyframe_ms']:.1f} ms",
              flush=True)
        for i, f in enumerate(frames[1:], 1):
            pkt, row = profiled(torch, G, host_s, lambda: code(f))
            row = dict(frame=i, kind="key" if pkt.is_keyframe else "LDB",
                       payload_bytes=len(pkt.payload), **row)
            rows.append(row)
            report(f"frame {i} {row['kind']:3s}", row)
    else:
        frames = synthetic_clip(w, h, 1 + (1 << kw["hierarchical_levels"]))
        warm = E.Encoder(EncoderConfig(**{**kw, "hierarchical_levels": 1}),
                         device="cuda")
        list(warm.encode_all(frames[:3]))
        torch.cuda.synchronize()
        enc = E.Encoder(EncoderConfig(**kw), device="cuda")
        dispatch = enc._dispatch_code

        def profiled_code(step, frame, qindex, *args, **kwargs):
            n3 = enc._nrefs3_frames
            _, row = profiled(torch, G, host_s, lambda: dispatch(
                step, frame, qindex, *args, **kwargs))
            nrefs = (1 if step.bwd is None
                     else 3 if enc._nrefs3_frames > n3 else 2)
            row = dict(display=step.disp, layer=step.layer, qindex=qindex,
                       kind="P" if step.bwd is None else "B", nrefs=nrefs,
                       **row)
            rows.append(row)
            report(f"display {step.disp} {row['kind']} layer {step.layer} "
                   f"refs {nrefs}", row)

        enc._dispatch_code = profiled_code
        t = time.perf_counter()
        enc.send_picture(frames[0])
        torch.cuda.synchronize()
        extra["keyframe_ms"] = (time.perf_counter() - t) * 1e3
        print(f"keyframe (no profiler) {extra['keyframe_ms']:.1f} ms",
              flush=True)
        for f in frames[1:]:
            enc.send_picture(f)
        enc.flush()

    for kind in ("key", "P", "B", "LDB"):
        r = [x for x in rows if x["kind"] == kind]
        if not r:
            continue
        print(f"top kernels, last {kind} frame:")
        for k in r[-1]["top_kernels"][:8]:
            print(f"  {k['ms']:8.2f} ms {k['launches']:6d}x  {k['name']}")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"profile_torch_{args.config}.json").write_text(json.dumps(
            {"nvidia_smi": smi, "torch": torch.__version__,
             "config": args.config, **extra, "frames": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
