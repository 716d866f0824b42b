#!/usr/bin/env python3
"""Where the time goes in the port's 720p low-delay-P encode, on one GPU.

    python3 tools/profile_torch_ldp.py [--frames N] [--out DIR]

Encodes synthetic 1280x720 frames (qp 40, preset 8, IPPP, the
configuration of chip_smoke.py's main path) with svt_av1_tpu_torch on
the card and reports, per frame kind (keyframe / P frame):

  - wall ms per frame (host clock, ending in torch.cuda.synchronize),
    split into the device step (dispatch through the device->host copy)
    and the host entropy + packetization;
  - device-busy share: the summed CUDA kernel time of a torch.profiler
    window over the frame's wall time;
  - kernel launches per frame and the top kernels by device time.

The first stream (1 keyframe + 1 P) warms the caches and is not
reported.  --out DIR writes the full kernel tables to
DIR/profile_torch_ldp.json.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4,
                    help="frames of the measured stream (1 key + N-1 P)")
    ap.add_argument("--out", help="directory for profile_torch_ldp.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_ldp: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.ops import gather as G
    from svt_av1_tpu_torch.pipeline import encoder as E

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    cfg = EncoderConfig(width=1280, height=720, qp=40, intra_period=-1,
                        pred_structure=0, recon_output=False,
                        scene_change_detection=False, enc_mode=8)
    frames = [synthetic_frame(1280, 720, seed=i) for i in range(args.frames)]

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

    warm = E.Encoder(cfg, device="cuda")
    for f in frames[:2]:
        warm.send_picture(f)
        warm.get_packet()
    torch.cuda.synchronize()

    enc = E.Encoder(cfg, device="cuda")
    rows = []
    for i, f in enumerate(frames):
        host_s.clear()
        launches0 = G.gather_tiles.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            enc.send_picture(f)
            pkt = enc.get_packet()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.device_time for e in evs)
        kinds = {}
        for e in evs:
            k = kinds.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.device_time
        top = sorted(kinds.items(), key=lambda kv: -kv[1][1])[:12]
        row = dict(frame=i, kind="key" if pkt.is_keyframe else "P",
                   wall_ms=wall * 1e3, host_entropy_ms=sum(host_s) * 1e3,
                   device_kernel_ms=dev_us / 1e3,
                   device_busy_share=dev_us / 1e6 / wall,
                   kernel_launches=len(evs),
                   gather_launches=G.gather_tiles.launches - launches0,
                   payload_bytes=len(pkt.payload),
                   top_kernels=[dict(name=n[:90], launches=c, ms=us / 1e3)
                                for n, (c, us) in top])
        rows.append(row)
        print(f"frame {i} {row['kind']:3s} wall {row['wall_ms']:8.1f} ms  "
              f"host entropy {row['host_entropy_ms']:6.1f} ms  kernels "
              f"{row['kernel_launches']:6d} ({row['device_kernel_ms']:.1f} "
              f"ms, busy {row['device_busy_share']:.3f})  gather "
              f"{row['gather_launches']}")
    for kind in ("key", "P"):
        r = [x for x in rows if x["kind"] == kind]
        if not r:
            continue
        print(f"top kernels, {kind} frame {r[-1]['frame']}:")
        for k in r[-1]["top_kernels"][:8]:
            print(f"  {k['ms']:8.2f} ms {k['launches']:6d}x  {k['name']}")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_torch_ldp.json").write_text(json.dumps(
            {"nvidia_smi": smi, "torch": torch.__version__, "frames": rows},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
