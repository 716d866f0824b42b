#!/usr/bin/env python3
"""Host time of one CUDA tile-gather call, piece by piece, on one GPU.

    python3 tools/gather_host_costs.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA card.  Each
figure is the median over 25 repeats of 200 back-to-back calls, in us
per call, with no synchronise inside a repeat: the host's cost of
issuing the call, not the kernel's.  At the 720p luma MC site (15360
tiles of 15x15 from a [809, 1321] int32 plane) it times the wrapper
(``gather_tiles``), its checks, its allocation, its device and stream
getters beside the public calls they stand for, the extension call with
and without a launch, and one ``torch.take`` of the same tiles.  Prints
nvidia-smi's name and power limit first; --out FILE also writes the
figures as JSON.  Needs nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

def per_call_us(stmt, env, number=200, repeat=25) -> float:
    import torch
    vals = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        vals.append(timeit.timeit(stmt, number=number, globals=env) / number)
        torch.cuda.synchronize()
    return statistics.median(vals) * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="JSON file for the figures")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gather_host_costs: no CUDA device available")
    from svt_av1_tpu_torch.ops import gather as G
    from svt_av1_tpu_torch.ops import mc as MC
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)

    ext = G.kernel_module()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    plane = MC.pad_for_filter(torch.randint(
        0, 256, (768, 1280), generator=gen, dtype=torch.int32).to(dev), 17)
    mv = torch.randint(-17, 18, (96, 160), generator=gen,
                       dtype=torch.int32).to(dev)
    br, bc, kw = G.grid_tile_args(plane, mv, mv, 8, 17, 17, 7, -3)
    th, tw, n = kw["th"], kw["tw"], br.shape[0]
    hp, wp = plane.shape
    r, c = G.clamp_starts(br, bc, hp, wp, th, tw)
    flat = ((r[:, None] + torch.arange(th, device=dev))[:, :, None] * wp
            + (c[:, None] + torch.arange(tw, device=dev))[:, None, :])
    out = torch.empty(n, th, tw, dtype=plane.dtype, device=dev)
    stream = G._raw_stream(G._current_device())
    call = (0, plane.data_ptr(), hp, wp, 4, br.data_ptr(), bc.data_ptr(),
            out.data_ptr())
    env = dict(G=G, torch=torch, plane=plane, br=br, bc=bc, kw=kw, th=th,
               tw=tw, n=n, hp=hp, wp=wp, flat=flat, ext=ext, stream=stream,
               call=call)
    cases = [
        ("gather_tiles(plane, br, bc, **kw)",
         "G.gather_tiles(plane, br, bc, **kw)"),
        ("gather_tiles_cuda(plane, br, bc, th, tw)",
         "G.gather_tiles_cuda(plane, br, bc, th, tw)"),
        ("torch.take(plane, flat)", "torch.take(plane, flat)"),
        ("_check", "G._check(plane, br, bc, th, tw)"),
        ("check_cuda_args", "G.check_cuda_args(plane, br, bc)"),
        ("torch.empty(n, th, tw, dtype=, device=)",
         "torch.empty(n, th, tw, dtype=plane.dtype, device=plane.device)"),
        ("wrapper's device getter", "G._current_device()"),
        ("torch.cuda.current_device()", "torch.cuda.current_device()"),
        ("wrapper's stream getter", "G._raw_stream(0)"),
        ("torch.cuda.current_stream(0).cuda_stream",
         "torch.cuda.current_stream(0).cuda_stream"),
        ("extension call, n = 0 (no launch)",
         "ext.gather_tiles(*call, 0, th, tw, stream)"),
        ("extension call, launch at this site",
         "ext.gather_tiles(*call, n, th, tw, stream)"),
    ]
    res = {}
    for name, stmt in cases:
        res[name] = per_call_us(stmt, env)
        print(f"  {name:42s} {res[name]:7.2f} us", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"nvidia_smi": smi, "us_per_call": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
