#!/usr/bin/env python3
"""Rehearse chip_smoke.py on the CPU: every phase at small sizes, with
the CUDA pieces stubbed.

    python3 tools/rehearse_chip_smoke.py

chip_smoke.py refuses to run without a card, by design.  This script
imports it, shrinks its frame sizes (720p, 1080p and 4K to 192x128, the
480p batch to 4 frames of 64x64, two timed live slots), makes the card
look present (torch.cuda's queries and synchronisation, torch.device
"cuda" -> CPU, the Encoder's resolve_device -> CPU, nvidia-smi), runs
the gather's launches as its plain version while counting the main
design's launches as the kernel would, drops the 2 GB limit checks and
the profiler's kernel counts, and returns zero from the timers; then
runs main().  Its checks (launch counts, decode orders, card == "CPU"
bytes, the JSON lines) run as on the card, so a phase that would fail
there fails here first.  About 6 minutes on 4 CPU threads.
"""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    torch.set_num_threads(4)
    import chip_smoke as C
    import svt_av1_tpu_torch.pipeline.encoder as ENC
    from svt_av1_tpu_torch.ops import gather as G

    C.W720, C.H720 = 192, 128
    C.W1080, C.H1080 = 192, 128
    C.W4K, C.H4K = 192, 128
    C.VOD_KW = dict(C.VOD_KW, width=192, height=128)
    C.W480, C.H480, C.B480, C.N480 = 64, 64, 4, 8
    C.LIVE_TIMED = 2

    real_device = torch.device
    cpu = real_device("cpu")
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.empty_cache = lambda: None
    torch.device = lambda *a, **k: (
        cpu if a and str(a[0]).startswith("cuda") else real_device(*a, **k))
    real_run = subprocess.run
    subprocess.run = lambda cmd, *a, **k: (
        types.SimpleNamespace(stdout="CPU rehearsal, 0 W\n")
        if cmd[0] == "nvidia-smi" else real_run(cmd, *a, **k))

    G.kernel_module = lambda: None
    G.check_cuda_args = lambda *a: 0
    real_gather = G.gather_tiles

    def launch(design, plane, br, bc, ns, hp, wp, n, th, tw):
        if design == G._MAIN:
            counting.launches += 1
        return G.gather_tiles_ref(plane, br, bc, th, tw)

    def counting(plane, br, bc, **kw):
        """The main path's gather: on CPU tensors the real wrapper runs
        the plain version without counting, so count here."""
        counting.launches += 1
        return real_gather(plane, br, bc, **kw)

    counting.launches = 0
    G._launch = launch
    G.gather_tiles = counting
    ENC.resolve_device = lambda d: cpu
    C.limit_checks = lambda *a: None
    C.kernel_counts = lambda torch, svt: {C.B480: (0, 0.0), 1: (0, 0.0)}
    C.cuda_ms = lambda fn, iters=20, warm=3: (fn(), 0.0)[1]
    C.device_us = lambda fn, iters=20: 0.0
    C.host_us = lambda fn, calls=200: (fn(), 0.0)[1]
    return C.main()


if __name__ == "__main__":
    sys.exit(main())
