#!/usr/bin/env python3
"""Encode the same synthetic IPPP clip with svt_av1_tpu (JAX, CPU) and
svt_av1_tpu_torch (PyTorch, CPU) and compare the packets byte for byte.

    JAX_PLATFORMS=cpu python3 tools/compare_torch_jax.py W H FRAMES

Prints one line per frame: packet sizes, payload equality, recon
equality.  Exits 1 on any difference.  Large sizes take minutes on the
CPU (720p: about a minute of JAX compiles plus a few seconds a frame).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    w, h, n = (int(a) for a in sys.argv[1:4])
    import jax
    jax.config.update("jax_platforms", "cpu")
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.io.yuv import synthetic_frame
    from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    kw = dict(width=w, height=h, qp=40, intra_period=-1, pred_structure=0,
              scene_change_detection=False, recon_output=True)
    frames = [synthetic_frame(w, h, seed=i) for i in range(n)]
    t = time.time()
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    print(f"jax {time.time() - t:.1f} s")
    t = time.time()
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    print(f"torch {time.time() - t:.1f} s")
    ok = len(want) == len(got) == n
    for i, (a, b) in enumerate(zip(want, got)):
        same = a.payload == b.payload
        rec = all((getattr(a.recon, p) == getattr(b.recon, p)).all()
                  for p in ("y", "u", "v"))
        ok &= same and rec
        print(f"frame {i}: {len(a.payload)} / {len(b.payload)} bytes, "
              f"payload equal {same}, recon equal {rec}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
