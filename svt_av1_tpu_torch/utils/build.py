"""Build native sources of the port into ``build/svt_av1_tpu_torch/``.

Every native piece of the port is a shared library: the C++ entropy
coder a plain-C one loaded with ``ctypes``, the CUDA tile gather a small
CPython extension module (no PyTorch headers).  Libraries are built
at first use, from the sources in the checkout, into the repository's
``build/`` directory (never into the package), and are keyed on a hash
of the source and the command, so an edited source rebuilds and an
unchanged one loads at once.  The compiler's output goes to a log file
beside the library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "svt_av1_tpu_torch"


def build_shared(src: Path, name: str, cmd: list) -> Path:
    """Compile ``src`` into ``BUILD_DIR/lib<name>-<hash>.so``.

    ``cmd`` is the compiler command without the source and output
    arguments (for example ``["g++", "-O3", "-shared", "-fPIC"]``).
    Returns the library path; raises ``RuntimeError`` naming the log
    file when the compiler fails.
    """
    key = hashlib.sha256(src.read_bytes() + " ".join(cmd).encode())
    tag = key.hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = BUILD_DIR / f"{name}-{tag}.log"
    # concurrent builds (test workers) each write their own temporary
    # file; the rename publishes a whole library or nothing
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    with open(log, "w") as fh:
        res = subprocess.run(cmd + ["-o", str(tmp), str(src)],
                             stdout=fh, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed; see {log}")
    os.replace(tmp, so)
    return so
