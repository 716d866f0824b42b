"""Normative AV1 constant tables.

Numeric spec constants (default CDFs, quantizer lookups) live in
``data/av1_tables.npz`` (see ``tools/extract_av1_tables.py`` for provenance);
algorithmically-defined tables (scan orders, cosine tables) are generated
here at import time.

Reference parity: EbCabacContextModel.c (CDF data),
EbModeDecisionConfigurationProcess.c:134-296 (qlookup).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data" / "av1_tables.npz"


@functools.lru_cache(maxsize=1)
def spec_tables() -> dict:
    """All extracted spec tables as a name -> np.ndarray dict (read-only)."""
    with np.load(_DATA) as z:
        out = {k: z[k] for k in z.files}
    for v in out.values():
        v.setflags(write=False)
    return out


def dc_q(qindex: int, bit_depth: int = 8) -> int:
    """Quantizer step for DC coefficients (AV1 spec §7.12.2 dc_q)."""
    t = spec_tables()
    return int(t[f"dc_qlookup_{bit_depth}"][np.clip(qindex, 0, 255)])


def ac_q(qindex: int, bit_depth: int = 8) -> int:
    t = spec_tables()
    return int(t[f"ac_qlookup_{bit_depth}"][np.clip(qindex, 0, 255)])


# ---------------------------------------------------------------------------
# Cosine tables (AV1 spec §7.13.2.1 cos128/sin128; libaom cospi convention).
# cospi(b)[i] == round(2^b * cos(i*pi/128)) for i in 0..63.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cospi_arr(cos_bit: int) -> np.ndarray:
    i = np.arange(64)
    v = np.round((1 << cos_bit) * np.cos(i * np.pi / 128.0)).astype(np.int32)
    v.setflags(write=False)
    return v


# ---------------------------------------------------------------------------
# Scan orders (AV1 spec §, "Scan tables").  For the transform sizes/classes
# the TPU build uses, the default scan is the up-right diagonal scan over the
# (possibly 64->32 clipped) transform block; generated, not stored.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def default_scan(rows: int, cols: int) -> np.ndarray:
    """AV1 default scan order: scan[k] = raster position (row*cols+col).

    Square sizes use the zig-zag diagonal scan (anti-diagonals with
    alternating direction: odd diagonals walk top-right -> bottom-left,
    even ones bottom-left -> top-right); rectangular sizes use the uniform
    up-right diagonal scan (always top-right -> bottom-left).  Matches the
    spec Default_Scan_* tables (data check in tests/test_tables.py).
    """
    order = []
    for d in range(rows + cols - 1):
        if (rows == cols and d % 2 == 0) or rows < cols:
            rs = range(min(d, rows - 1), -1, -1)  # bottom-left -> top-right
        else:
            rs = range(0, rows)  # top-right -> bottom-left
        for r in rs:
            c = d - r
            if c < 0 or c >= cols:
                continue
            order.append(r * cols + c)
    out = np.array(order, dtype=np.int32)
    assert out.size == rows * cols
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def row_scan(rows: int, cols: int) -> np.ndarray:
    """Row-major scan (used by horizontal 1-D transform classes)."""
    return np.arange(rows * cols, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def col_scan(rows: int, cols: int) -> np.ndarray:
    """Column-major scan (used by vertical 1-D transform classes)."""
    out = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols).T.ravel()
    out = np.ascontiguousarray(out)
    out.setflags(write=False)
    return out
