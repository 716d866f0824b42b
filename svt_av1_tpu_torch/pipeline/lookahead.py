"""Lookahead window: open-loop complexity -> frame-level q assignment
(the port's copy of svt_av1_tpu.pipeline.lookahead, host numpy).

The reference's InitialRateControl process buffers up to
look_ahead_distance pictures and derives per-picture complexity from
open-loop ME before rate control assigns q
(EbInitialRateControlProcess.c:1640, look-ahead window handling; the
complexity feeds rate_control_kernel's frame-level qp scaling).

TPU build equivalent: a host-side sliding window over 1/8-scale luma
with mean-abs-difference temporal complexity.  Frames leave the window
with a bounded qindex offset: temporally simple pictures get better
quality (they persist as references in the IPPP chain), complex ones
spend fewer bits — classic open-loop frame-level adaptive quantization.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

MAX_LOOKAHEAD = 120          # ref EbSvtAv1Enc.h look_ahead_distance cap
_MAX_OFFSET = 12             # qindex clamp (+-)


class Lookahead:
    def __init__(self, distance: int) -> None:
        self.distance = max(1, min(int(distance), MAX_LOOKAHEAD))
        self._buf: List = []        # (frame, complexity)
        self._prev_small: Optional[np.ndarray] = None

    def _complexity(self, frame) -> float:
        small = frame.y[::8, ::8].astype(np.int32)
        prev, self._prev_small = self._prev_small, small
        if prev is None or prev.shape != small.shape:
            return -1.0             # first frame: no temporal signal
        return float(np.abs(small - prev).mean()) + 1e-3

    def push(self, frame) -> List[Tuple[object, int]]:
        """Add a source picture; returns frames leaving the window as
        (frame, qindex_offset)."""
        self._buf.append((frame, self._complexity(frame)))
        out = []
        while len(self._buf) > self.distance:
            out.append(self._pop())
        return out

    def flush(self) -> List[Tuple[object, int]]:
        out = []
        while self._buf:
            out.append(self._pop())
        return out

    def _pop(self) -> Tuple[object, int]:
        frame, c = self._buf.pop(0)
        if c < 0:
            return frame, 0
        window = [x for _, x in self._buf if x > 0] or [c]
        med = sorted(window)[len(window) // 2]
        off = int(round(6.0 * math.log2(max(c, 1e-3) / max(med, 1e-3))))
        return frame, max(-_MAX_OFFSET, min(_MAX_OFFSET, off))
