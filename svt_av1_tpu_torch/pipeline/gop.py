"""Mini-GOP planning for hierarchical-B (random access) coding.

Copy of svt_av1_tpu/pipeline/gop.py (host only, no device work).

The reference's picture-decision process reorders input pictures into
dyadic mini-GOPs and assigns each a prediction structure entry
(EbPictureDecisionProcess.c:1632 picture_decision_kernel,
EbPredictionStructure.c PredictionStructureGroup).  This module is the
host-side equivalent: given an anchor (already coded) and a span of
buffered frames, emit the decode-order plan of code/show steps.

Frames are coded no-show and displayed via show_existing_frame in
display order (the packetizer emits one tiny OBU_FRAME_HEADER TU per
display step), which keeps the emission rule uniform for leaves and
internal layers alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class CodeStep:
    disp: int                 # display index of the frame to code
    fwd: int                  # display index of the forward (past) ref
    bwd: Optional[int]        # backward (future) ref, None = P frame
    layer: int                # temporal layer (0 = mini-GOP base)


@dataclass
class ShowStep:
    disp: int                 # display index to emit via show_existing


def plan_minigop(lo: int, hi: int) -> list:
    """Decode-order plan for frames (lo, hi]: anchor lo is already
    coded/displayed.  Base frame hi codes first (fwd-only), then the
    dyadic interior; show steps interleave as soon as display order
    allows.  Works for any span length (truncated GOPs at EOS)."""
    assert hi > lo
    steps: list = []
    coded = set()
    dp = [lo + 1]   # next display index to emit

    def emit_shows():
        while dp[0] in coded:
            steps.append(ShowStep(dp[0]))
            dp[0] += 1

    def code(disp, fwd, bwd, layer):
        steps.append(CodeStep(disp, fwd, bwd, layer))
        coded.add(disp)
        emit_shows()

    def interior(a, b, depth):
        if b - a < 2:
            return
        mid = (a + b) // 2
        code(mid, a, b, depth)
        interior(a, mid, depth + 1)
        interior(mid, b, depth + 1)

    code(hi, lo, None, 0)
    interior(lo, hi, 1)
    assert dp[0] == hi + 1, "display emission incomplete"
    return steps


def plan_pins(steps: list, anchor: int) -> dict:
    """How many future uses each display index has inside this plan:
    once per appearance as a reference plus once for its show step.
    The anchor appears only as a reference."""
    pins: dict = {anchor: 0}
    for s in steps:
        if isinstance(s, CodeStep):
            pins[s.fwd] = pins.get(s.fwd, 0) + 1
            if s.bwd is not None:
                pins[s.bwd] = pins.get(s.bwd, 0) + 1
            pins.setdefault(s.disp, 0)
        else:
            pins[s.disp] = pins.get(s.disp, 0) + 1
    return pins


# layer -> qindex offset relative to the configured base q (CQP
# hierarchical quality allocation; the reference scales per-layer qp in
# its rate assignment — svt_aom_* qp scaling.  Base layers get better
# quality since everything references them.)
LAYER_Q_OFFSET = (-8, 6, 12, 16, 18)


def layer_qindex(base_qindex: int, layer: int) -> int:
    off = LAYER_Q_OFFSET[min(layer, len(LAYER_Q_OFFSET) - 1)]
    return max(1, min(255, base_qindex + off))
