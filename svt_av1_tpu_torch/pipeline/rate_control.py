"""Rate control: CQP q derivation and a VBR/CVBR buffer-model controller.

Port of svt_av1_tpu/pipeline/rate_control.py (host numpy, unchanged but
for its imports, which point into this package).

The reference's rate control stage (rate_control_kernel,
EbRateControlProcess.c:3785) runs four modes: 0=CQP (+qp scaling),
1=model, 2=VBR, 3=constrained VBR, driven by per-GOP parallel state and
bit feedback from packetization.  The TPU build keeps RC a host-side
controller (it is tiny, serial, and feedback-driven), re-expressed as a
leaky-bucket + per-frame-type q offsets; the device frame steps take q
as a runtime scalar, so changing q never recompiles.

Simplifications vs the reference (tracked for later rounds): no
lookahead-informed allocation yet, per-frame (not per-EC-row) feedback,
single-GOP state (no PARALLEL_GOP_MAX_NUMBER queue).
"""

from __future__ import annotations

import numpy as np

from svt_av1_tpu_torch import tables


def qp_to_qindex(qp: int) -> int:
    """0..63 QP -> 0..255 qindex (ref qp scale, ~4x)."""
    return min(255, max(1, qp * 4))


class ModelRateController:
    """Model-based rate control (ref rate_control_mode=1,
    RateControlModel / rate_control_get_quantizer,
    EbRateControlProcess.c:3958): maintains a bits ~= C / qstep model
    from feedback and inverts it per frame to hit the target, with a
    leaky-bucket drift correction on top."""

    KEY_BOOST_Q = 24

    def __init__(self, target_bit_rate: int, fps: float,
                 min_qp: int = 0, max_qp: int = 63) -> None:
        from svt_av1_tpu_torch import tables
        self._tables = tables
        self.target_bpf = max(1.0, target_bit_rate / max(fps, 1e-6))
        self.fps = max(fps, 1.0)
        self.min_qi = max(1, qp_to_qindex(max(min_qp, 1)))
        self.max_qi = qp_to_qindex(max_qp)
        self.C = None          # bits * qstep (complexity constant)
        self.fullness = 0.0
        self.qi = 128

    def _qstep(self, qi: int) -> float:
        return max(1.0, self._tables.ac_q(int(qi), 8) / 8.0)

    def frame_qindex(self, is_key: bool) -> int:
        if self.C is not None:
            # invert the model: qstep* = C / target (with drift credit)
            budget = self.target_bpf - 0.1 * self.fullness
            want = self.C / max(budget, 1.0)
            lo, hi = self.min_qi, self.max_qi
            while lo < hi:      # qstep is monotone in qindex
                mid = (lo + hi) // 2
                if self._qstep(mid) < want:
                    lo = mid + 1
                else:
                    hi = mid
            self.qi = lo
        qi = self.qi - (self.KEY_BOOST_Q if is_key else 0)
        return int(np.clip(qi, self.min_qi, self.max_qi))

    def update(self, bits: int, is_key: bool, layer: int = 0,
               qindex=None) -> None:
        if layer < 0:           # header-only TU (show_existing)
            self.fullness += bits
            return
        budget = self.target_bpf * (4.0 if is_key else 1.0)
        self.fullness += bits - budget
        if is_key:
            return              # keyframes have their own scale; skip C
        c_obs = bits * self._qstep(self.qi)
        self.C = c_obs if self.C is None else 0.75 * self.C + 0.25 * c_obs


class GopRateController:
    """Hierarchical-B VBR v2: plan a whole mini-GOP's bits at dispatch.

    The reference keeps per-GOP-interval parallel RC state
    (rate_control_param_queue[PARALLEL_GOP_MAX_NUMBER],
    EbRateControlProcess.c:3895-3901) and allocates hierarchical-layer
    budgets from lookahead stats.  TPU-build equivalent: at span
    dispatch the encoder hands over the span's frame count, layer list
    and per-frame complexity (mean-abs-diff of consecutive sources —
    the mini-GOP buffer IS the lookahead window); this controller
    solves for the base qindex such that the per-layer bits models
    predict the span budget, where each layer keeps its own
    bits*qstep complexity constant.  Keyframe budget comes from the
    measured intra/inter complexity ratio instead of a hardcoded 4x.
    """

    # single source of truth: the dispatcher applies gop.layer_qindex,
    # so the bit models must see the identical per-layer offsets
    from svt_av1_tpu_torch.pipeline.gop import LAYER_Q_OFFSET as LAYER_OFF

    def __init__(self, target_bit_rate: int, fps: float,
                 min_qp: int = 0, max_qp: int = 63,
                 constrained: bool = False) -> None:
        self.target_bpf = max(1.0, target_bit_rate / max(fps, 1e-6))
        self.fps = max(fps, 1.0)
        self.min_qi = max(1, qp_to_qindex(max(min_qp, 1)))
        self.max_qi = qp_to_qindex(max_qp)
        self.constrained = constrained
        self.fullness = 0.0
        self.base_qi = 128
        # per-layer complexity constants C_l (bits * qstep); None until
        # first observation of that layer
        self._C = [None] * 5
        self._key_C = None
        self._mad_ema = None

    def _qstep(self, qi) -> float:
        return max(1.0, tables.ac_q(int(np.clip(qi, 1, 255)), 8) / 8.0)

    def _span_bits(self, qi: float, layers: list) -> float:
        """Predicted span bits at base qindex qi from the layer models."""
        tot = 0.0
        for l in layers:
            li = min(l, 4)
            C = self._C[li]
            if C is None:
                C = 4000.0 * self._qstep(128)   # prior until observed
            tot += C / self._qstep(qi + self.LAYER_OFF[li])
        return tot

    def plan_span(self, layers: list, mads: list) -> None:
        """Called once per mini-GOP dispatch with the span's layer list
        and per-frame complexities; sets base_qi for the span."""
        mad = float(np.mean(mads)) if mads else 0.0
        self._mad_ema = (mad if self._mad_ema is None
                         else 0.8 * self._mad_ema + 0.2 * mad)
        scale = 1.0
        if self._mad_ema and self._mad_ema > 1e-3:
            # busier spans borrow bits, calm spans repay (VBR)
            scale = float(np.clip(mad / self._mad_ema, 0.6, 1.7))
        budget = self.target_bpf * len(layers) * scale
        # drift repayment: spread the buffer error over ~2 seconds
        budget -= self.fullness * len(layers) / (2.0 * self.fps)
        budget = max(budget, self.target_bpf * len(layers) * 0.2)
        lo, hi = self.min_qi, self.max_qi
        while lo < hi:
            mid = (lo + hi) // 2
            if self._span_bits(mid, layers) > budget:
                lo = mid + 1
            else:
                hi = mid
        self.base_qi = lo

    def frame_qindex(self, is_key: bool) -> int:
        if is_key:
            # measured keyframe boost: size the key down-shift so the
            # predicted key cost stays near its complexity-derived
            # share (~sqrt of the intra/inter cost ratio), replacing
            # the fixed 4x assumption
            ratio = 4.0
            if self._key_C and self._C[0]:
                ratio = float(np.clip(self._key_C / self._C[0], 1.5, 8.0))
            off = int(np.clip(10.0 * np.log2(ratio), 8, 40))
            return int(np.clip(self.base_qi - off, self.min_qi,
                               self.max_qi))
        return int(np.clip(self.base_qi, self.min_qi, self.max_qi))

    def update(self, bits: int, is_key: bool, layer: int = 0,
               qindex=None) -> None:
        """qindex: the ACTUALLY dispatched frame qindex (incl. layer
        offset, AQ offset and clipping) carried through the packet —
        re-deriving it here would fit C_l against the wrong qstep when
        feedback arrives after the next plan_span re-plans base_qi."""
        self.fullness += bits - (self.target_bpf if layer >= 0 else 0)
        if self.constrained:
            cap = self.target_bpf * self.fps
            self.fullness = float(np.clip(self.fullness, -cap, cap))
        if layer < 0:
            return    # show_existing / header-only TU: bits only
        if qindex is None:
            qi = self.frame_qindex(is_key)
            qindex = qi if is_key else qi + self.LAYER_OFF[min(layer, 4)]
        c_obs = bits * self._qstep(qindex)
        if is_key:
            self._key_C = (c_obs if self._key_C is None
                           else 0.5 * self._key_C + 0.5 * c_obs)
            return
        li = min(layer, 4)
        prev = self._C[li]
        self._C[li] = c_obs if prev is None else 0.7 * prev + 0.3 * c_obs


class RateController:
    """Leaky-bucket VBR: pick per-frame qindex, absorb bit feedback."""

    KEY_BOOST_Q = 24      # keyframes run ~this much lower qindex

    def __init__(self, target_bit_rate: int, fps: float,
                 min_qp: int = 0, max_qp: int = 63,
                 constrained: bool = False) -> None:
        self.target_bpf = max(1.0, target_bit_rate / max(fps, 1e-6))
        self.fps = max(fps, 1.0)
        self.min_qi = max(1, qp_to_qindex(max(min_qp, 1)))
        self.max_qi = qp_to_qindex(max_qp)
        self.constrained = constrained
        self.fullness = 0.0          # bits over (+) / under (-) target
        self.qi = 128                # running base qindex
        self._bootstrapped = False

    def frame_qindex(self, is_key: bool) -> int:
        qi = self.qi
        if is_key:
            qi -= self.KEY_BOOST_Q
        return int(np.clip(qi, self.min_qi, self.max_qi))

    def update(self, bits: int, is_key: bool, layer: int = 0,
               qindex=None) -> None:
        """Feedback after a frame is packetized (ref RC feedback tasks)."""
        if layer < 0:           # header-only TU (show_existing)
            self.fullness += bits
            return
        # keyframes are budgeted at ~4x a P frame
        budget = self.target_bpf * (4.0 if is_key else 1.0)
        self.fullness += bits - budget
        # leak: proportional correction toward target, stronger when the
        # buffer diverges past one second worth of bits
        err = self.fullness / self.target_bpf
        step = 1.0 + min(abs(err) * 0.5, 7.0)
        if not self._bootstrapped:
            # jump-start: scale q by the log of the first frame's miss
            ratio = max(bits / budget, 1e-3)
            self.qi += int(np.clip(40.0 * np.log2(ratio), -80, 80))
            self._bootstrapped = True
        elif err > 0.25:
            self.qi += int(step)
        elif err < -0.25:
            self.qi -= int(step)
        if self.constrained:
            # CVBR: hard-clamp drift to one second of buffered bits
            cap = self.target_bpf * self.fps
            self.fullness = float(np.clip(self.fullness, -cap, cap))
        self.qi = int(np.clip(self.qi, self.min_qi, self.max_qi))
