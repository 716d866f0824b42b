"""Public encoder API of the port.

Port of svt_av1_tpu/pipeline/encoder.py for the slice it covers: CQP
or rate control (1: the bits-model controller; 2 / 3: VBR / constrained
VBR, whole-mini-GOP planning on hier-B) at 8 or 10 bits and presets 0-8
(0-7: the full-RD inter merge, the 16x16 keyframe partition search on
inter streams, and with multi-reference prediction a third reference on
hier-B interior frames; 0-5 add the inter tx-type search, rectangular
inter leaves and the rich intra mode set) — all-intra streams,
low-delay-P (IPPP) chains with one reference
(``EncoderConfig(intra_period=-1, pred_structure=0)``, with global
motion), low-delay B (``pred_structure=1``: every frame predicts from
the previous frame and the keyframe) and hierarchical-B random access
(``pred_structure=2``, any ``hierarchical_levels``, ``compound_mode`` 0
or 1), with deblocking, CDEF and loop restoration; adaptive
quantization (a frame q offset from picture analysis, and at level 2
per-superblock delta-q on hier-B inter frames); scene-change
keyframes and look-ahead q offsets in the flat structures, per-frame QP
overrides (``push_qp``), tiled inter frames and checkpoint / restore.
Anything else raises ``NotImplementedError`` (config.check_slice).
10-bit pixels live on the device as int16 (MC.pixel_dtype) and on the
host as numpy uint16, as the reference package's frames and recon are.

Dataflow per frame:
  host pad  ->  device encode (intra wavefront, or the P / B step:
  PyTorch + the CUDA tile gather)  ->  device->host copy of the step
  outputs  ->  host loop restoration (ops.restoration; the restored
  planes go back to the device as the reference)  ->  host entropy tile
  (C++ coder, or pipeline.tile for restored frames)  ->  OBU
  packetization

The encoder is synchronous: IPPP and low-delay-B frames come out as
they are sent (or, with a look-ahead window, as they leave it).  Rate
control absorbs a packet's bits when ``get_packet`` (or ``get_recon``)
reaches it, as the reference package's does, and every packet already
coded before it plans a hier-B span.
All-intra frames gather in an inbox of ``device_batch`` frames, which
one batched device step codes (the wavefront and the in-loop filters
with a leading frame axis) and the host entropy-codes on a thread pool;
``get_packet`` flushes a partial batch.
Hierarchical B buffers the frames of a mini-GOP until it is full (or
until ``flush()`` / ``send_picture(None)`` codes the truncated span),
then codes it in the reference package's decode order: coded
no-show TUs (``Packet.show=False``, ``pts=-1``) interleaved with the
small show_existing TUs that display them (``Packet.show=True``,
``pts = display_idx``).  Reference planes stay on the device between
frames, in an 8-slot book for hierarchical B.  The reference package's
TPU transfer packing (one-buffer uploads, packed fetches, sparse level
packs) is not needed here: the outputs come back as plain host arrays.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from svt_av1_tpu_torch.config import EncoderConfig, check_slice
from svt_av1_tpu_torch.entropy import obu as O
from svt_av1_tpu_torch.entropy.cdf_model import FrameContext
from svt_av1_tpu_torch.io.yuv import Frame
from svt_av1_tpu_torch.ops import cdef as CDEF
from svt_av1_tpu_torch.ops import deblock as DB
from svt_av1_tpu_torch.ops import mc as MC
from svt_av1_tpu_torch.ops import restoration as LRR
from svt_av1_tpu_torch.pipeline import analysis as AN
from svt_av1_tpu_torch.pipeline import inter_encoder as PE
from svt_av1_tpu_torch.pipeline import intra_encoder as IE
from svt_av1_tpu_torch.pipeline.gop import (CodeStep, layer_qindex,
                                            plan_minigop, plan_pins)
from svt_av1_tpu_torch.pipeline.lookahead import Lookahead
from svt_av1_tpu_torch.pipeline.rate_control import (
    GopRateController, ModelRateController, RateController)
from svt_av1_tpu_torch.pipeline.tile import TileWriter


# delta-q resolution of per-superblock adaptive quantization (spec
# delta_q_res: deltas in units of 1 << DQ_RES)
DQ_RES = 2


@dataclasses.dataclass
class Packet:
    """Output bitstream buffer (ref EbBufferHeaderType)."""
    payload: bytes
    pts: int
    is_keyframe: bool
    recon: Optional[Frame] = None
    psnr: Optional[tuple] = None
    # hier-B: coded no-show TUs have show=False (display comes later via
    # a show_existing TU); display_idx is the display-order position of
    # the picture this TU codes or shows (None for flat modes)
    show: bool = True
    display_idx: Optional[int] = None
    qindex: Optional[int] = None
    # two-reference frames: 8x8 cells predicted by the compound average
    compound_cells: Optional[int] = None
    # keyframes at the RD presets: 8x8 cells inside 16x16 leaves
    leaf16_cells: Optional[int] = None
    # inter frames at presets <= 5: 8x8 cells inside rect leaves, and
    # cells coded with IDTX
    rect_cells: Optional[int] = None
    idtx_cells: Optional[int] = None


def resolve_device(device) -> torch.device:
    """The working device: CUDA unless the caller asks for the CPU.  A
    CUDA device on a machine without one raises — there is no silent
    fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("svt_av1_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to encode on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Encoder:
    """ref eb_init_handle + eb_svt_enc_set_parameter + eb_init_encoder."""

    def __init__(self, config: EncoderConfig, device="cuda") -> None:
        config.validate()
        check_slice(config)
        self.cfg = config
        self.device = resolve_device(device)
        # hier-B random access needs order hints for ref list semantics
        # and the skip-mode gate (ref Av1GenerateRpsInfo order hints)
        self._hier = config.pred_structure == 2 and not config.intra_only
        # low-delay B: every frame references the previous frame (LAST)
        # and the keyframe anchor (GOLDEN), both forward, shown in order
        self._ldb = config.pred_structure == 1 and not config.intra_only
        # preset signals (ref signal_derivation_enc_dec_kernel_oq):
        # presets 6-7 run the full-RD inter merge and the 16x16 keyframe
        # partition search; multi-reference prediction (a third, ALTREF
        # reference on hier-B interior frames) follows multi_ref, or the
        # preset when it is -1
        self._rdo = config.enc_mode <= 7
        self._mrp = (bool(config.multi_ref) if config.multi_ref >= 0
                     else config.enc_mode <= 7)
        # presets <= 5 add the inter tx-type search, rectangular inter
        # leaves (PARTITION_HORZ / VERT at the 16 / 32 nodes) and the rich
        # intra mode set
        self._txs = config.enc_mode <= 5
        self._rect = config.enc_mode <= 5
        self.seq = O.SequenceParams(
            config.width, config.height, config.bit_depth, config.sb_size,
            enable_cdef=config.enable_cdef, enable_order_hint=self._hier,
            film_grain_present=False,
            enable_restoration=config.enable_restoration,
            enable_warped_motion=False, screen_content=False)
        # frame-level interpolation filter: forced by config, or decided
        # once per stream from open-loop stats of the first inter source
        self._interp_filt = (config.interp_filter
                             if config.interp_filter >= 0 else None)
        # global motion (TRANSLATION, IPPP chains): open-loop per-frame
        # estimate between consecutive sources
        self._gm_enab = (config.enable_global_motion
                         and config.pred_structure == 0)
        self._gm_prev_src = None
        self._send_idx = 0
        # all-intra: frames awaiting the batched device step, and the
        # count of frames it coded (their pts)
        self._inbox: list[Frame] = []
        self._frame_idx = 0
        self._packets: list[Packet] = []
        self._ref_dev = None       # device recon planes of the last frame
        self._qp_queue: list = []  # push_qp overrides, in coding order
        # scene-change detector state: the previous 1/8-scale luma and
        # the running mean of its frame-to-frame differences
        self._scd_prev = None
        self._scd_avg = None
        # low-delay B references: (device planes, slot) of the last coded
        # frame and of the keyframe
        self._ldb_last = None
        self._ldb_golden = None
        # hier-B frames coded from three references
        self._nrefs3_frames = 0
        if self._hier:
            self._store: dict = {}         # disp -> {dev, slot, pins}
            self._free_slots = list(range(8))
            self._anchor: Optional[int] = None
            self._buf: list = []           # (disp, Frame) since anchor
            self._gop_n = 1 << config.hierarchical_levels
        # look-ahead window (flat structures; hier-B's mini-GOP buffer is
        # its own reordering window)
        self._la = None
        if (config.look_ahead_distance > 0 and not config.intra_only
                and not self._hier):
            self._la = Lookahead(config.look_ahead_distance)
        # rate control: the controller, and the feedback of packets coded
        # but not yet absorbed, in coding order: groups of (packet, layer)
        # absorbed together (an all-intra batch is one group)
        self._rc = None
        self._rc_fb: list = []
        if config.rate_control_mode != 0:
            fps = config.frame_rate_num / max(config.frame_rate_den, 1)
            args = (config.target_bit_rate, fps, config.min_qp_allowed,
                    config.max_qp_allowed)
            cvbr = config.rate_control_mode == 3
            if config.rate_control_mode == 1:
                self._rc = ModelRateController(*args)
            elif self._hier:
                # hier-B VBR / CVBR: whole-mini-GOP planning with
                # per-layer bit models
                self._rc = GopRateController(*args, constrained=cvbr)
            else:
                self._rc = RateController(*args, constrained=cvbr)

    def push_qp(self, qp: Optional[int]) -> None:
        """Queue a per-frame QP override, consumed in coding order (ref
        use_qp_file / SendQpOnTheFly).  None keeps the configured q for
        that frame."""
        self._qp_queue.append(qp)

    def _aq_offset(self, frame: Frame, stats=None) -> int:
        """Frame-level adaptive quantization from picture analysis
        (stats: a PictureStats already computed for this frame)."""
        if not self.cfg.enable_adaptive_quantization:
            return 0
        return AN.aq_frame_offset(stats if stats is not None
                                  else AN.analyze(frame.y),
                                  self.cfg.bit_depth)

    def _frame_qindex(self, is_key: bool) -> int:
        """The frame's base qindex: the next push_qp override, else the
        rate controller's pick, else the configured qp (CQP: is_key does
        not change it)."""
        if self._qp_queue:
            override = self._qp_queue.pop(0)
            if override is not None:
                return _qp_to_qindex(int(override))
        if self._rc is not None:
            return self._rc.frame_qindex(is_key)
        return _qp_to_qindex(self.cfg.qp)

    def _emit(self, pkts, layer: int = 0) -> None:
        """Queue coded packets for get_packet; with rate control their
        feedback waits, as one group, until get_packet reaches them
        (layer: the hier-B layer, -1 for a show-existing TU)."""
        self._packets.extend(pkts)
        if self._rc is not None:
            self._rc_fb.append([(p, layer) for p in pkts])

    def _absorb(self, group) -> None:
        """Rate-control feedback of one group of packets."""
        for p, layer in group:
            if layer < 0:
                self._rc.update(len(p.payload) * 8, False, layer=-1)
            else:
                self._rc.update(len(p.payload) * 8, p.is_keyframe,
                                layer=layer, qindex=p.qindex)

    def _scene_cut(self, frame: Frame) -> bool:
        """Scene-change test on a 1/8-scale luma: the mean absolute
        difference to the previous source against a running mean of it
        (ref picture_decision_kernel scene-change windows, reduced as in
        the reference package)."""
        if not self.cfg.scene_change_detection:
            return False
        small = frame.y[::8, ::8].astype(np.int32)
        prev = self._scd_prev
        self._scd_prev = small
        if prev is None or prev.shape != small.shape:
            return False
        mad = float(np.abs(small - prev).mean())
        avg = self._scd_avg
        self._scd_avg = mad if avg is None else 0.75 * avg + 0.25 * mad
        if avg is None:
            return mad > 40.0
        return mad > max(25.0, 4.0 * avg)

    # -- checkpoint / resume: references never cross a keyframe, so a
    # resume restarts at the next GOP boundary -----------------------------
    def checkpoint(self) -> dict:
        """Snapshot the stream state.  Take it with every packet drained
        (and a hier-B mini-GOP flushed); a resume restarts with a
        keyframe, so a mid-GOP resume point stays decodable."""
        if self._packets or self._inbox:
            raise RuntimeError("drain packets before checkpointing")
        if self._hier and self._buf:
            raise RuntimeError("flush the mini-GOP first")
        # frame_idx: the reference's count of coded frames, which equals
        # send_idx in every inter structure the port runs (all-intra
        # frames are counted by the batch path, which leaves send_idx)
        frame_idx = (self._frame_idx if self.cfg.intra_only
                     else self._send_idx)
        st = {"send_idx": self._send_idx, "frame_idx": frame_idx,
              "scd_avg": self._scd_avg}
        if self._rc is not None:
            # the reference's fields (its flat VBR controller has all
            # three)
            st["rc"] = {"fullness": self._rc.fullness, "qi": self._rc.qi,
                        "boot": self._rc._bootstrapped}
        return st

    def restore(self, st: dict) -> None:
        """Resume from a checkpoint() snapshot, in a fresh encoder (e.g.
        a new process after a host loss).  As in the reference package,
        the IPPP and hier-B references are dropped (the next frame is a
        keyframe), the low-delay-B ones are not."""
        self._send_idx = st["send_idx"]
        self._frame_idx = st["frame_idx"]
        if st.get("scd_avg") is not None:
            self._scd_avg = st["scd_avg"]
        self._scd_prev = None
        self._ref_dev = None
        if self._hier:
            self._store = {}
            self._free_slots = list(range(8))
            self._anchor = None
            self._buf = []
        if "rc" in st and self._rc is not None:
            self._rc.fullness = st["rc"]["fullness"]
            self._rc.qi = st["rc"]["qi"]
            self._rc._bootstrapped = st["rc"]["boot"]

    # -- ref eb_svt_enc_stream_header ------------------------------------------
    def stream_header(self) -> bytes:
        return O.write_sequence_header(self.seq)

    # -- ref eb_svt_enc_send_picture ---------------------------------------------
    def send_picture(self, frame: Optional[Frame]) -> None:
        """Encode the picture (IPPP / low-delay B / all-intra: its packet
        is then ready for get_packet, or once it leaves the look-ahead
        window; hier-B: buffered until its mini-GOP is full).
        send_picture(None) signals end-of-stream and flushes any buffered
        frames."""
        if frame is None:
            self.flush()
            return
        self._send_inner(frame)

    def _send_inner(self, frame: Frame) -> None:
        if self.cfg.intra_only:
            self._inbox.append(frame)
            if len(self._inbox) >= max(1, self.cfg.device_batch):
                self._dispatch_inbox()
        elif self._hier:
            self._hier_send(frame)
        elif self._la is not None:
            for f, q_off in self._la.push(frame):
                self._send_flat(f, q_off)
        else:
            self._send_flat(frame, 0)

    def _send_flat(self, frame: Frame, q_off: int) -> None:
        if self._ldb:
            self._ldb_send(frame, q_off)
        else:
            self._dispatch_one(frame, q_off)

    def flush(self) -> None:
        """End-of-stream: code any buffered partial mini-GOP (truncated
        dyadic structure, like the reference's incomplete mini-GOP
        handling in picture decision) and drain the look-ahead window."""
        if self._hier and self._buf:
            self._dispatch_span()
        if self._la is not None:
            for f, q_off in self._la.flush():
                self._send_flat(f, q_off)

    # -- hierarchical-B scheduling (ref picture_decision_kernel) ---------------
    def _hier_send(self, frame: Frame) -> None:
        d = self._send_idx
        self._send_idx += 1
        if self._anchor is None or self._is_key(d):
            self._dispatch_span()          # truncated GOP before the key
            self._code_key_anchor(d, frame)
        else:
            self._buf.append((d, frame))
            if len(self._buf) >= self._gop_n:
                self._dispatch_span()

    def _hint(self, disp: int) -> int:
        return disp & ((1 << self.seq.order_hint_bits) - 1)

    def _unpin(self, disp: int) -> None:
        e = self._store[disp]
        e["pins"] -= 1
        if e["pins"] <= 0:
            self._free_slots.append(e["slot"])
            del self._store[disp]

    def _code_key_anchor(self, disp: int, frame: Frame) -> None:
        """Shown keyframe: decoder-side it refreshes every slot, so the
        slot book restarts with the keyframe in slot 0."""
        qindex = self._frame_qindex(True)
        dev, planes, deb = self._intra_dispatch(frame, qindex)
        lr = host = None
        if deb is not None:
            lr, host, planes = self._lr_from_dev(frame, planes, deb)
        self._store = {disp: {"dev": planes, "slot": 0, "pins": 1}}
        self._free_slots = list(range(1, 8))
        self._anchor = disp
        pkt = self._make_packet(frame, dev, qindex, self._hint(disp), lr,
                                host)
        pkt.pts = pkt.display_idx = disp
        self._emit([pkt])

    def _dispatch_span(self) -> None:
        """Code the buffered span (anchor, last] in dyadic decode order,
        with show_existing TUs interleaved (gop.plan_minigop).  Pins
        count each picture's remaining uses (as a reference, its show
        step, and the next span's anchor); a slot is free again when its
        picture's pins reach 0."""
        if not self._buf:
            return
        lo = self._anchor
        hi = self._buf[-1][0]
        frames = dict(self._buf)
        self._buf = []
        steps = plan_minigop(lo, hi)
        if self._rc is not None:
            # absorb the feedback of every packet coded so far before
            # planning (the reference absorbs the packets whose entropy
            # coding has finished by then)
            while self._rc_fb:
                self._absorb(self._rc_fb.pop(0))
        if hasattr(self._rc, "plan_span"):
            # the span's layers and complexities (mean absolute
            # differences of consecutive sources over the buffered
            # mini-GOP, its look-ahead window) to the GOP planner
            layers = [st.layer for st in steps if isinstance(st, CodeStep)]
            mads, prev = [], None
            for d in sorted(frames):
                y = frames[d].y
                if prev is not None:
                    mads.append(float(np.mean(np.abs(
                        y.astype(np.int16) - prev.astype(np.int16)))))
                prev = y
            self._rc.plan_span(layers, mads)
        pins = plan_pins(steps, lo)
        pins[hi] = pins.get(hi, 0) + 1     # hi becomes the next anchor
        pending_pins = {}
        for d, n in pins.items():
            if d in self._store:
                self._store[d]["pins"] += n
            else:
                pending_pins[d] = n
        self._unpin(lo)                    # release the old anchor pin
        aq = int(self.cfg.enable_adaptive_quantization)
        for step in steps:
            if isinstance(step, CodeStep):
                # one analysis per frame, shared by the AQ frame offset
                # and (AQ 2) the per-SB qindex map
                f_ = frames[step.disp]
                stats = (AN.analyze(f_.y, f_.u, f_.v, self.cfg.bit_depth)
                         if aq else None)
                q = layer_qindex(self._frame_qindex(False), step.layer)
                q = max(1, min(255, q + self._aq_offset(f_, stats)))
                self._dispatch_code(step, f_, q,
                                    pending_pins.pop(step.disp, 0), alt=hi,
                                    stats=stats if aq >= 2 else None)
                self._unpin(step.fwd)
                if step.bwd is not None:
                    self._unpin(step.bwd)
            else:
                payload = O.write_show_existing(
                    self._store[step.disp]["slot"])
                self._emit([Packet(payload, step.disp, False,
                                   display_idx=step.disp)], layer=-1)
                self._unpin(step.disp)
        self._anchor = hi

    def _dispatch_code(self, step, frame: Frame, qindex: int,
                       pins: int, alt=None, stats=None) -> None:
        """Code one hier-B frame, no-show: the mini-GOP base through the
        one-reference P step (no global motion: it is IPPP-only), an
        interior frame through the multi-reference B step (LAST = the
        forward reference, ALTREF = the backward one).  alt: display
        index of the span's base; with multi-reference prediction an
        interior frame whose references are not it adds it as a third
        single-prediction reference (LAST, BWDREF, ALTREF).  stats
        (adaptive quantization 2): the frame's PictureStats, from which
        the per-superblock qindex map is made (coded as delta-q)."""
        cfg = self.cfg
        _, _, ph64, pw64 = self._geometry
        sy, su, sv = self._upload_src(frame)
        fwd = self._store[step.fwd]
        bwd = fwd if step.bwd is None else self._store[step.bwd]
        lvls = self._lf_levels(qindex, False)
        filt = self._pick_interp(frame, qindex)
        dyn = (qindex, lvls[0], lvls[2], lvls[3])
        # per-superblock delta-q (spec 5.9.17): residual quantization goes
        # per SB on the device, the entropy stage codes the deltas
        qmap = None
        aq_on = int(cfg.enable_adaptive_quantization) >= 2
        if aq_on:
            m = AN.aq_sb_qmap(stats if stats is not None
                              else AN.analyze(frame.y), qindex, res=DQ_RES,
                              bd=cfg.bit_depth)
            qmap = np.full((ph64 // 64, pw64 // 64), qindex, np.int32)
            qmap[: m.shape[0], : m.shape[1]] = m[: ph64 // 64, : pw64 // 64]
            dyn = dyn + (self._to_dev(qmap),)
        lr = cfg.enable_restoration
        compound = False
        third = None
        if step.bwd is None:
            nrefs = 1
            fn = PE.build_p_frame_encoder_dyn(
                ph64, pw64, self.seq.mi_rows, self.seq.mi_cols,
                cdef=cfg.enable_cdef, bd=cfg.bit_depth, rdo=self._rdo,
                txs=self._txs, filt=filt, lr=lr, rect=self._rect, aq=aq_on)
            out = fn(sy, su, sv, *fwd["dev"], *dyn)
        else:
            compound = cfg.compound_mode > 0
            if (self._mrp and alt is not None
                    and alt not in (step.fwd, step.bwd)
                    and alt in self._store):
                third = self._store[alt]
            nrefs = 3 if third is not None else 2
            if nrefs == 3:
                self._nrefs3_frames += 1
            fn = PE.build_b_frame_encoder_dyn(
                ph64, pw64, self.seq.mi_rows, self.seq.mi_cols,
                cdef=cfg.enable_cdef, compound=compound, bd=cfg.bit_depth,
                filt=filt, rdo=self._rdo, nrefs=nrefs, lr=lr, aq=aq_on,
                txs=self._txs, rect=self._rect)
            extra = third["dev"] if third is not None else ()
            out = fn(sy, su, sv, *fwd["dev"], *bwd["dev"], *extra, *dyn)
        slot = self._free_slots.pop(0)
        out, planes, lr_meta = self._inter_refs(frame, out)
        self._store[step.disp] = {"dev": planes, "slot": slot, "pins": pins}
        fs, bs = fwd["slot"], bwd["slot"]
        fh = self._hint(step.fwd)
        bh = fh if step.bwd is None else self._hint(step.bwd)
        if nrefs == 3:
            ts, th = third["slot"], self._hint(alt)
            ref_types = (1, 5, 7)                 # LAST, BWDREF, ALTREF
            ref_idx = (fs, fs, fs, fs, bs, ts, ts)
            ref_hints = (fh, fh, fh, fh, bh, th, th)
        else:
            ref_types = (1, 7)                    # LAST, ALTREF
            ref_idx = (fs, fs, fs, fs, bs, bs, bs)
            ref_hints = (fh, fh, fh, fh, bh, bh, bh)
        meta = {"nrefs": nrefs, "compound": compound, "show": False,
                "ref_types": ref_types,
                "order_hint": self._hint(step.disp),
                "refresh": 1 << slot,
                "ref_idx": ref_idx, "ref_hints": ref_hints, **lr_meta,
                **({"qmap": qmap, "dq_res": DQ_RES} if aq_on else {})}
        arrs = [a.cpu().numpy() for a in out]
        pkt = self._make_inter_packet(frame, arrs, qindex, None, meta)
        pkt.show = False
        pkt.display_idx = step.disp
        self._emit([pkt], layer=step.layer)

    def _is_key(self, idx: int) -> bool:
        p = self.cfg.intra_period
        if p == -2:
            return True
        if p == -1:
            return idx == 0
        return idx % (p + 1) == 0

    @property
    def _geometry(self):
        ph, pw = self.seq.mi_rows * 4, self.seq.mi_cols * 4
        return ph, pw, -(-ph // 64) * 64, -(-pw // 64) * 64

    @property
    def _px(self):
        """The host pixel dtype (numpy uint8 / uint16)."""
        return np.uint8 if self.cfg.bit_depth == 8 else np.uint16

    def _to_dev(self, a: np.ndarray):
        """A host array on the device; uint16 pixels become int16."""
        if a.dtype == np.uint16:
            a = a.astype(np.int16)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload_stack(self, frames, h: int, w: int):
        """The frames' planes in the stream's pixel dtype, edge-padded to
        h x w luma, stacked [S, ...] on the device."""
        def stack(get, hh, ww):
            return self._to_dev(np.stack([
                IE.pad_plane(get(f).astype(self._px), hh, ww)
                for f in frames]))
        return (stack(lambda f: f.y, h, w),
                stack(lambda f: f.u, h // 2, w // 2),
                stack(lambda f: f.v, h // 2, w // 2))

    def _upload_src(self, frame: Frame):
        """The frame's planes edge-padded to the 64-padded geometry."""
        _, _, ph64, pw64 = self._geometry
        return tuple(p[0] for p in self._upload_stack([frame], ph64, pw64))

    def _as_ref_planes(self, y, u, v):
        """Edge-pad recon planes to the 64-padded inter geometry (the
        mirror decoder pads its references identically)."""
        ph, pw, ph64, pw64 = self._geometry
        return (MC.edge_pad(y, 0, ph64 - ph, 0, pw64 - pw),
                MC.edge_pad(u, 0, (ph64 - ph) // 2, 0, (pw64 - pw) // 2),
                MC.edge_pad(v, 0, (ph64 - ph) // 2, 0, (pw64 - pw) // 2))

    def _recon_as_ref(self, out):
        """A P / B step's recon planes (outputs 5-7) as a reference."""
        ph, pw, _, _ = self._geometry
        return self._as_ref_planes(out[5][..., :ph, :pw],
                                   out[6][..., : ph // 2, : pw // 2],
                                   out[7][..., : ph // 2, : pw // 2])

    def _inter_refs(self, frame: Frame, out):
        """A P / B step's outputs -> (outputs without the deblocked
        planes, reference planes, packet meta).  With restoration the
        step's last three outputs are the deblocked planes; the restored
        recon is the reference and the packet's recon."""
        if not self.cfg.enable_restoration:
            return out, self._recon_as_ref(out), {}
        lr, host, planes = self._lr_from_dev(frame, out[5:8], out[-3:])
        return out[:-3], planes, {"lr": lr, "lr_planes": host}

    def _pick_interp(self, frame: Frame, qindex: int) -> int:
        """Resolve the stream's interpolation filter (spec
        interpolation_filter; decided once, on the first inter frame)."""
        if self._interp_filt is None:
            self._interp_filt = AN.pick_interp_filter(
                AN.analyze(frame.y), qindex, self.cfg.bit_depth)
        return self._interp_filt

    # -- low-delay B (ref EB_PRED_LOW_DELAY_B) -------------------------------
    def _ldb_send(self, frame: Frame, q_off: int = 0) -> None:
        """Code one low-delay-B frame, shown at once: a keyframe (period
        or scene cut) restarts both references in slot 0; any other
        frame runs the two-reference step without compound prediction
        against LAST (the previous frame) and GOLDEN (the keyframe), and
        takes slot 1, or 2 when LAST sits in slot 1."""
        d = self._send_idx
        self._send_idx += 1
        key = self._is_key(d) or self._scene_cut(frame)
        qindex = self._frame_qindex(key)
        qindex = max(1, min(255, qindex + self._aq_offset(frame)))
        if not key:
            qindex = max(1, min(255, qindex + q_off))
        if key or self._ldb_last is None:
            dev, planes, deb = self._intra_dispatch(frame, qindex)
            lr = host = None
            if deb is not None:
                lr, host, planes = self._lr_from_dev(frame, planes, deb)
            self._ldb_golden = (planes, 0)      # (device planes, slot)
            self._ldb_last = (planes, 0)
            pkt = self._make_packet(frame, dev, qindex, 0, lr, host)
            pkt.pts = pkt.display_idx = d
            self._emit([pkt])
            return
        cfg = self.cfg
        _, _, ph64, pw64 = self._geometry
        sy, su, sv = self._upload_src(frame)
        lvls = self._lf_levels(qindex, False)
        fn = PE.build_b_frame_encoder_dyn(
            ph64, pw64, self.seq.mi_rows, self.seq.mi_cols,
            cdef=cfg.enable_cdef, compound=False, bd=cfg.bit_depth,
            filt=self._pick_interp(frame, qindex), rdo=self._rdo,
            lr=cfg.enable_restoration, txs=self._txs, rect=self._rect)
        out = fn(sy, su, sv, *self._ldb_last[0], *self._ldb_golden[0],
                 qindex, lvls[0], lvls[2], lvls[3])
        ls, gs = self._ldb_last[1], self._ldb_golden[1]
        new_slot = 1 if ls != 1 else 2
        out, planes, lr_meta = self._inter_refs(frame, out)
        self._ldb_last = (planes, new_slot)
        meta = {"nrefs": 2, "compound": False, "show": True,
                "ref_types": (1, 4),              # LAST, GOLDEN
                "order_hint": 0,
                "refresh": 1 << new_slot,
                "ref_idx": (ls, ls, ls, gs, ls, ls, ls),
                "ref_hints": (0,) * 7, **lr_meta}
        arrs = [a.cpu().numpy() for a in out]
        pkt = self._make_inter_packet(frame, arrs, qindex, None, meta)
        pkt.pts = pkt.display_idx = d
        self._emit([pkt])

    def _dispatch_inbox(self) -> None:
        """All-intra: code the inbox's frames as one batch — one q (the
        next push_qp override, the rate controller's pick or the
        configured qp; no AQ offset, as the reference's batched path),
        the 8x8 wavefront at every preset (with the rich mode set at
        presets <= 5) and the in-loop filters with a leading frame axis
        — then entropy-code the frames on a thread pool (the C++ coder
        releases the GIL).  Rate control absorbs the batch's packets
        together."""
        if not self._inbox:
            return
        frames, self._inbox = self._inbox, []
        qindex = self._frame_qindex(True)
        base = self._frame_idx
        self._frame_idx += len(frames)
        cfg = self.cfg
        filters = (cfg.enable_deblocking or cfg.enable_cdef
                   or cfg.enable_restoration)
        postproc = filters and (self._need_recon() or cfg.enable_cdef
                                or cfg.enable_restoration)
        devs, _ = self._intra_batch(frames, qindex, part16=False,
                                    postproc=postproc, rich=self._txs)

        def code(i):
            dev, deb = devs[i]
            lr = host = None
            if deb is not None:
                lr, host = self._lr_host(frames[i], deb[3:], deb[:3])
            pkt = self._make_packet(frames[i], dev, qindex, 0, lr, host)
            pkt.pts = base + i
            return pkt

        if len(frames) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(frames))) as ex:
                self._emit(list(ex.map(code, range(len(frames)))))
        else:
            self._emit([code(0)])

    def _dispatch_one(self, frame: Frame, q_off: int = 0) -> None:
        """IPPP: keyframes (period or scene cut) via the wavefront intra
        path, P frames via the bulk-parallel inter path; recon planes
        stay on the device between frames."""
        idx = self._send_idx
        key = self._is_key(idx) or self._scene_cut(frame)
        qindex = self._frame_qindex(key)
        qindex = max(1, min(255, qindex + self._aq_offset(frame)))
        if not key:
            qindex = max(1, min(255, qindex + q_off))
        self._send_idx += 1
        _, _, ph64, pw64 = self._geometry
        if key or self._ref_dev is None:
            dev, self._ref_dev, deb = self._intra_dispatch(frame, qindex)
            lr = host = None
            if deb is not None:
                lr, host, self._ref_dev = self._lr_from_dev(
                    frame, self._ref_dev, deb)
            if self._gm_enab:
                self._gm_prev_src = frame.y
            pkt = self._make_packet(frame, dev, qindex, 0, lr, host)
        else:
            sy, su, sv = self._upload_src(frame)
            gmv = None
            if self._gm_enab and self._gm_prev_src is not None:
                gmv = AN.estimate_global_translation(
                    self._gm_prev_src, frame.y,
                    max_fullpel=PE.SEARCH_RANGE - 1)
                self._gm_prev_src = frame.y
            lvls = self._lf_levels(qindex, False)
            fn = PE.build_p_frame_encoder_dyn(
                ph64, pw64, self.seq.mi_rows, self.seq.mi_cols,
                cdef=self.cfg.enable_cdef, bd=self.cfg.bit_depth,
                rdo=self._rdo, txs=self._txs,
                filt=self._pick_interp(frame, qindex), gm=self._gm_enab,
                lr=self.cfg.enable_restoration, rect=self._rect)
            out = fn(sy, su, sv, *self._ref_dev, qindex, lvls[0], lvls[2],
                     lvls[3], gmv or (0, 0))
            out, self._ref_dev, lr_meta = self._inter_refs(frame, out)
            meta = None
            if lr_meta:
                meta = {"show": True, "order_hint": 0, "refresh": 0x01,
                        "ref_idx": (0,) * 7, "ref_hints": (0,) * 7,
                        **lr_meta}
            arrs = [a.cpu().numpy() for a in out]
            pkt = self._make_inter_packet(frame, arrs, qindex, gmv, meta)
        pkt.pts = idx
        if self.cfg.enable_restoration:
            # the reference's restored IPPP frames carry their display
            # index (its restoration meta sets it)
            pkt.display_idx = idx
        self._emit([pkt])

    def _intra_dispatch(self, frame: Frame, qindex: int):
        """Keyframe of an inter stream: wavefront encode + in-loop filters
        on the device (the RD presets' wavefront picks 16x16 or 8x8
        leaves per 16x16 unit; all-intra streams keep the 8x8 wavefront
        at every preset, the reference's batched all-intra path).
        Returns (host dict for the packet writer, reference planes, the
        deblocked pre-CDEF planes when restoration is on, else None)."""
        cfg = self.cfg
        res, planes = self._intra_batch(
            [frame], qindex, part16=self._rdo,
            postproc=(cfg.enable_deblocking or cfg.enable_cdef
                      or cfg.enable_restoration), rich=self._txs)
        dev, deb = res[0]
        return (dev, self._as_ref_planes(*(p[0] for p in planes)),
                None if deb is None else deb[:3])

    def _intra_batch(self, frames, qindex: int, part16: bool,
                     postproc: bool, rich: bool = False):
        """Intra-code S frames in one wavefront with a leading frame axis
        (part16: the RD presets' 16x16 wavefront, one frame; rich: the
        mode set of presets <= 5) and their in-loop filters (postproc).
        Returns (per frame (host dict for the packet writer, with
        restoration the deblocked pre-CDEF planes then the frame's recon
        planes, else None), the frames' recon planes stacked [S, ...] on
        the device)."""
        ph, pw, _, _ = self._geometry
        src = self._upload_stack(frames, ph, pw)
        blocks = (IE.block_planes(src[0], 8), IE.block_planes(src[1], 4),
                  IE.block_planes(src[2], 4))
        if part16:
            out = tuple(o[None] for o in IE.frame_step16(
                *(b[0] for b in blocks), qindex, self.cfg.bit_depth, rich))
        else:
            out = IE.frame_step(*blocks, qindex, self.cfg.bit_depth, rich)
        planes = tuple(IE.unblock_planes(out[i]) for i in (4, 5, 6))
        cdef_idx = deb = None
        if postproc:
            # per-cell coded-skip map (CDEF skips skip blocks, spec 7.15);
            # a 16x16 leaf's four cells share its skip
            zero = lambda a: (a == 0).all(-1).all(-1)
            sk = zero(out[1]) & zero(out[2]) & zero(out[3])
            sizes8 = None
            if part16:
                sizes8 = out[10][0]
                nbh, nbw = sizes8.shape
                sk16 = PE._up(zero(out[11][0]) & zero(out[12][0])
                              & zero(out[13][0]), 2)[:nbh, :nbw]
                sk = torch.where(sizes8 == 16, sk16, sk[0])[None]
            planes, cdef_idx, deb = self._intra_postproc(planes, src, sk,
                                                         qindex, sizes8)
        names = ["modes", "levels_y", "levels_u", "levels_v"]
        if part16 or rich:
            names += ["angles", "uv_modes", "cfl"]
        if part16:
            names += ["sizes", "levels16_y", "levels16_u", "levels16_v"]
        host = [out[i].cpu().numpy() for i in range(4)] + \
            [a.cpu().numpy() for a in out[7:]]
        cdef_h = None if cdef_idx is None else cdef_idx.cpu().numpy()
        rec_h = ([p.cpu().numpy() for p in planes] if self._need_recon()
                 else None)
        res = []
        for i in range(len(frames)):
            dev = {k: a[i] for k, a in zip(names, host)}
            dev["cdef_idx"] = None if cdef_h is None else cdef_h[i]
            if rec_h is not None:
                dev["recon_y"], dev["recon_u"], dev["recon_v"] = (
                    p[i] for p in rec_h)
            res.append((dev, None if deb is None else
                        tuple(p[i] for p in deb + planes)))
        return res, planes

    def _intra_postproc(self, planes, srcs, sk, qindex: int, sizes8=None):
        """Keyframe in-loop filters: deblock on the tx grid (8x8 / 4x4
        chroma, or the per-cell 8/16 leaf sizes of the RD presets), then
        the CDEF search + apply.  Returns (planes, CDEF index map, the
        deblocked planes when restoration is on, else None)."""
        bd = self.cfg.bit_depth
        ph, pw, _, _ = self._geometry
        lead = planes[0].shape[:-2]
        ly, _, lu, lv = self._lf_levels(qindex, True)
        i32 = lambda a: a.to(torch.int32)
        if sizes8 is None:
            sz_y = torch.full((ph, pw), 8, dtype=torch.int32,
                              device=self.device)
            sz_c = torch.full((ph // 2, pw // 2), 4, dtype=torch.int32,
                              device=self.device)
        else:
            sz_y = PE._up(i32(sizes8), 8)
            sz_c = PE._up(i32(sizes8) // 2, 4)
        y = DB.deblock_plane(i32(planes[0]), sz_y, ly, ly, True, bd=bd)
        u = DB.deblock_plane(i32(planes[1]), sz_c, lu, lu, False, bd=bd)
        v = DB.deblock_plane(i32(planes[2]), sz_c, lv, lv, False, bd=bd)
        px = lambda a: a.to(MC.pixel_dtype(bd))
        deb = ((px(y), px(u), px(v)) if self.cfg.enable_restoration
               else None)
        idx_sb = torch.zeros((*lead, -(-ph // 64), -(-pw // 64)),
                             dtype=torch.uint8, device=self.device)
        if self.cfg.enable_cdef:
            (y, u, v), idx_sb = CDEF.cdef_search_and_apply(
                (y, u, v), tuple(i32(s) for s in srcs), sk,
                CDEF.pick_damping(qindex), coeff_shift=bd - 8)
            idx_sb = idx_sb.to(torch.uint8)
        return (px(y), px(u), px(v)), idx_sb, deb

    def _lr_from_dev(self, frame: Frame, rec, deb):
        """Loop restoration of one frame on the host: fetch the recon and
        the deblocked planes (device, cropped to the mode-info extent),
        run the per-plane search and apply (_lr_process).  Returns (the
        per-plane lr list or None, the restored host planes (int32), the
        restored planes as device reference planes).  Restoration's
        output is the reference buffer's content, so the next frame
        cannot start before it lands."""
        lr, pl = self._lr_host(frame, rec, deb)
        refs = self._as_ref_planes(*(self._to_dev(p.astype(self._px))
                                     for p in pl))
        return lr, pl, refs

    def _lr_host(self, frame: Frame, rec, deb):
        """The host half of _lr_from_dev: (lr list or None, restored host
        planes (int32))."""
        ph, pw, _, _ = self._geometry
        host = lambda a, sh: np.asarray(
            a[: ph >> sh, : pw >> sh].cpu().numpy(), np.int32)
        pl = [host(rec[0], 0), host(rec[1], 1), host(rec[2], 1)]
        dpl = [host(deb[0], 0), host(deb[1], 1), host(deb[2], 1)]
        return self._lr_process(frame, pl, dpl), pl

    def _lr_process(self, frame: Frame, planes, deb):
        """Per-plane loop restoration: Wiener AND self-guided searches
        against the source; each plane signals whichever type wins more
        total SSE, applied in place into ``planes``.  ``deb`` holds the
        deblocked (pre-CDEF) planes the stripe context rows come from
        (spec save_deblock_boundary_lines).  Returns the per-plane lr
        list [{type, unit, use, ...} | None] * 3, or None when no plane
        restores (ref search_wiener + search_sgrproj,
        EbRestorationPick.c:705)."""
        bd = self.cfg.bit_depth
        out = []
        for p in range(3):
            ss = 0 if p == 0 else 1
            h = self.seq.height if p == 0 else (self.seq.height + 1) // 2
            w = self.seq.width if p == 0 else (self.seq.width + 1) // 2
            unit = 64 >> ss          # luma 64, chroma 32 (lr_uv_shift=1)
            src = (frame.y, frame.u, frame.v)[p][:h, :w].astype(np.int32)
            crop = np.ascontiguousarray(planes[p][:h, :w].astype(np.int32))
            dsub = np.ascontiguousarray(deb[p][:h, :w].astype(np.int32))
            use_w, taps = LRR.search_wiener_plane(src, crop, dsub, unit, ss,
                                                  bd=bd)
            # the preset-gated self-guided set (ref sg_filter_mode: the
            # fast presets search a reduced ep set)
            eps = ((4, 11) if self.cfg.enc_mode >= 6
                   else (0, 4, 7, 9, 11, 13, 14, 15))
            use_s, ep, xqd, sse_s = LRR.search_sgr_plane(
                src, crop, dsub, unit, ss, eps=eps, bd=bd)
            # plane-level type pick by realized SSE (off-RU keeps self)
            got_w = crop
            if use_w.any():
                got_w = LRR.apply_wiener_plane(crop, dsub, unit, ss, use_w,
                                               taps, bd)
            sse_w = ((got_w.astype(np.int64) - src) ** 2).sum()
            if use_s.any() and sse_s.sum() < sse_w:
                planes[p][:h, :w] = LRR.apply_sgr_plane(
                    crop, dsub, unit, ss, use_s, ep, xqd, bd)
                out.append({"unit": unit, "type": 3, "use": use_s,
                            "ep": ep, "xqd": xqd})
            elif use_w.any():
                planes[p][:h, :w] = got_w
                out.append({"unit": unit, "type": 2, "use": use_w,
                            "taps": taps})
            else:
                out.append(None)
        return out if any(p is not None for p in out) else None

    def _make_inter_packet(self, frame: Frame, arrs, qindex: int, gmv,
                           meta=None) -> Packet:
        """Entropy-code one P / B step's host outputs, one tile at a time
        on the configured tile grid.  meta (hier-B, low-delay B, restored
        IPPP frames): the step's reference count and compound flag,
        whether it is shown, its ref types, slots and order hints, its
        own order hint and refresh slot, and with restoration the
        per-plane lr list and the restored planes ("lr", "lr_planes"),
        with adaptive quantization 2 the per-SB qindex map ("qmap",
        "dq_res").  Restored frames take the Python tile writer (the
        C++ coder has no restoration syntax), as in the reference."""
        cfg = self.cfg
        meta_ = meta or {}
        nr = meta_.get("nrefs", 1)
        compound = bool(meta_.get("compound"))
        lr = meta_.get("lr")
        qmap = meta_.get("qmap")
        dq_res = meta_.get("dq_res", 0)
        lay = PE.inter_layout(nr, compound, self._txs, lv8=False, lr=False,
                              rect=self._rect)
        sizes = arrs[lay["sizes"]]
        mv = arrs[lay["mv"]].astype(np.int32)
        packs = (arrs[lay["ly"]], arrs[lay["lu"]], arrs[lay["lv"]])
        cdef_idx = arrs[lay["cdef"]] if cfg.enable_cdef else None
        txty = arrs[lay["txty"]] if self._txs else None
        shapes = arrs[lay["shape8"]] if self._rect else None
        gm = {1: gmv} if gmv is not None else None
        # per-cell ref types from the step's ref8 field (0 -> ref0,
        # 1 -> ref1, nrefs -> compound: 0 in refs8, the frame-level pair)
        refs8 = mvs2 = comp_pair = None
        ref_select = False
        n_comp = None
        if nr >= 2:
            types = meta["ref_types"]
            mode8 = arrs[lay["ref8"]]
            refs8 = np.zeros_like(mode8, np.uint8)
            for k in range(nr):
                refs8[mode8 == k] = types[k]
            n_comp = int((mode8 == nr).sum())
            # reference_select only when compound blocks exist
            ref_select = compound and n_comp > 0
            if ref_select:
                mvs2 = arrs[lay["mv2"]].astype(np.int32)
                comp_pair = (types[0], types[1])
        sign_bias = (O.ref_sign_biases(self.seq, meta["order_hint"],
                                       meta["ref_hints"])
                     if meta else None)
        # tiles with rect leaves take the Python writer, as restored frames
        # do (the C++ coder has neither syntax)
        native = None
        if lr is None and cfg.entropy_backend in ("auto", "cpp"):
            from svt_av1_tpu_torch.entropy import backend
            if backend.available():
                native = backend
            elif cfg.entropy_backend == "cpp":
                raise RuntimeError("C++ entropy backend unavailable")

        def code_tile(r01, c01) -> bytes:
            (r0, r1), (c0, c1) = r01, c01
            hm, wm = r1 - r0, c1 - c0
            cells = lambda a: _tile_slice(a, r0, c0, hm, wm, 2, align=8)
            t_sizes, t_mv, t_refs, t_mv2, t_tt, t_sh = (
                cells(a) for a in (sizes, mv, refs8, mvs2, txty, shapes))
            if t_sh is not None and not t_sh.any():
                t_sh = None             # square-only tile: the C++ coder
            t_pk = tuple(cells(a) for a in packs)
            t_ci = _tile_slice(cdef_idx, r0, c0, hm, wm, 16)
            t_qm = _tile_slice(qmap, r0, c0, hm, wm, 16)
            fc = FrameContext(qindex)
            if native is not None and t_sh is None:
                return native.encode_tile_inter_cpp(
                    fc, hm, wm, qindex, t_sizes, t_mv, packs=t_pk,
                    cdef_idx=t_ci, refs=t_refs, sign_bias=sign_bias,
                    mvs2=t_mv2, comp_pair=comp_pair or (1, 7), txty=t_tt,
                    gm=gm, qmap=t_qm, delta_q_res=dq_res)
            lv = {bs: tuple(_unpack_levels(t_pk[p], bs) for p in range(3))
                  for bs in (8, 16, 32, 64)}
            if t_sh is not None:
                # rect leaves' grids, keyed (height, width) in pixels
                for key in ((8, 16), (16, 8), (16, 32), (32, 16)):
                    lv[key] = tuple(_unpack_levels_rect(
                        t_pk[p], key[0] // 8, key[1] // 8) for p in range(3))
            tw = TileWriter(fc, hm, wm, qindex, lr=lr, lr_off=(r0, c0),
                            frame_mi=(self.seq.mi_rows, self.seq.mi_cols))
            return tw.encode_inter(t_sizes, t_mv, lv, cdef_idx=t_ci,
                                   refs=t_refs, sign_bias=sign_bias,
                                   comp_pair=comp_pair, mvs2=t_mv2,
                                   txty=t_tt, gm=gm, shapes=t_sh,
                                   qmap=t_qm, delta_q_res=dq_res)

        trows, tcols = O.tile_starts(self.seq, cfg.tile_columns_log2,
                                     cfg.tile_rows_log2)
        tiles = [code_tile(r01, c01) for r01 in trows for c01 in tcols]
        tile = tiles[0] if len(tiles) == 1 else O.assemble_tile_group(tiles)
        if meta:
            hdr = {"show_frame": meta["show"],
                   "order_hint": meta["order_hint"],
                   "refresh_frame_flags": meta["refresh"],
                   "ref_frame_idx": meta["ref_idx"],
                   "ref_order_hints": meta["ref_hints"],
                   "reference_select": ref_select}
        else:
            hdr = {"refresh_frame_flags": 0x01}
        if gm:
            gm_types = [0] * 7
            gm_trans = [(0, 0)] * 7
            for rt, mv8g in gm.items():
                gm_types[rt - 1] = 1
                gm_trans[rt - 1] = tuple(int(x) for x in mv8g)
            hdr["gm_types"] = tuple(gm_types)
            hdr["gm_trans"] = tuple(gm_trans)
        fp = O.FrameParams(base_q_idx=qindex,
                           delta_q_res=(dq_res if qmap is not None else 0),
                           tile_cols_log2=cfg.tile_columns_log2,
                           tile_rows_log2=cfg.tile_rows_log2,
                           frame_type=O.INTER_FRAME,
                           interp_filter=(self._interp_filt or 0),
                           filter_levels=self._lf_levels(qindex, False),
                           film_grain=None, lr_types=_lr_types(lr),
                           lr_uv_shift=1, switchable_motion_mode=False,
                           allow_warped_motion=False,
                           **hdr, **self._cdef_params(qindex))
        payload = (O.temporal_delimiter()
                   + O.write_frame_obu(self.seq, fp, tile))
        recon = None
        if meta_.get("lr_planes") is not None:
            recon = self._crop_recon(*meta_["lr_planes"])
        elif self._need_recon():
            recon = self._crop_recon(arrs[lay["rec_y"]], arrs[lay["rec_u"]],
                                     arrs[lay["rec_v"]])
        # (the reference measures inter-frame PSNR on the 8-bit peak at
        # every bit depth; kept for equal stat files)
        psnr = _psnr(frame, recon) if (cfg.stat_report and recon) else None
        return Packet(payload, -1, False, recon, psnr, qindex=qindex,
                      compound_cells=n_comp,
                      rect_cells=(None if shapes is None
                                  else int((shapes > 0).sum())),
                      idtx_cells=(None if txty is None
                                  else int((txty == 9).sum())))

    def _make_packet(self, frame: Frame, dev: dict, qindex: int,
                     order_hint: int = 0, lr=None, lr_planes=None) -> Packet:
        """Entropy-code a keyframe (one tile).  lr / lr_planes: the
        restoration's per-plane list and the restored planes, which are
        the packet's recon (the Python tile writer codes the restoration
        syntax)."""
        cfg = self.cfg
        if lr_planes is not None:
            dev = dict(dev, recon_y=lr_planes[0], recon_u=lr_planes[1],
                       recon_v=lr_planes[2])
        fc = FrameContext(qindex)
        cdef_idx = dev.get("cdef_idx") if cfg.enable_cdef else None
        # the rich mode set's angle / chroma mode / CFL maps, and the RD
        # presets' 16x16 wavefront's per-cell leaf sizes and the 16x16
        # leaves' levels
        rd_maps = {k: dev[k] for k in ("angles", "uv_modes", "cfl", "sizes")
                   if dev.get(k) is not None}
        if dev.get("sizes") is not None:
            rd_maps["levels16"] = (dev["levels16_y"], dev["levels16_u"],
                                   dev["levels16_v"])
        tile = None
        if lr is None and cfg.entropy_backend in ("auto", "cpp"):
            from svt_av1_tpu_torch.entropy import backend as native
            if native.available():
                tile = native.encode_tile_cpp(
                    fc, self.seq.mi_rows, self.seq.mi_cols, qindex,
                    dev["modes"].astype(np.uint8), dev["levels_y"],
                    dev["levels_u"], dev["levels_v"], cdef_idx=cdef_idx,
                    **rd_maps)
            elif cfg.entropy_backend == "cpp":
                raise RuntimeError("C++ entropy backend unavailable")
        if tile is None:
            tw = TileWriter(fc, self.seq.mi_rows, self.seq.mi_cols, qindex,
                            lr=lr)
            tile = tw.encode(dev["modes"], dev["levels_y"], dev["levels_u"],
                             dev["levels_v"], cdef_idx=cdef_idx, **rd_maps)
        fp = O.FrameParams(base_q_idx=qindex,
                           tile_cols_log2=0, tile_rows_log2=0,
                           filter_levels=self._lf_levels(qindex, True),
                           order_hint=order_hint, film_grain=None,
                           lr_types=_lr_types(lr), lr_uv_shift=1,
                           allow_screen_content=False, allow_intrabc=False,
                           **self._cdef_params(qindex))
        payload = (O.temporal_delimiter()
                   + O.write_sequence_header(self.seq)
                   + O.write_frame_obu(self.seq, fp, tile))
        recon = None
        if dev.get("recon_y") is not None:
            recon = self._crop_recon(dev["recon_y"], dev["recon_u"],
                                     dev["recon_v"])
        psnr = (_psnr(frame, recon, cfg.bit_depth)
                if (cfg.stat_report and recon) else None)
        leaf16 = (None if dev.get("sizes") is None
                  else int((dev["sizes"] == 16).sum()))
        return Packet(payload, -1, True, recon, psnr, qindex=qindex,
                      leaf16_cells=leaf16)

    def _crop_recon(self, y, u, v) -> Frame:
        """Host recon planes (any integer dtype) cropped to the frame, in
        the stream's pixel dtype."""
        h, w = self.seq.height, self.seq.width
        ch, cw = (h + 1) // 2, (w + 1) // 2
        px = self._px
        return Frame(y[:h, :w].astype(px), u[:ch, :cw].astype(px),
                     v[:ch, :cw].astype(px))

    def _need_recon(self) -> bool:
        return (self.cfg.recon_output or self.cfg.stat_report
                or self.cfg.enable_restoration)

    def _cdef_params(self, qindex: int) -> dict:
        if not self.cfg.enable_cdef:
            return {}
        return {"cdef_damping": CDEF.pick_damping(qindex),
                "cdef_bits": CDEF.CDEF_BITS,
                "cdef_y_strengths": CDEF.Y_STRENGTHS,
                "cdef_uv_strengths": CDEF.UV_STRENGTHS}

    def _lf_levels(self, qindex: int, is_key: bool) -> tuple:
        if not self.cfg.enable_deblocking:
            return (0, 0, 0, 0)
        ly, lu, lv = DB.pick_filter_levels(qindex, is_key)
        return (ly, ly, lu, lv)

    def _refill(self) -> None:
        """Flush a partial all-intra batch when no packet is ready; with
        rate control, absorb the next packet's feedback (and its group's)
        when get_packet reaches it."""
        if not self._packets and self._inbox:
            self._dispatch_inbox()
        if (self._rc_fb and self._packets
                and self._rc_fb[0][0][0] is self._packets[0]):
            self._absorb(self._rc_fb.pop(0))

    # -- ref eb_svt_get_packet ----------------------------------------------------
    def get_packet(self) -> Optional[Packet]:
        self._refill()
        return self._packets.pop(0) if self._packets else None

    # -- ref eb_svt_get_recon ------------------------------------------------------
    def get_recon(self) -> Optional[Frame]:
        self._refill()
        return self._packets[0].recon if self._packets else None

    def encode_all(self, frames) -> Iterator[Packet]:
        """Convenience: push frames, yield packets in decode order."""
        for f in frames:
            self.send_picture(f)
            while True:
                pkt = self.get_packet()
                if pkt is None:
                    break
                yield pkt
        self.flush()
        while True:
            pkt = self.get_packet()
            if pkt is None:
                break
            yield pkt


def _tile_slice(a, r0: int, c0: int, hm: int, wm: int, mi_cell: int,
                align: int = 1):
    """One tile's part of a cell grid whose cells span mi_cell mode-info
    units: the tile's cell rows and columns from (r0, c0), their counts
    rounded up to align (into the frame's padded grids) so the entropy
    coder's nb8 * 8 / bs strides stay exact for every tile width."""
    if a is None:
        return None
    rr, cc = r0 // mi_cell, c0 // mi_cell
    nr = -(-(-(-hm // mi_cell)) // align) * align
    nc = -(-(-(-wm // mi_cell)) // align) * align
    return np.ascontiguousarray(a[rr: rr + nr, cc: cc + nc])


def _unpack_levels_rect(packed: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """Rect-leaf twin of _unpack_levels: [nb8h, nb8w, t, t] cell tiles
    -> [GH, GW, kh*t, kw*t] rect-leaf grids (kh / kw: the leaf's extent
    in 8px cells; t = 8 luma / 4 chroma)."""
    nb8h, nb8w, t, _ = packed.shape
    gh, gw = nb8h // kh, nb8w // kw
    return (packed.astype(np.int32)
            .reshape(gh, kh, gw, kw, t, t).transpose(0, 2, 1, 4, 3, 5)
            .reshape(gh, gw, kh * t, kw * t))


def _unpack_levels(packed: np.ndarray, bs: int) -> np.ndarray:
    """Per-cell tile packing [nb8h, nb8w, t, t] -> [gh, gw, bs*t/8,
    bs*t/8] leaf grids for leaf size bs (cells whose selected size
    differs hold other leaves' tiles — the tile writer only reads
    matching cells)."""
    nb8h, nb8w, t, _ = packed.shape
    k = bs // 8
    gh, gw = nb8h // k, nb8w // k
    return (packed.astype(np.int32)
            .reshape(gh, k, gw, k, t, t).transpose(0, 2, 1, 4, 3, 5)
            .reshape(gh, gw, k * t, k * t))


def _lr_types(lr) -> tuple:
    """FrameParams.lr_types from a per-plane lr list (None: NONE)."""
    if lr is None:
        return (0, 0, 0)
    return tuple(0 if pl is None else pl["type"] for pl in lr)


def _qp_to_qindex(qp: int) -> int:
    """Map 0..63 QP to 0..255 qindex (ref qp_scale semantics: ~4x)."""
    return min(255, max(1, qp * 4))


def _psnr(src: Frame, rec: Frame, bd: int = 8) -> tuple:
    peak = float((1 << bd) - 1)

    def p(a, b):
        mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
        return 99.0 if mse == 0 else 10 * np.log10(peak**2 / mse)

    return (p(src.y, rec.y), p(src.u, rec.u), p(src.v, rec.v))


# --- functional aliases with the reference API's names ----------------------

def eb_init_handle(config: EncoderConfig, device="cuda") -> Encoder:
    return Encoder(config, device=device)


def eb_svt_enc_set_parameter(handle: Encoder, **kw) -> None:
    handle.cfg = handle.cfg.replace(**kw)


def eb_svt_enc_send_picture(handle: Encoder, frame: Frame) -> None:
    handle.send_picture(frame)


def eb_svt_get_packet(handle: Encoder) -> Optional[Packet]:
    return handle.get_packet()


def eb_svt_get_recon(handle: Encoder) -> Optional[Frame]:
    return handle.get_recon()
