"""Multi-stream batched encoding: S independent streams per device step.

Port of svt_av1_tpu/pipeline/multistream.py.  The reference scales
throughput with multi-channel instances (channel_id /
active_channel_count, EbSvtAv1Enc.h:292) — S encoder instances on one
machine.  Here the S streams' frame steps run as ONE step with a leading
stream axis (the reference package's ``jax.vmap``): the intra wavefront
of every keyframe slot and the P step of every inter slot launch their
kernels once for all S streams, the CUDA tile gather once per call site
for all S planes.  Each stream's reference chain stays its own; only the
fixed cost of a step is shared — the single-card form of the
live-transcode config (four 1080p streams, bench.py's Config 5).

Streams must be in lockstep (same geometry, q and frame kind at each
step), which holds for fixed-keyframe-interval transcode ladders.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.pipeline import inter_encoder as PE
from svt_av1_tpu_torch.pipeline.encoder import Encoder, Packet


class MultiStreamEncoder:
    """S lockstep IPPP streams, one batched device step per frame slot.

    send(frames): one source frame per stream -> list of S Packets (in
    stream order).  Keyframes batch through the intra wavefront with a
    frame axis and its batched in-loop filters; P frames through the P
    step with a stream axis and per-stream references.  device: where
    the streams run (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, config: EncoderConfig, n_streams: int,
                 device="cuda") -> None:
        if config.pred_structure != 0 or config.intra_only:
            raise ValueError("multi-stream batching targets flat low-delay "
                             "P (pred_structure=0, not all-intra)")
        if config.enable_restoration:
            raise ValueError("multi-stream batching runs without loop "
                             "restoration")
        # lockstep constraint: per-frame open-loop host decisions that
        # would diverge across slots are pinned — no per-frame global
        # motion, and the interpolation filter is the configured one
        # (auto resolves to REGULAR) instead of the first-frame content
        # decision.  Encoder (sequential) makes the same choices when
        # given this normalized config.
        config = config.replace(
            enable_global_motion=False,
            interp_filter=max(0, config.interp_filter))
        self.n = n_streams
        self.cfg = config
        # one logical Encoder per stream for entropy/packetization state
        self.encs: List[Encoder] = [
            Encoder(config.replace(scene_change_detection=False),
                    device=device) for _ in range(n_streams)]
        self.device = self.encs[0].device
        self._refs = None      # stacked device ref planes [S, ...]
        self._idx = 0

    def send(self, frames: List) -> List[Packet]:
        if len(frames) != self.n:
            raise ValueError(f"{len(frames)} frames for {self.n} streams")
        e0 = self.encs[0]
        cfg = self.cfg
        _, _, ph64, pw64 = e0._geometry
        key = e0._is_key(self._idx)
        qindex = e0._frame_qindex(key)
        idx = self._idx
        self._idx += 1

        if key or self._refs is None:
            res, planes = e0._intra_batch(
                frames, qindex, part16=False,
                postproc=cfg.enable_deblocking or cfg.enable_cdef)
            devs = [dev for dev, _ in res]
            if not e0._need_recon():
                # the keyframe packets carry their recon, as the
                # reference's batched keyframe does
                rec = [p.cpu().numpy() for p in planes]
                for s, dev in enumerate(devs):
                    (dev["recon_y"], dev["recon_u"],
                     dev["recon_v"]) = (p[s] for p in rec)
            self._refs = e0._as_ref_planes(*planes)
            pkts = self._code(lambda s: self.encs[s]._make_packet(
                frames[s], devs[s], qindex))
            self._finish(pkts, idx, True)
            return pkts

        step = PE.build_p_frame_encoder_dyn(
            ph64, pw64, e0.seq.mi_rows, e0.seq.mi_cols,
            cdef=cfg.enable_cdef, bd=cfg.bit_depth, rdo=e0._rdo,
            txs=e0._txs, filt=cfg.interp_filter, rect=e0._rect)
        sy, su, sv = e0._upload_stack(frames, ph64, pw64)
        lvls = e0._lf_levels(qindex, False)
        out = step(sy, su, sv, *self._refs, qindex, lvls[0], lvls[2],
                   lvls[3])
        self._refs = e0._recon_as_ref(out)
        arrs = [a.cpu().numpy() for a in out]
        pkts = self._code(lambda s: self.encs[s]._make_inter_packet(
            frames[s], [a[s] for a in arrs], qindex, None))
        self._finish(pkts, idx, False)
        return pkts

    def _code(self, make) -> List[Packet]:
        """Entropy-code the S streams' frames of one slot on a thread
        pool (the C++ coder releases the GIL), in stream order."""
        if self.n == 1:
            return [make(0)]
        with ThreadPoolExecutor(max_workers=min(8, self.n)) as ex:
            return list(ex.map(make, range(self.n)))

    def _finish(self, pkts: List[Packet], idx: int, is_key: bool) -> None:
        for p in pkts:
            p.pts = idx
        self._rc_feedback(pkts, is_key)

    def _rc_feedback(self, pkts: List[Packet], is_key: bool) -> None:
        """Streams run in lockstep with a SHARED q, so the controller that
        picks q (encs[0]'s) absorbs the mean per-stream bits (packets
        bypass the per-frame update of a sequential encoder)."""
        rc = self.encs[0]._rc
        if rc is not None:
            mean_bits = sum(len(p.payload) for p in pkts) * 8 / len(pkts)
            rc.update(int(mean_bits), is_key)
