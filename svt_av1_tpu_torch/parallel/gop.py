"""GOP-parallel encoding of one stream: G GOPs in lockstep on one card.

Port of svt_av1_tpu/parallel/gop.py.  The reference package lays its
GOP shards over a device mesh; the shards' bytes do not depend on the
mesh, and here the G GOPs run as the G streams of one
MultiStreamEncoder on one device (their steps carry a leading GOP
axis).  Splitting the GOP axis over several cards is not ported.
"""

from __future__ import annotations

from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder

__all__ = ["GopShardedEncoder"]


class GopShardedEncoder:
    """Single-stream GOP-parallel encoder.

    Buffers ``n_shards`` consecutive GOPs (``gop_length`` frames each,
    every GOP opening with a keyframe) and encodes them in LOCKSTEP:
    slot g holds GOP g; step t encodes frame t of every GOP as one
    batched device step (GOPs are independent given keyframes).
    Packets come out in stream (display) order.

    ref analog: multi-channel instances (EbAppMain.c:196-215) applied to
    GOP chunks of one stream.  Exposed through
    ``EncoderConfig.num_gop_shards`` via the CLI (app/enc_app.py).
    """

    def __init__(self, config, n_shards: int, gop_length: int,
                 device="cuda") -> None:
        if gop_length < 2 or n_shards < 1:
            raise ValueError("GOP sharding needs gop_length >= 2 and "
                             "n_shards >= 1")
        self.L = gop_length
        self.G = n_shards
        self.device = device
        self._cfg = config.replace(intra_period=gop_length - 1,
                                   scene_change_detection=False,
                                   num_gop_shards=1)
        self._ms = MultiStreamEncoder(self._cfg, n_shards, device=device)
        self._buf: list = []
        self._packets: list = []
        self._emitted = 0

    def send_picture(self, frame) -> None:
        """Queue one source frame (None = end of stream / flush)."""
        if frame is None:
            self.flush()
            return
        self._buf.append(frame)
        if len(self._buf) == self.G * self.L:
            self._process(len(self._buf))

    def flush(self) -> None:
        if not self._buf:
            return
        n_real = len(self._buf)
        # pad the tail with copies of the last frame to fill the slot
        # grid; padding packets (strictly after the real tail in stream
        # order) are dropped below
        while len(self._buf) < self.G * self.L:
            self._buf.append(self._buf[-1])
        self._process(n_real)

    def _process(self, n_real: int) -> None:
        chunks = [self._buf[g * self.L: (g + 1) * self.L]
                  for g in range(self.G)]
        self._buf = []
        # GOPs are the recovery unit: a failure mid super-GOP discards
        # only this super-GOP's device state; one retry re-encodes it from
        # the buffered source frames on a fresh lockstep encoder before
        # giving up.
        for attempt in range(2):
            try:
                per_slot = self._encode_chunks(chunks)
                break
            except Exception:
                if attempt:
                    raise
                self._ms = MultiStreamEncoder(self._cfg, self.G,
                                              device=self.device)
        base = self._emitted
        for g in range(self.G):
            for t, p in enumerate(per_slot[g]):
                if g * self.L + t >= n_real:
                    break
                p.pts = base + g * self.L + t
                p.display_idx = p.pts
                self._packets.append(p)
        self._emitted += n_real

    def _encode_chunks(self, chunks) -> list:
        per_slot = [[] for _ in range(self.G)]
        # reset lockstep state: every super-GOP restarts at a keyframe
        self._ms._idx = 0
        self._ms._refs = None
        for t in range(self.L):
            pkts = self._ms.send([chunks[g][t] for g in range(self.G)])
            for g, p in enumerate(pkts):
                per_slot[g].append(p)
        return per_slot

    def get_packet(self):
        return self._packets.pop(0) if self._packets else None

    def encode_all(self, frames):
        """Convenience: push all frames, yield packets in stream order."""
        for f in frames:
            self.send_picture(f)
            while self._packets:
                yield self._packets.pop(0)
        self.flush()
        while self._packets:
            yield self._packets.pop(0)
