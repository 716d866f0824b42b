"""YUV 4:2:0 frame sources: raw .yuv, .y4m, and synthetic test frames."""

from __future__ import annotations

from typing import BinaryIO, Iterator, Optional

import numpy as np


class Frame:
    """One 8-bit 4:2:0 picture (y: [H, W], u/v: [H/2, W/2])."""

    __slots__ = ("y", "u", "v")

    def __init__(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        self.y, self.u, self.v = y, u, v

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]


class YuvReader10:
    """Raw planar 4:2:0 10-bit (little-endian uint16 samples)."""

    def __init__(self, fh, width: int, height: int) -> None:
        self.fh, self.w, self.h = fh, width, height

    def frames(self):
        w, h = self.w, self.h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        fsz = 2 * (w * h + 2 * cw * ch)
        while True:
            buf = self.fh.read(fsz)
            if len(buf) < fsz:
                return
            a = np.frombuffer(buf, "<u2")
            y = a[: w * h].reshape(h, w)
            u = a[w * h : w * h + cw * ch].reshape(ch, cw)
            v = a[w * h + cw * ch :].reshape(ch, cw)
            yield Frame(y.copy(), u.copy(), v.copy())


class YuvReaderPacked10:
    """SVT 'compressed ten bit' 4:2:0 reader (ref ReadInputFrames,
    EbAppProcessCmd.c:846-864 with compressed_ten_bit_format=1).

    Per frame: three 8-bit MSB planes (Y, U, V) followed by three 2-bit
    LSB planes packed 4 samples/byte MSB-first (width/4 bytes per row).
    sample = (msb << 2) | lsb.
    """

    def __init__(self, fh, width: int, height: int) -> None:
        assert width % 4 == 0, "packed 10-bit needs width % 4 == 0"
        self.fh, self.w, self.h = fh, width, height

    @staticmethod
    def _unpack2(buf: np.ndarray, h: int, w: int) -> np.ndarray:
        """[h, w/4] packed bytes -> [h, w] 2-bit samples."""
        b = buf.reshape(h, w // 4)
        out = np.empty((h, w), np.uint16)
        for j, sh in enumerate((6, 4, 2, 0)):
            out[:, j::4] = (b >> sh) & 3
        return out

    def frames(self):
        w, h = self.w, self.h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        n8 = w * h + 2 * cw * ch
        n2 = w * h // 4 + 2 * (cw * ch // 4)
        while True:
            buf = self.fh.read(n8 + n2)
            if len(buf) < n8 + n2:
                return
            a = np.frombuffer(buf, np.uint8)
            y8 = a[: w * h].reshape(h, w).astype(np.uint16)
            u8 = a[w * h : w * h + cw * ch].reshape(ch, cw).astype(np.uint16)
            v8 = a[w * h + cw * ch : n8].reshape(ch, cw).astype(np.uint16)
            p = a[n8:]
            y2 = self._unpack2(p[: w * h // 4], h, w)
            u2 = self._unpack2(p[w * h // 4 : w * h // 4 + cw * ch // 4],
                               ch, cw)
            v2 = self._unpack2(p[w * h // 4 + cw * ch // 4 :], ch, cw)
            yield Frame((y8 << 2) | y2, (u8 << 2) | u2, (v8 << 2) | v2)


class YuvReader:
    """Planar I420 raw file reader (ref ReadInputFrames)."""

    def __init__(self, fh: BinaryIO, width: int, height: int) -> None:
        self.fh, self.w, self.h = fh, width, height

    def frames(self) -> Iterator[Frame]:
        w, h = self.w, self.h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        fsize = w * h + 2 * cw * ch
        while True:
            buf = self.fh.read(fsize)
            if len(buf) < fsize:
                return
            a = np.frombuffer(buf, np.uint8)
            y = a[: w * h].reshape(h, w)
            u = a[w * h : w * h + cw * ch].reshape(ch, cw)
            v = a[w * h + cw * ch :].reshape(ch, cw)
            yield Frame(y, u, v)


class Y4MReader:
    """YUV4MPEG2 reader, 8-bit 420 only (ref EbAppInputy4m.c)."""

    def __init__(self, fh: BinaryIO) -> None:
        self.fh = fh
        header = bytearray()
        while not header.endswith(b"\n"):
            header += fh.read(1)
        fields = header.decode().split()
        assert fields[0] == "YUV4MPEG2"
        self.w = self.h = 0
        self.fps = (30, 1)
        for f in fields[1:]:
            if f[0] == "W":
                self.w = int(f[1:])
            elif f[0] == "H":
                self.h = int(f[1:])
            elif f[0] == "F":
                n, d = f[1:].split(":")
                self.fps = (int(n), int(d))
            elif f[0] == "C" and not f[1:].startswith("420"):
                raise ValueError(f"unsupported chroma {f}")

    def frames(self) -> Iterator[Frame]:
        w, h = self.w, self.h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        fsize = w * h + 2 * cw * ch
        while True:
            marker = self.fh.readline()
            if not marker:
                return
            assert marker.startswith(b"FRAME")
            buf = self.fh.read(fsize)
            if len(buf) < fsize:
                return
            a = np.frombuffer(buf, np.uint8)
            yield Frame(a[: w * h].reshape(h, w),
                        a[w * h : w * h + cw * ch].reshape(ch, cw),
                        a[w * h + cw * ch :].reshape(ch, cw))


def synthetic_frame(width: int, height: int, seed: int = 0,
                    kind: str = "mix", bit_depth: int = 8) -> Frame:
    """Deterministic synthetic content (gradients + texture + edges),
    the TPU build's stand-in for the reference's DummyVideoSource."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    if kind == "flat":
        y = np.full((height, width), 128, np.float64)
    elif kind == "noise":
        y = rng.uniform(0, 255, (height, width))
    else:
        y = (96 + 60 * np.sin(xx / 23.0 + seed) * np.cos(yy / 17.0)
             + 40 * ((xx + yy + 7 * seed) % 97 > 48)
             + rng.normal(0, 3.0, (height, width)))
    if bit_depth == 10:
        sc, px = 4, np.uint16
    else:
        sc, px = 1, np.uint8
    hi = (1 << bit_depth) - 1
    y = np.clip(y * sc, 0, hi).astype(px)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    u = np.clip((128 + 30 * np.sin(np.mgrid[0:ch, 0:cw][1] / 11.0 + seed))
                * sc, 0, hi).astype(px)
    v = np.clip((128 + 30 * np.cos(np.mgrid[0:ch, 0:cw][0] / 13.0 - seed))
                * sc, 0, hi).astype(px)
    return Frame(y, u, v)


def synthetic_clip(width: int, height: int, n: int) -> list:
    """Moving synthetic content: a textured base that drifts, plus a
    moving local patch that breaks pure global motion, so ME has real
    work and a B frame's two references differ."""
    base = synthetic_frame(width, height, seed=7)
    frames = []
    for i in range(n):
        f = synthetic_frame(width, height, seed=7)
        f.y[:] = np.roll(base.y, (2 * i, 3 * i), (0, 1))
        f.u[:] = np.roll(base.u, (i, i), (0, 1))
        f.v[:] = np.roll(base.v, (i, -i), (0, 1))
        yy = (17 * i) % max(1, height - 64)
        xx = (29 * i) % max(1, width - 64)
        f.y[yy: yy + 48, xx: xx + 48] = f.y[yy: yy + 48, xx: xx + 48] // 2 + 64
        frames.append(f)
    return frames


def vod_clip(width: int, height: int, n: int) -> list:
    """bench.py's 4K 10-bit VOD clip (run_vod_4k10) at any size: one
    seeded 10-bit picture (synthetic_frame seed 5) whose luma is rolled
    by (2i, 3i) in frame i; chroma stays.  The base is made once."""
    base = synthetic_frame(width, height, seed=5, bit_depth=10)
    return [Frame(np.roll(base.y, (2 * i, 3 * i), (0, 1)), base.u.copy(),
                  base.v.copy()) for i in range(n)]
