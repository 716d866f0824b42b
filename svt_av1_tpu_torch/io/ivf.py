"""IVF container (DKIF) writer/reader for AV01 streams."""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator


class IvfWriter:
    def __init__(self, fh: BinaryIO, width: int, height: int,
                 fps_num: int = 30, fps_den: int = 1) -> None:
        self.fh = fh
        self.count = 0
        fh.write(struct.pack("<4sHH4sHHIII4x", b"DKIF", 0, 32, b"AV01",
                             width, height, fps_num, fps_den, 0))

    def write_frame(self, payload: bytes, pts: int) -> None:
        self.fh.write(struct.pack("<IQ", len(payload), pts))
        self.fh.write(payload)
        self.count += 1

    def finalize(self) -> None:
        pos = self.fh.tell()
        self.fh.seek(24)
        self.fh.write(struct.pack("<I", self.count))
        self.fh.seek(pos)


class IvfReader:
    def __init__(self, fh: BinaryIO) -> None:
        hdr = fh.read(32)
        magic, _ver, hsz, fourcc, w, h, fn, fd, cnt = struct.unpack(
            "<4sHH4sHHIII4x", hdr)
        assert magic == b"DKIF" and fourcc == b"AV01", "not an AV01 IVF"
        self.fh = fh
        self.width, self.height = w, h
        self.fps = (fn, fd)
        self.frame_count = cnt

    def frames(self) -> Iterator[tuple[int, bytes]]:
        while True:
            hdr = self.fh.read(12)
            if len(hdr) < 12:
                return
            size, pts = struct.unpack("<IQ", hdr)
            yield pts, self.fh.read(size)
