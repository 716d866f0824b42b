"""MSB-first bit writer/reader for uncompressed headers.

Ref parity: OutputBitstreamUnit (EbBitstreamUnit.c) for writing;
the reader side mirrors the spec's f(n) parsing process.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def f(self, value: int, nbits: int) -> "BitWriter":
        assert 0 <= value < (1 << nbits), (value, nbits)
        for i in range(nbits - 1, -1, -1):
            self._acc = (self._acc << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._acc)
                self._acc = 0
                self._nbits = 0
        return self

    def trailing_bits(self) -> "BitWriter":
        """spec trailing_bits: a 1 bit then 0s to byte alignment."""
        self.f(1, 1)
        return self.byte_align()

    def byte_align(self) -> "BitWriter":
        if self._nbits:
            self.f(0, 8 - self._nbits)
        return self

    def data(self) -> bytes:
        assert self._nbits == 0, "unaligned"
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # bit position

    def f(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_offset(self) -> int:
        assert self.pos % 8 == 0
        return self.pos >> 3


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        b = data[pos + i]
        value |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return value, pos + i + 1
    raise ValueError("leb128 too long")
