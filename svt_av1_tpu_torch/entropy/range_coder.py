"""AV1 multisymbol range (arithmetic) coder — daala ``od_ec`` semantics.

This is a clean-room implementation of the AV1 entropy coder (AV1 spec
§8.2 "Boolean decoder" / the daala range coder it normatively inverts).
Encoder and decoder here are byte-exact mutual inverses and follow the
fixed-point interval arithmetic the spec decoder mandates:

    u/v = ((rng >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
          + EC_MIN_PROB * (#symbols below)

with ``EC_PROB_SHIFT = 6`` and ``EC_MIN_PROB = 4``.

CDFs are passed in *inverse* form (icdf[i] = 32768 - cum_prob(symbol <= i)),
matching the storage convention of the adaptation model (cdf_model.py).

Reference parity: EbBitstreamUnit.{c,h} (od_ec_enc window/low/rng state
EbBitstreamUnit.h:165-257, od_ec_encode_q15 EbBitstreamUnit.c:300,
checkpoint/rollback EbBitstreamUnit.h:240-241).  The hot path has a C++
twin (csrc/entropy.cpp) validated byte-identical against this module.
"""

from __future__ import annotations

from typing import List, Sequence

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
WINDOW_BITS = 32
_WINDOW_MASK = (1 << WINDOW_BITS) - 1
_LOTS_OF_BITS = 0x4000


def _ilog_nz(x: int) -> int:
    """Number of bits needed to represent x (x > 0): floor(log2(x)) + 1."""
    return x.bit_length()


class RangeEncoder:
    """od_ec_enc: range encoder with carry-propagation byte buffer."""

    __slots__ = ("low", "rng", "cnt", "precarry")

    def __init__(self) -> None:
        self.low = 0          # coding window (31 usable bits)
        self.rng = 0x8000     # current range, 0x8000..0xFFFF
        self.cnt = -9         # negative of bits needed before first byte out
        self.precarry: List[int] = []  # 9-bit values: byte + carry bit

    # -- checkpoint/rollback for RDO trial encodes (ref EbBitstreamUnit.h:240)
    def checkpoint(self):
        return (self.low, self.rng, self.cnt, len(self.precarry))

    def rollback(self, state) -> None:
        self.low, self.rng, self.cnt, n = state
        del self.precarry[n:]

    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - _ilog_nz(rng)
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & _WINDOW_MASK
        self.rng = (rng << d) & 0xFFFF
        self.cnt = s

    def encode_symbol(self, s: int, icdf: Sequence[int], nsyms: int) -> None:
        """Encode symbol s given inverse CDF (icdf[i] = 32768 - cum[i])."""
        low = self.low
        r = self.rng
        fl = 32768 if s == 0 else int(icdf[s - 1])
        fh = int(icdf[s])
        if fl < 32768:
            u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (nsyms - s)
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (nsyms - s - 1)
            low = (low + (r - u)) & _WINDOW_MASK
            r = u - v
        else:
            r -= (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (nsyms - s - 1)
        self._normalize(low, r)

    def encode_bool(self, val: int, f: int) -> None:
        """Encode a boolean; f = P(val == 0) in Q15 (0 < f < 32768)."""
        low = self.low
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
            + EC_MIN_PROB
        if val:
            low = (low + (r - v)) & _WINDOW_MASK
            r = v
        else:
            r -= v
        self._normalize(low, r)

    def encode_literal(self, val: int, bits: int) -> None:
        """Raw bits, MSB first, each with p=1/2 (aom_write_literal)."""
        for i in range(bits - 1, -1, -1):
            self.encode_bool((val >> i) & 1, 16384)

    def done(self) -> bytes:
        """Flush: emit minimal bits so any suffix decodes correctly."""
        low = self.low
        c = self.cnt
        s = 10
        m = 0x3FFF
        e = ((low + m) & ~m & _WINDOW_MASK) | (m + 1)
        s += c
        pre = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                pre.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # carry propagation (from last byte to first)
        out = bytearray(len(pre))
        carry = 0
        for i in range(len(pre) - 1, -1, -1):
            v = pre[i] + carry
            out[i] = v & 0xFF
            carry = v >> 8
        return bytes(out)


class RangeDecoder:
    """od_ec_dec: the normative AV1 symbol decoder."""

    __slots__ = ("buf", "pos", "dif", "rng", "cnt")

    def __init__(self, data: bytes) -> None:
        self.buf = data
        self.pos = 0
        self.dif = (1 << (WINDOW_BITS - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = WINDOW_BITS - 9 - (self.cnt + 15)
        dif = self.dif
        cnt = self.cnt
        pos = self.pos
        n = len(self.buf)
        while s >= 0 and pos < n:
            dif ^= self.buf[pos] << s
            cnt += 8
            pos += 1
            s -= 8
        if pos >= n:
            cnt = _LOTS_OF_BITS
        self.dif = dif
        self.cnt = cnt
        self.pos = pos

    def _normalize(self, dif: int, rng: int) -> None:
        d = 16 - _ilog_nz(rng)
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _WINDOW_MASK
        self.rng = (rng << d) & 0xFFFF
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, icdf: Sequence[int], nsyms: int) -> int:
        dif = self.dif
        r = self.rng
        c = dif >> (WINDOW_BITS - 16)
        v = r
        ret = -1
        while True:
            ret += 1
            u = v
            v = (((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT))
                 >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (nsyms - ret - 1)
            if c >= v:
                break
        dif -= v << (WINDOW_BITS - 16)
        self._normalize(dif, u - v)
        return ret

    def decode_bool(self, f: int) -> int:
        dif = self.dif
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
            + EC_MIN_PROB
        vw = v << (WINDOW_BITS - 16)
        if dif >= vw:
            ret = 0
            dif -= vw
            rng = r - v
        else:
            ret = 1
            rng = v
        self._normalize(dif, rng)
        return ret

    def decode_literal(self, bits: int) -> int:
        x = 0
        for _ in range(bits):
            x = (x << 1) | self.decode_bool(16384)
        return x
