"""LSB-first bit writer — the encode-side mirror of reader.py.

Serves the encoder surface of the reference (JxlCoder.encode →
EncodeJxlOneshot, /root/reference/jxlcoder/src/main/cpp/interop/
JxlEncoding.cpp:36-193), re-implemented for our own codestream
writer.
"""

from __future__ import annotations


class BitWriter:
    """Accumulates bits LSB-first into a bytearray."""

    __slots__ = ("_buf", "_acc", "_nacc")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nacc = 0

    def u(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >= (1 << n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        self._acc |= value << self._nacc
        self._nacc += n
        while self._nacc >= 8:
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nacc -= 8

    def bool(self, v: bool) -> None:
        self.u(1 if v else 0, 1)

    def u32(self, value: int, d0, d1, d2, d3) -> None:
        """Write value choosing the cheapest U32 distribution that fits."""
        best = None
        for sel, d in enumerate((d0, d1, d2, d3)):
            if isinstance(d, int):
                if value == d:
                    cost = 2
                    cand = (cost, sel, None)
                else:
                    continue
            else:
                nbits, offset = d
                if offset <= value < offset + (1 << nbits):
                    cand = (2 + nbits, sel, (value - offset, nbits))
                else:
                    continue
            if best is None or cand[0] < best[0]:
                best = cand
        if best is None:
            raise ValueError(f"value {value} not representable by U32 spec")
        _, sel, payload = best
        self.u(sel, 2)
        if payload is not None:
            self.u(payload[0], payload[1])

    def u64(self, value: int) -> None:
        if value == 0:
            self.u(0, 2)
        elif value <= 16:
            self.u(1, 2)
            self.u(value - 1, 4)
        elif value <= 272:
            self.u(2, 2)
            self.u(value - 17, 8)
        else:
            self.u(3, 2)
            self.u(value & 0xFFF, 12)
            value >>= 12
            shift = 12
            while value > 0:
                self.u(1, 1)  # continuation
                if shift == 60:
                    self.u(value & 0xF, 4)
                    return  # reader breaks after the 4-bit tail
                self.u(value & 0xFF, 8)
                value >>= 8
                shift += 8
            self.u(0, 1)  # stop bit

    def f16(self, value: float) -> None:
        import numpy as np
        bits = int(np.float16(value).view(np.uint16))
        self.u(bits, 16)

    def zero_pad_to_byte(self) -> None:
        if self._nacc:
            self.u(0, 8 - self._nacc)

    @property
    def bit_pos(self) -> int:
        return len(self._buf) * 8 + self._nacc

    def append_bits(self, data: bytes, nbits: int) -> None:
        """Bulk-append `nbits` LSB-first bits from `data`."""
        if nbits <= 0:
            return
        nbytes_in = (nbits + 7) // 8
        if self._nacc == 0:
            full = nbits // 8
            self._buf.extend(data[:full])
            rem = nbits - full * 8
            if rem:
                self._acc = data[full] & ((1 << rem) - 1)
                self._nacc = rem
            return
        big = int.from_bytes(data[:nbytes_in], "little")
        if nbits < nbytes_in * 8:
            big &= (1 << nbits) - 1
        acc = self._acc | (big << self._nacc)
        total = self._nacc + nbits
        full = total // 8
        if full:
            self._buf.extend(
                (acc & ((1 << (full * 8)) - 1)).to_bytes(full, "little"))
            acc >>= full * 8
        self._acc = acc
        self._nacc = total - full * 8

    def append_writer(self, other: "BitWriter") -> None:
        """Concatenate another writer's bits (bit-granular)."""
        data = bytes(other._buf)
        if other._nacc:
            data += bytes([other._acc & 0xFF])
        self.append_bits(data, len(other._buf) * 8 + other._nacc)

    def to_bytes(self) -> bytes:
        out = bytes(self._buf)
        if self._nacc:
            out += bytes([self._acc & 0xFF])
        return out
