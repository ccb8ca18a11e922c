"""LSB-first bitstream reader for JPEG XL codestreams.

JPEG XL packs bits little-endian, least-significant-bit first within each
byte (ISO/IEC 18181-1 §A.2).  This reader is the host-side front-end of the
device engine: all byte-level framing stays on the host, device code only ever
sees fixed-shape arrays (see SURVEY.md §7, hard part 7).

Reference behavior being reproduced (not ported): the wrapper's decode entry
feeds whole codestreams to libjxl's bit reader
(/root/reference/jxlcoder/src/main/cpp/interop/JxlDecoding.cpp:36-176).
"""

from __future__ import annotations


class BitstreamError(Exception):
    """Malformed or unsupported bitstream."""


class BitReader:
    """LSB-first bit reader over a bytes-like object."""

    __slots__ = ("data", "nbytes", "pos")

    def __init__(self, data: bytes, start_bit: int = 0):
        self.data = data
        self.nbytes = len(data)
        self.pos = start_bit  # absolute bit position

    # -- primitives ---------------------------------------------------------

    def u(self, n: int) -> int:
        """Read n bits (0 <= n <= 57ish fine), LSB first."""
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        if end > self.nbytes * 8:
            raise BitstreamError(
                f"bitstream overrun: need {n} bits at {pos}, have {self.nbytes * 8}")
        byte0 = pos >> 3
        byte1 = (end + 7) >> 3
        window = int.from_bytes(self.data[byte0:byte1], "little")
        val = (window >> (pos & 7)) & ((1 << n) - 1)
        self.pos = end
        return val

    def peek(self, n: int) -> int:
        """Peek n bits without consuming; zero-padded past end of stream."""
        pos = self.pos
        byte0 = pos >> 3
        byte1 = min((pos + n + 7) >> 3, self.nbytes)
        window = int.from_bytes(self.data[byte0:byte1], "little")
        return (window >> (pos & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n

    def bits_remaining(self) -> int:
        return self.nbytes * 8 - self.pos

    def bool(self) -> bool:
        return self.u(1) == 1

    # -- composite fields (§A.3) -------------------------------------------

    def u32(self, d0, d1, d2, d3) -> int:
        """U32 field: 2-bit selector then one of 4 distributions.

        Each distribution is either an int constant or a tuple
        (nbits, offset) meaning u(nbits) + offset.
        """
        d = (d0, d1, d2, d3)[self.u(2)]
        if isinstance(d, int):
            return d
        nbits, offset = d
        return self.u(nbits) + offset

    def u64(self) -> int:
        sel = self.u(2)
        if sel == 0:
            return 0
        if sel == 1:
            return self.u(4) + 1
        if sel == 2:
            return self.u(8) + 17
        value = self.u(12)
        shift = 12
        while self.u(1):
            if shift == 60:
                value |= self.u(4) << shift
                break
            value |= self.u(8) << shift
            shift += 8
        return value

    def enum(self) -> int:
        v = self.u32(0, 1, (4, 2), (6, 18))
        if v > 63:
            raise BitstreamError(f"enum value {v} > 63")
        return v

    def f16(self) -> float:
        """Read a 16-bit IEEE half-precision float (bit pattern LSB-first)."""
        bits = self.u(16)
        sign = -1.0 if bits & 0x8000 else 1.0
        exp = (bits >> 10) & 0x1F
        mant = bits & 0x3FF
        if exp == 0:
            return sign * mant * 2.0 ** -24
        if exp == 31:
            raise BitstreamError("F16 NaN/Inf not allowed in headers")
        return sign * (1024 + mant) * 2.0 ** (exp - 25)

    def zero_pad_to_byte(self) -> None:
        rem = (-self.pos) % 8
        if rem:
            if self.u(rem) != 0:
                raise BitstreamError("non-zero padding bits")

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0


def unpack_signed(u: int) -> int:
    """UnpackSigned per §A.4: 0,1,2,3,4,... -> 0,-1,1,-2,2,..."""
    if u & 1:
        return -((u + 1) >> 1)
    return u >> 1


def pack_signed(v: int) -> int:
    """Inverse of unpack_signed."""
    if v >= 0:
        return v << 1
    return (-v << 1) - 1
