# Copy of dryv_tpu/bitio/bitreader.py.
"""MSB-first bit reader over RBSP bytes.

Capability parity with the reference BitStream (src/byte/bit.rs:6-168):
bit/bits/peek, unsigned & signed exp-Golomb, byte alignment checks and
``more_rbsp_data``.  Unlike the reference — which strips 0x000003
emulation-prevention bytes inline during each byte fetch (bit.rs:144-148) —
we strip them once per NAL (``strip_emulation_prevention``), which keeps the
hot path branch-free and matches how the C++ entropy stage consumes buffers.
"""
from __future__ import annotations


def strip_emulation_prevention(data: bytes) -> bytes:
    """Remove emulation_prevention_three_byte: 00 00 03 -> 00 00 (spec 7.4.1.1)."""
    if b"\x00\x00\x03" not in data:
        return data
    out = bytearray()
    i, n = 0, len(data)
    zeros = 0
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        zeros = zeros + 1 if b == 0 else 0
        out.append(b)
        i += 1
    return bytes(out)


class BitReader:
    """Reads bits MSB-first from a byte buffer (RBSP, already EPB-stripped)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    # -- core ---------------------------------------------------------------
    def bit(self) -> int:
        p = self.pos
        byte = self.data[p >> 3]
        self.pos = p + 1
        return (byte >> (7 - (p & 7))) & 1

    def bits(self, n: int) -> int:
        v = 0
        p = self.pos
        data = self.data
        end = p + n
        while p < end:
            avail = 8 - (p & 7)
            take = min(avail, end - p)
            byte = data[p >> 3]
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            p += take
        self.pos = end
        return v

    def peek_bits(self, n: int) -> int:
        save = self.pos
        v = self.bits(n)
        self.pos = save
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    # -- exp-Golomb (spec 9.1) ---------------------------------------------
    def ue(self) -> int:
        zeros = 0
        while self.bit() == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("malformed exp-Golomb code")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.bits(zeros)

    def se(self) -> int:
        k = self.ue()
        # spec 9.1.1: value = (-1)^(k+1) * ceil(k/2)
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    # -- state --------------------------------------------------------------
    @property
    def bit_len(self) -> int:
        return len(self.data) * 8

    def has_bits(self, n: int = 1) -> bool:
        return self.pos + n <= self.bit_len

    def is_byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def more_rbsp_data(self) -> bool:
        """True if there is data before the rbsp_stop_one_bit (spec 7.2)."""
        if self.pos >= self.bit_len:
            return False
        # Find last set bit in the stream; data remains if we are before it.
        data = self.data
        for i in range(len(data) - 1, -1, -1):
            if data[i]:
                b = data[i]
                lsb = (b & -b).bit_length() - 1  # lowest set bit
                last_one = i * 8 + (7 - lsb)  # MSB-first bit index of stop bit
                return self.pos < last_one
        return False
