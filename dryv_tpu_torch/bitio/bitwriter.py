# Copy of dryv_tpu/bitio/bitwriter.py.
"""MSB-first bit writer with exp-Golomb, used by the fixture encoder/muxer."""
from __future__ import annotations


def insert_emulation_prevention(data: bytes) -> bytes:
    """Insert emulation_prevention_three_byte so no 00 00 0x (x<=3) runs appear."""
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class BitWriter:
    __slots__ = ("buf", "cur", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def bit(self, v: int) -> None:
        self.cur = (self.cur << 1) | (v & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.buf.append(self.cur)
            self.cur = 0
            self.nbits = 0

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def ue(self, v: int) -> None:
        code = v + 1
        n = code.bit_length()
        self.bits(0, n - 1)
        self.bits(code, n)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def byte_align(self, fill: int = 0) -> None:
        while self.nbits:
            self.bit(fill)

    def rbsp_trailing_bits(self) -> None:
        self.bit(1)
        self.byte_align(0)

    @property
    def bitpos(self) -> int:
        return len(self.buf) * 8 + self.nbits

    def bytes(self) -> bytes:
        assert self.nbits == 0, "stream not byte aligned"
        return bytes(self.buf)
