# Copy of dryv_tpu/avc/nal.py, but NalUnit.parse takes a span of its
# buffer, so split_annexb and split_avcc copy each payload once.
"""NAL unit layer (spec 7.3.1 / 7.4.1).

Mirrors reference src/video/sample/nal.rs (NALUnitIter, NALUnitType, SEI)
with both length-prefixed (avcC, as stored in MP4) and Annex-B framing.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from ..bitio import strip_emulation_prevention, insert_emulation_prevention


class NalUnitType(IntEnum):
    UNSPECIFIED = 0
    NON_IDR_SLICE = 1
    DATA_PARTITION_A = 2
    DATA_PARTITION_B = 3
    DATA_PARTITION_C = 4
    IDR_SLICE = 5
    SEI = 6
    SPS = 7
    PPS = 8
    ACCESS_UNIT_DELIMITER = 9
    END_OF_SEQUENCE = 10
    END_OF_STREAM = 11
    FILLER = 12
    SPS_EXTENSION = 13
    PREFIX_NAL = 14
    SUBSET_SPS = 15
    DEPTH_PS = 16
    AUX_SLICE = 19
    SLICE_EXTENSION = 20
    DEPTH_SLICE_EXTENSION = 21


@dataclass
class NalUnit:
    ref_idc: int
    type: NalUnitType
    payload: bytes  # EBSP (with emulation prevention), not including header byte

    @classmethod
    def parse(cls, data: bytes, start: int = 0,
              end: int | None = None) -> "NalUnit":
        """The NAL unit in data[start:end], its payload the one copy."""
        end = len(data) if end is None else end
        if start >= end:
            raise IndexError("empty NAL unit")
        hdr = data[start]
        if hdr & 0x80:
            raise ValueError("forbidden_zero_bit set")
        return cls(ref_idc=(hdr >> 5) & 3, type=NalUnitType(hdr & 0x1F),
                   payload=data[start + 1:end])

    @property
    def rbsp(self) -> bytes:
        return strip_emulation_prevention(self.payload)

    @classmethod
    def build(cls, ref_idc: int, typ: NalUnitType, rbsp: bytes) -> "NalUnit":
        return cls(ref_idc, typ, insert_emulation_prevention(rbsp))

    def to_bytes(self) -> bytes:
        return bytes([(self.ref_idc << 5) | int(self.type)]) + self.payload


def split_avcc(sample: bytes, nal_length_size: int):
    """Yield NalUnits from a length-prefixed MP4 sample (reference nal.rs:214)."""
    i, n = 0, len(sample)
    while i + nal_length_size <= n:
        size = int.from_bytes(sample[i:i + nal_length_size], "big")
        i += nal_length_size
        if size == 0 or i + size > n:
            break
        yield NalUnit.parse(sample, i, i + size)
        i += size


def split_annexb(stream: bytes):
    """Yield NalUnits from an Annex-B byte stream (start codes)."""
    starts = []  # payload start positions (just past the 00 00 01)
    n = len(stream)
    i = stream.find(b"\x00\x00\x01")
    while i != -1:
        starts.append(i + 3)
        i = stream.find(b"\x00\x00\x01", i + 3)
    for k, s in enumerate(starts):
        if k + 1 < len(starts):
            e = starts[k + 1] - 3  # start of next 00 00 01
            # a 4-byte start code's leading zero belongs to the next unit
            while e > s and stream[e - 1] == 0:
                e -= 1
        else:
            e = n
        yield NalUnit.parse(stream, s, e)


def to_annexb(nals) -> bytes:
    out = bytearray()
    for nal in nals:
        out += b"\x00\x00\x00\x01"
        out += nal.to_bytes()
    return bytes(out)


def to_avcc_sample(nals, nal_length_size: int = 4) -> bytes:
    out = bytearray()
    for nal in nals:
        b = nal.to_bytes()
        out += len(b).to_bytes(nal_length_size, "big")
        out += b
    return bytes(out)


# ---------------------------------------------------------------------------
# SEI (reference nal.rs:8-54): ff-escaped type/size varints.
# ---------------------------------------------------------------------------
@dataclass
class SeiMessage:
    payload_type: int
    payload: bytes

    @classmethod
    def parse_all(cls, rbsp: bytes):
        msgs = []
        i = 0
        while i < len(rbsp) and rbsp[i] != 0x80:
            t = 0
            while i < len(rbsp) and rbsp[i] == 0xFF:
                t += 255
                i += 1
            if i >= len(rbsp):
                break
            t += rbsp[i]
            i += 1
            s = 0
            while i < len(rbsp) and rbsp[i] == 0xFF:
                s += 255
                i += 1
            if i >= len(rbsp):
                break
            s += rbsp[i]
            i += 1
            msgs.append(cls(t, rbsp[i:i + s]))
            i += s
        return msgs
