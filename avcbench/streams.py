"""Annex B streams of the benchmark's pools: NAL units, access units, the
few slice-header fields that composing a stream has to keep, and the
composition itself.  Plain Python; nothing of the program is imported.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

SLICE, IDR, SPS = 1, 5, 7     # nal_unit_type


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def nal_units(stream: bytes) -> list[bytes]:
    """The NAL units of an Annex B byte stream, each without its start
    code (trailing zero bytes belong to the start code that follows)."""
    starts = []
    i = stream.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = stream.find(b"\x00\x00\x01", i + 3)
    out = []
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else len(stream)
        out.append(stream[s:e].rstrip(b"\x00"))
    return out


def nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F


def rbsp(nal: bytes) -> bytes:
    """The payload of a NAL unit with its emulation prevention bytes
    (0x000003) taken out."""
    out = bytearray()
    zeros = 0
    for b in nal[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class Bits:
    """MSB-first reader of Exp-Golomb coded fields (H.264 9.1)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        z = 0
        while self.u(1) == 0:
            z += 1
        return (1 << z) - 1 + self.u(z)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


@dataclass
class SeqParams:
    log2_max_frame_num: int
    frame_mbs_only: int
    width_mbs: int
    height_mbs: int


def _skip_scaling_list(r: Bits, size: int) -> None:
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        last = nxt or last


def parse_sps(nal: bytes) -> SeqParams:
    """The SPS fields that slice headers and the picture size need
    (H.264 7.3.2.1.1)."""
    r = Bits(rbsp(nal))
    profile = r.u(8)
    r.u(16)
    r.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139,
                   134, 135):
        chroma = r.ue()
        if chroma == 3:
            r.u(1)
        r.ue()
        r.ue()
        r.u(1)
        if r.u(1):
            for i in range(8 if chroma != 3 else 12):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    log2_max_frame_num = r.ue() + 4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()
    r.u(1)
    width = r.ue() + 1
    height_units = r.ue() + 1
    frame_mbs_only = r.u(1)
    return SeqParams(log2_max_frame_num, frame_mbs_only, width,
                     height_units * (2 - frame_mbs_only))


# a slice header's first fields lie in its first bytes
HEAD = 64


def idr_pic_id(nal: bytes, sps: SeqParams) -> int:
    """idr_pic_id of an IDR slice (H.264 7.3.3)."""
    r = Bits(rbsp(nal[:HEAD]))
    r.ue()
    r.ue()
    r.ue()
    r.u(sps.log2_max_frame_num)
    if not sps.frame_mbs_only and r.u(1):
        r.u(1)
    return r.ue()


def first_mb(nal: bytes) -> int:
    return Bits(rbsp(nal[:HEAD])).ue()


@dataclass
class Pool:
    """One stream of a pool: its header NAL units (everything before the
    first slice) and its access units, each the list of its NAL units
    (parameter sets and SEI between two pictures open the later one)."""
    header: list
    pictures: list
    sps: SeqParams

    @classmethod
    def parse(cls, stream: bytes) -> "Pool":
        header, pictures, pending = [], [], []
        sps = None
        for nal in nal_units(stream):
            t = nal_type(nal)
            if t == SPS:
                sps = parse_sps(nal)
            if t not in (SLICE, IDR):
                pending.append(nal)
                continue
            if first_mb(nal) == 0:
                if not pictures:
                    header, pending = pending, []
                pictures.append(pending)
                pending = []
            pictures[-1].append(nal)
        if sps is None or not pictures:
            raise ValueError("a pool stream needs an SPS and a picture")
        pictures[-1].extend(pending)
        return cls(header, pictures, sps)

    def idr_ids(self) -> list:
        """idr_pic_id of each picture (None for a non-IDR picture)."""
        out = []
        for pic in self.pictures:
            first = next(n for n in pic if nal_type(n) in (SLICE, IDR))
            out.append(idr_pic_id(first, self.sps)
                       if nal_type(first) == IDR else None)
        return out


def join(nals) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def compose_idr(pool: Pool, order) -> bytes:
    """A stream of pool's IDR pictures in `order` (indices into
    pool.pictures) behind the pool's header.  Consecutive IDR pictures
    must differ in idr_pic_id (H.264 7.4.3); raises if two would not."""
    ids = pool.idr_ids()
    if any(ids[i] is None for i in order):
        raise ValueError("compose_idr takes IDR pictures only")
    for a, b in zip(order, order[1:]):
        if ids[a] == ids[b]:
            raise ValueError(f"pictures {a} and {b} follow each other with "
                             f"idr_pic_id {ids[a]}")
    return join(pool.header + [n for i in order for n in pool.pictures[i]])


def check_idr_stream(stream: bytes) -> int:
    """The number of pictures of an all-IDR stream; raises if two
    consecutive pictures share idr_pic_id."""
    p = Pool.parse(stream)
    ids = p.idr_ids()
    if any(i is None for i in ids):
        raise ValueError("a picture of the stream is not IDR")
    for k in range(1, len(ids)):
        if ids[k] == ids[k - 1]:
            raise ValueError(f"pictures {k - 1} and {k} share idr_pic_id "
                             f"{ids[k]}")
    return len(ids)
