# Copy of dryv_tpu/container/mux.py.
"""Minimal MP4 muxer for fixture generation.

Writes an isom-brand file with a single AVC video track: ftyp, mdat
(length-prefixed samples), moov (mvhd, trak/tkhd/mdia/mdhd/hdlr/minf/
vmhd/dinf/stbl with stsd+avcC, stts, stsc, stsz, stco, stss)."""
from __future__ import annotations

import struct

from .atoms import AvcCAtom


def _box(name: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), name) + payload


def _full(name: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(name, struct.pack(">B3s", version,
                                  flags.to_bytes(3, "big")) + payload)


def write_mp4(path, samples, sps_nal: bytes, pps_nal: bytes, width: int,
              height: int, timescale: int = 15360, sample_duration: int = 512,
              sync_samples=None):
    """samples: list of avcC-framed (4-byte length-prefixed) sample blobs."""
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
    mdat_payload = b"".join(samples)
    mdat = _box(b"mdat", mdat_payload)
    mdat_offset = len(ftyp) + 8  # samples start after mdat header

    n = len(samples)
    duration = n * sample_duration

    avcc = AvcCAtom(1, sps_nal[1], sps_nal[2], sps_nal[3], 4,
                    [sps_nal], [pps_nal])
    avc1 = _box(b"avc1",
                b"\x00" * 6 + struct.pack(">H", 1) +
                b"\x00" * 16 +
                struct.pack(">HH", width, height) +
                struct.pack(">II", 0x00480000, 0x00480000) +
                struct.pack(">I", 0) + struct.pack(">H", 1) +
                b"\x00" * 32 +
                struct.pack(">Hh", 24, -1) +
                _box(b"avcC", avcc.to_bytes()))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + avc1)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, sample_duration))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n) +
                 b"".join(struct.pack(">I", len(s)) for s in samples))
    # one chunk holding all samples
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_offset))
    sync = sync_samples if sync_samples is not None else [1]
    stss = _full(b"stss", 0, 0, struct.pack(">I", len(sync)) +
                 b"".join(struct.pack(">I", s) for s in sync))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco + stss)

    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) +
                 _full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4 + b"vide" + b"\x00" * 12 +
                 b"VideoHandler\x00")
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, duration)
                 + struct.pack(">Hh", 0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    matrix = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    tkhd = _full(b"tkhd", 0, 3,
                 struct.pack(">IIII", 0, 0, 1, 0) +
                 struct.pack(">I", duration) + b"\x00" * 8 +
                 struct.pack(">hhHH", 0, 0, 0, 0) + matrix +
                 struct.pack(">II", width << 16, height << 16))
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(b"mvhd", 0, 0,
                 struct.pack(">IIII", 0, 0, timescale, duration) +
                 struct.pack(">IH", 0x00010000, 0x0100) + b"\x00" * 10 +
                 matrix + b"\x00" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
