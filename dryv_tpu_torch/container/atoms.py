# Copy of dryv_tpu/container/atoms.py.
"""MP4/QuickTime atom tree parser.

Behavioural mirror of reference src/video/atom/ (root.rs, moov.rs, trak.rs,
mdia.rs, minf.rs, stbl.rs, stsd.rs, meta.rs, edts.rs, mdat.rs):
- lazy atom decode (EncodedAtom semantics via LazyAtom)
- streamed sample tables (SampleTable iterator, 24 KB read window)
- error atoms are logged and skipped, not fatal (root.rs:40)
- 64-bit mdat extended size (mdat.rs:12-19); co64; isom/qt brand handling
"""
from __future__ import annotations

import io
import logging
import struct
from dataclasses import dataclass, field
from enum import Enum
from typing import BinaryIO, Iterator, Optional

log = logging.getLogger("dryv_tpu.atom")

HEADER_SIZE = 8


class AtomError(Exception):
    pass


class DecoderBrand(Enum):
    QUICKTIME = b"qt  "
    ISOM = b"isom"

    @classmethod
    def from_ftyp(cls, ftyp: "FtypAtom") -> "DecoderBrand":
        for brand in (ftyp.major_brand, *ftyp.compatible_brands):
            if brand == b"qt  ":
                return cls.QUICKTIME
            if brand == b"isom":
                return cls.ISOM
        raise AtomError(f"unsupported brand {ftyp.major_brand!r}")


@dataclass
class Atom:
    size: int
    name: bytes
    offset: int  # payload offset in file

    def read_data(self, f: BinaryIO) -> bytes:
        f.seek(self.offset)
        return f.read(self.size - HEADER_SIZE)


def iter_atoms(f: BinaryIO, start: int, end: int) -> Iterator[Atom]:
    """Walk sibling atoms in [start, end) (reference AtomIter, iter.rs:41)."""
    off = start
    while off + HEADER_SIZE <= end:
        f.seek(off)
        hdr = f.read(HEADER_SIZE)
        if len(hdr) < HEADER_SIZE:
            return
        size = struct.unpack(">I", hdr[:4])[0]
        name = hdr[4:8]
        payload_off = off + HEADER_SIZE
        if size == 1:  # 64-bit extended size
            big = f.read(8)
            size = struct.unpack(">Q", big)[0]
            payload_off += 8
        elif size == 0:  # to end of file
            size = end - off
        if size < HEADER_SIZE:
            log.warning("atom %r at %d has bad size %d", name, off, size)
            return
        yield Atom(size, name, payload_off)
        off += size


def iter_data_atoms(data: bytes) -> Iterator[tuple[bytes, bytes]]:
    """In-memory sibling walk (reference AtomDataIter)."""
    off = 0
    while off + HEADER_SIZE <= len(data):
        size, name = struct.unpack(">I4s", data[off:off + HEADER_SIZE])
        if size < HEADER_SIZE:
            return
        yield name, data[off + HEADER_SIZE:off + size]
        off += size


class Cursor:
    """Byte cursor over atom payload (reference AtomData, decoder.rs:59)."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def bytes(self, n: int) -> bytes:
        v = self.d[self.o:self.o + n]
        self.o += n
        return v

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.bytes(2))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.bytes(2))[0]

    def u24(self) -> int:
        b = self.bytes(3)
        return (b[0] << 16) | (b[1] << 8) | b[2]

    def u32(self) -> int:
        return struct.unpack(">I", self.bytes(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.bytes(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.bytes(8))[0]

    def version_flags(self) -> tuple[int, int]:
        return self.u8(), self.u24()

    def fixed16(self) -> float:
        return self.i32() / 65536.0

    def fixed8(self) -> float:
        return self.i16() / 256.0

    def skip(self, n: int) -> None:
        self.o += n

    def remaining(self) -> int:
        return len(self.d) - self.o


def unpack_language_code(v: int) -> str:
    """ISO-639 packed 15-bit code (reference decoder.rs:148)."""
    return "".join(chr(((v >> s) & 0x1F) + 0x60) for s in (10, 5, 0))


# ---------------------------------------------------------------------------
# matrix (reference src/math.rs Matrix3x3)
# ---------------------------------------------------------------------------
@dataclass
class Matrix3x3:
    """Display matrix: a b u / c d v / x y w; 16.16 except u,v,w 2.30."""
    m: tuple

    @classmethod
    def parse(cls, cur: Cursor) -> "Matrix3x3":
        vals = []
        for i in range(9):
            raw = cur.i32()
            frac = 30 if i in (2, 5, 8) else 16
            vals.append(raw / (1 << frac))
        return cls(tuple(vals))

    def rotation(self) -> float:
        """Rotation in degrees (reference math.rs:36, 'based on libavutil')."""
        import math
        a, b = self.m[0], self.m[1]
        scale = math.hypot(a, b)
        if scale == 0:
            return 0.0
        return -math.degrees(math.atan2(b / scale, a / scale)) % 360.0


# ---------------------------------------------------------------------------
# parsed atoms
# ---------------------------------------------------------------------------
@dataclass
class FtypAtom:
    major_brand: bytes
    minor_version: int
    compatible_brands: list

    @classmethod
    def parse(cls, data: bytes) -> "FtypAtom":
        c = Cursor(data)
        major = c.bytes(4)
        minor = c.u32()
        brands = []
        while c.remaining() >= 4:
            brands.append(c.bytes(4))
        return cls(major, minor, brands)


@dataclass
class MvhdAtom:
    timescale: int = 0
    duration: int = 0
    rate: float = 1.0
    volume: float = 1.0
    matrix: Optional[Matrix3x3] = None

    @classmethod
    def parse(cls, data: bytes) -> "MvhdAtom":
        c = Cursor(data)
        version, _ = c.version_flags()
        if version == 1:
            c.skip(16)
            timescale = c.u32()
            duration = c.u64()
        else:
            c.skip(8)
            timescale = c.u32()
            duration = c.u32()
        rate = c.fixed16()
        volume = c.fixed8()
        c.skip(10)
        matrix = Matrix3x3.parse(c)
        return cls(timescale, duration, rate, volume, matrix)


@dataclass
class TkhdAtom:
    track_id: int = 0
    duration: int = 0
    layer: int = 0
    volume: float = 0.0
    matrix: Optional[Matrix3x3] = None
    width: float = 0.0
    height: float = 0.0

    @classmethod
    def parse(cls, data: bytes) -> "TkhdAtom":
        c = Cursor(data)
        version, _ = c.version_flags()
        if version == 1:
            c.skip(16)
            track_id = c.u32()
            c.skip(4)
            duration = c.u64()
        else:
            c.skip(8)
            track_id = c.u32()
            c.skip(4)
            duration = c.u32()
        c.skip(8)
        layer = c.i16()
        c.skip(2)
        volume = c.fixed8()
        c.skip(2)
        matrix = Matrix3x3.parse(c)
        width = c.fixed16()
        height = c.fixed16()
        return cls(track_id, duration, layer, volume, matrix, width, height)


@dataclass
class MdhdAtom:
    timescale: int = 0
    duration: int = 0
    language: str = "und"

    @classmethod
    def parse(cls, data: bytes) -> "MdhdAtom":
        c = Cursor(data)
        version, _ = c.version_flags()
        if version == 1:
            c.skip(16)
            timescale = c.u32()
            duration = c.u64()
        else:
            c.skip(8)
            timescale = c.u32()
            duration = c.u32()
        language = unpack_language_code(c.u16())
        return cls(timescale, duration, language)


@dataclass
class HdlrAtom:
    component_type: bytes = b""
    component_subtype: bytes = b""
    name: str = ""

    @classmethod
    def parse(cls, data: bytes) -> "HdlrAtom":
        c = Cursor(data)
        c.version_flags()
        ctype = c.bytes(4)
        subtype = c.bytes(4)
        manufacturer = c.bytes(4)
        c.skip(8)
        raw = c.bytes(c.remaining())
        if manufacturer == b"appl" and raw:
            name = raw[1:1 + raw[0]].decode("utf-8", "replace")
        else:
            name = raw.rstrip(b"\x00").decode("utf-8", "replace")
        return cls(ctype, subtype, name)


@dataclass
class ElstItem:
    track_duration: int
    media_time: int
    media_rate: float


@dataclass
class ElstAtom:
    items: list

    @classmethod
    def parse(cls, data: bytes) -> "ElstAtom":
        c = Cursor(data)
        version, _ = c.version_flags()
        n = c.u32()
        items = []
        for _ in range(n):
            if version == 1:
                d, t = c.u64(), struct.unpack(">q", c.bytes(8))[0]
            else:
                d, t = c.u32(), c.i32()
            items.append(ElstItem(d, t, c.fixed16()))
        return cls(items)


@dataclass
class DrefItem:
    kind: bytes
    flags: int
    data: bytes


@dataclass
class AvcCAtom:
    """AVC decoder configuration record (reference avcc/mod.rs:12-47)."""
    configuration_version: int = 1
    profile_indication: int = 0
    profile_compatibility: int = 0
    level_indication: int = 0
    nal_length_size: int = 4
    sps_list: list = field(default_factory=list)  # raw NAL bytes
    pps_list: list = field(default_factory=list)

    @classmethod
    def parse(cls, data: bytes) -> "AvcCAtom":
        c = Cursor(data)
        ver = c.u8()
        profile = c.u8()
        compat = c.u8()
        level = c.u8()
        nls = (c.u8() & 3) + 1
        n_sps = c.u8() & 0x1F
        sps_list = [c.bytes(c.u16()) for _ in range(n_sps)]
        n_pps = c.u8()
        pps_list = [c.bytes(c.u16()) for _ in range(n_pps)]
        return cls(ver, profile, compat, level, nls, sps_list, pps_list)

    def to_bytes(self) -> bytes:
        out = bytearray([self.configuration_version, self.profile_indication,
                         self.profile_compatibility, self.level_indication,
                         0xFC | (self.nal_length_size - 1),
                         0xE0 | len(self.sps_list)])
        for s in self.sps_list:
            out += struct.pack(">H", len(s)) + s
        out.append(len(self.pps_list))
        for p in self.pps_list:
            out += struct.pack(">H", len(p)) + p
        return bytes(out)


@dataclass
class Avc1Atom:
    width: int = 0
    height: int = 0
    depth: int = 0
    compressor: str = ""
    avcc: Optional[AvcCAtom] = None

    @classmethod
    def parse(cls, data: bytes) -> "Avc1Atom":
        c = Cursor(data)
        c.skip(6 + 2)              # reserved + data_reference_index
        c.skip(2 + 2 + 4 + 4 + 4)  # version, revision, vendor, temporal/spatial q
        width = c.u16()
        height = c.u16()
        c.skip(4 + 4 + 4 + 2)   # horiz/vert dpi, data size, frame count
        raw = c.bytes(32)
        compressor = raw[1:1 + raw[0]].decode("utf-8", "replace")
        depth = c.u16()
        c.skip(2)               # color table id
        avcc = None
        for name, payload in iter_data_atoms(c.d[c.o:]):
            if name == b"avcC":
                avcc = AvcCAtom.parse(payload)
        return cls(width, height, depth, compressor, avcc)


@dataclass
class Mp4aAtom:
    channels: int = 0
    sample_size: int = 0
    sample_rate: float = 0.0

    @classmethod
    def parse(cls, data: bytes) -> "Mp4aAtom":
        c = Cursor(data)
        c.skip(8 + 8)
        channels = c.u16()
        sample_size = c.u16()
        c.skip(4)
        rate = c.fixed16()
        return cls(channels, sample_size, rate)


@dataclass
class StsdEntry:
    fourcc: bytes
    codec: object  # Avc1Atom | Mp4aAtom | raw bytes


@dataclass
class StsdAtom:
    entries: list

    @classmethod
    def parse(cls, data: bytes) -> "StsdAtom":
        c = Cursor(data)
        c.version_flags()
        n = c.u32()
        entries = []
        off = c.o
        for _ in range(n):
            size, fourcc = struct.unpack(">I4s", data[off:off + 8])
            payload = data[off + 8:off + size]
            if fourcc == b"avc1":
                entries.append(StsdEntry(fourcc, Avc1Atom.parse(payload)))
            elif fourcc == b"mp4a":
                entries.append(StsdEntry(fourcc, Mp4aAtom.parse(payload)))
            else:
                entries.append(StsdEntry(fourcc, payload))
            off += size
        return cls(entries)


class SampleTable:
    """Streamed fixed-record table (reference SampleTable, stbl.rs:367-420).

    Reads records of `item_size` bytes through a bounded window so huge
    tables are never materialized."""
    WINDOW = 24_000

    def __init__(self, f: BinaryIO, offset: int, count: int, item_size: int,
                 parse_item):
        self.f = f
        self.offset = offset
        self.count = count
        self.item_size = item_size
        self.parse_item = parse_item

    def __len__(self):
        return self.count

    def __iter__(self):
        buf = b""
        pos = self.offset
        produced = 0
        bufoff = 0
        while produced < self.count:
            if len(buf) - bufoff < self.item_size:
                self.f.seek(pos)
                buf = buf[bufoff:] + self.f.read(self.WINDOW)
                pos += self.WINDOW
                bufoff = 0
                if len(buf) < self.item_size:
                    raise AtomError("sample table truncated")
            yield self.parse_item(buf[bufoff:bufoff + self.item_size])
            bufoff += self.item_size
            produced += 1

    def nth(self, n: int):
        self.f.seek(self.offset + n * self.item_size)
        return self.parse_item(self.f.read(self.item_size))


@dataclass
class StblAtom:
    """Sample table box: the demux index (reference stbl.rs)."""
    stsd: Optional[StsdAtom] = None
    stts: Optional[SampleTable] = None   # (sample_count, sample_duration)
    ctts: Optional[SampleTable] = None   # (sample_count, offset)
    stsc: Optional[SampleTable] = None   # (first_chunk, samples_per_chunk, id)
    stss: Optional[SampleTable] = None   # sync sample numbers
    stsz: Optional[SampleTable] = None
    stsz_uniform: int = 0
    stco: Optional[SampleTable] = None   # chunk offsets (co64-aware)
    sgpd_present: bool = False
    sbgp_present: bool = False

    @classmethod
    def parse(cls, f: BinaryIO, atom: Atom) -> "StblAtom":
        out = cls()
        for a in iter_atoms(f, atom.offset, atom.offset + atom.size - HEADER_SIZE):
            try:
                out._parse_child(f, a)
            except Exception as e:  # log-and-skip (reference moov.rs:36)
                log.warning("stbl child %r failed: %s", a.name, e)
        return out

    def _parse_child(self, f: BinaryIO, a: Atom):
        name = a.name
        if name == b"stsd":
            self.stsd = StsdAtom.parse(a.read_data(f))
            return
        if name in (b"sgpd", b"sbgp"):
            setattr(self, name.decode() + "_present", True)
            return
        f.seek(a.offset)
        head = f.read(8)
        count = struct.unpack(">I", head[4:8])[0]
        body = a.offset + 8
        if name == b"stts":
            self.stts = SampleTable(f, body, count, 8,
                                    lambda b: struct.unpack(">II", b))
        elif name == b"ctts":
            self.ctts = SampleTable(f, body, count, 8,
                                    lambda b: struct.unpack(">Ii", b))
        elif name == b"stsc":
            self.stsc = SampleTable(f, body, count, 12,
                                    lambda b: struct.unpack(">III", b))
        elif name == b"stss":
            self.stss = SampleTable(f, body, count, 4,
                                    lambda b: struct.unpack(">I", b)[0])
        elif name == b"stsz":
            uniform = struct.unpack(">I", head[4:8])[0]
            n = struct.unpack(">I", f.read(4))[0]
            self.stsz_uniform = uniform
            self.stsz = SampleTable(f, a.offset + 12, 0 if uniform else n, 4,
                                    lambda b: struct.unpack(">I", b)[0])
            self.stsz.total = n
        elif name == b"stco":
            self.stco = SampleTable(f, body, count, 4,
                                    lambda b: struct.unpack(">I", b)[0])
        elif name == b"co64":
            self.stco = SampleTable(f, body, count, 8,
                                    lambda b: struct.unpack(">Q", b)[0])
        else:
            log.debug("stbl: skipping %r", name)


@dataclass
class MinfAtom:
    handler_kind: Optional[bytes] = None  # vmhd/smhd/gmhd
    dref_items: list = field(default_factory=list)
    stbl: Optional[StblAtom] = None

    @classmethod
    def parse(cls, f: BinaryIO, atom: Atom) -> "MinfAtom":
        out = cls()
        for a in iter_atoms(f, atom.offset, atom.offset + atom.size - HEADER_SIZE):
            if a.name in (b"vmhd", b"smhd", b"gmhd"):
                out.handler_kind = a.name
            elif a.name == b"dinf":
                for name, payload in iter_data_atoms(a.read_data(f)):
                    if name == b"dref":
                        c = Cursor(payload)
                        c.version_flags()
                        n = c.u32()
                        for _ in range(n):
                            size = c.u32()
                            kind = c.bytes(4)
                            c.version_flags()
                            out.dref_items.append(
                                DrefItem(kind, 0, c.bytes(size - 12)))
            elif a.name == b"stbl":
                out.stbl = StblAtom.parse(f, a)
        if out.handler_kind is None:
            raise AtomError("minf has no vmhd/smhd/gmhd handler")
        return out


@dataclass
class MdiaAtom:
    mdhd: Optional[MdhdAtom] = None
    hdlr: Optional[HdlrAtom] = None
    minf_atom: Optional[Atom] = None
    _minf: Optional[MinfAtom] = None

    def minf(self, f: BinaryIO) -> Optional[MinfAtom]:
        if self._minf is None and self.minf_atom is not None:
            self._minf = MinfAtom.parse(f, self.minf_atom)
        return self._minf

    @classmethod
    def parse(cls, f: BinaryIO, atom: Atom) -> "MdiaAtom":
        out = cls()
        for a in iter_atoms(f, atom.offset, atom.offset + atom.size - HEADER_SIZE):
            if a.name == b"mdhd":
                out.mdhd = MdhdAtom.parse(a.read_data(f))
            elif a.name == b"hdlr":
                out.hdlr = HdlrAtom.parse(a.read_data(f))
            elif a.name == b"minf":
                out.minf_atom = a
        return out


@dataclass
class TrakAtom:
    tkhd: Optional[TkhdAtom] = None
    elst: Optional[ElstAtom] = None
    mdia: Optional[MdiaAtom] = None

    @classmethod
    def parse(cls, f: BinaryIO, atom: Atom) -> "TrakAtom":
        out = cls()
        for a in iter_atoms(f, atom.offset, atom.offset + atom.size - HEADER_SIZE):
            if a.name == b"tkhd":
                out.tkhd = TkhdAtom.parse(a.read_data(f))
            elif a.name == b"edts":
                for name, payload in iter_data_atoms(a.read_data(f)):
                    if name == b"elst":
                        out.elst = ElstAtom.parse(payload)
            elif a.name == b"mdia":
                out.mdia = MdiaAtom.parse(f, a)
        return out


@dataclass
class MetaTags:
    tags: dict

    @classmethod
    def parse(cls, data: bytes, isom: bool) -> "MetaTags":
        """keys <-> ilst join (reference meta.rs:41-79)."""
        if isom:
            data = data[4:]  # extra version/flags (moov.rs:104-106)
        keys = []
        values = []
        for name, payload in iter_data_atoms(data):
            if name == b"keys":
                c = Cursor(payload)
                c.version_flags()
                n = c.u32()
                for _ in range(n):
                    size = c.u32()
                    c.bytes(4)  # namespace
                    keys.append(c.bytes(size - 8).decode("utf-8", "replace"))
            elif name == b"ilst":
                for _idx, item in iter_data_atoms(payload):
                    for n2, p2 in iter_data_atoms(item):
                        if n2 == b"data":
                            values.append(p2[8:])
        return cls(dict(zip(keys, values)))


@dataclass
class MoovAtom:
    mvhd: Optional[MvhdAtom] = None
    traks: list = field(default_factory=list)
    meta: Optional[MetaTags] = None

    @classmethod
    def parse(cls, f: BinaryIO, atom: Atom, brand: DecoderBrand) -> "MoovAtom":
        out = cls()
        for a in iter_atoms(f, atom.offset, atom.offset + atom.size - HEADER_SIZE):
            try:
                if a.name == b"mvhd":
                    out.mvhd = MvhdAtom.parse(a.read_data(f))
                elif a.name == b"trak":
                    out.traks.append(TrakAtom.parse(f, a))
                elif a.name == b"udta":
                    for name, payload in iter_data_atoms(a.read_data(f)):
                        if name == b"meta":
                            out.meta = MetaTags.parse(
                                payload, brand == DecoderBrand.ISOM)
                elif a.name == b"meta":
                    out.meta = MetaTags.parse(a.read_data(f),
                                              brand == DecoderBrand.ISOM)
            except Exception as e:  # log-and-skip
                log.warning("moov child %r failed: %s", a.name, e)
        return out


# fourcc -> codec name (reference src/video/codec.rs 26 mappings)
VIDEO_CODECS = {
    b"avc1": "H264", b"hvc1": "HEVC", b"hev1": "HEVC", b"mp4v": "MPEG4",
    b"jpeg": "JPEG", b"png ": "PNG", b"tiff": "TIFF", b"gif ": "GIF",
    b"v210": "V210", b"v216": "V216", b"v308": "V308", b"v408": "V408",
    b"v410": "V410", b"raw ": "RAW", b"2vuy": "UYVY", b"yuv2": "YUV2",
    b"rle ": "QTRLE", b"smc ": "QTSMC", b"cvid": "CINEPAK", b"8BPS": "PLANAR_RGB",
    b"WRLE": "BMP", b"qdrw": "QUICKDRAW", b"rpza": "ROAD_PIZZA",
    b"mjpa": "MJPEG_A", b"mjpb": "MJPEG_B", b"svq1": "SORENSON1",
}


class MP4File:
    """Container facade (reference Decoder::open/decode_root)."""

    def __init__(self, path):
        self.f = open(path, "rb")
        import os
        size = os.fstat(self.f.fileno()).st_size
        self.ftyp = None
        self.mdat: Optional[Atom] = None
        moov_atom = None
        for atom in iter_atoms(self.f, 0, size):
            if atom.name == b"ftyp":
                self.ftyp = FtypAtom.parse(atom.read_data(self.f))
            elif atom.name == b"mdat":
                self.mdat = atom
            elif atom.name == b"moov":
                moov_atom = atom
        if self.ftyp is None or moov_atom is None:
            raise AtomError("missing ftyp/moov")
        self.brand = DecoderBrand.from_ftyp(self.ftyp)
        self.moov = MoovAtom.parse(self.f, moov_atom, self.brand)

    def close(self):
        self.f.close()

    def video_track(self) -> Optional[TrakAtom]:
        for trak in self.moov.traks:
            mdia = trak.mdia
            if mdia and mdia.hdlr and mdia.hdlr.component_subtype == b"vide":
                return trak
        return None

    # -- sample iteration (reference src/video/sample/mod.rs) -----------
    def iter_samples(self, stbl: StblAtom):
        """Walk stco x stsc x stsz to yield raw sample byte blobs."""
        stsc = list(stbl.stsc) if stbl.stsc else []
        chunk_offsets = list(stbl.stco) if stbl.stco else []
        if stbl.stsz_uniform:
            total = getattr(stbl.stsz, "total", 0)
            sizes = [stbl.stsz_uniform] * total
        else:
            sizes = list(stbl.stsz) if stbl.stsz else []
        si = 0
        for ci, coff in enumerate(chunk_offsets):
            per_chunk = 1
            for k, (first, n, _id) in enumerate(stsc):
                if first <= ci + 1:
                    per_chunk = n
                else:
                    break
            off = coff
            for _ in range(per_chunk):
                if si >= len(sizes):
                    return
                self.f.seek(off)
                yield self.f.read(sizes[si])
                off += sizes[si]
                si += 1
