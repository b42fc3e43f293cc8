"""MP4 facade of the port: demux with the port's own container layer, and
decoding routed by backend as ``dryv_tpu.video.Video.decode_frames``
routes it.  The demux (``__init__``, the info properties and
``annexb_stream``), ``SeekPosition`` and ``write_yuv`` follow
``dryv_tpu/video.py``."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np

from .avc import NalUnit, split_avcc, to_annexb
from .container import MP4File
from .container.atoms import VIDEO_CODECS
from .gop_pipeline import decode_annexb_gop_pipelined
from .pipeline import decode_annexb_fast

BACKENDS = ("torch", "device-ipb", "native", "scalar")


@dataclass
class SeekPosition:
    """Seek grammar: '12s' | '1500ms' | '50%' | '1234ts' (a copy of
    ``dryv_tpu/video.py``'s)."""
    kind: str = "ts"
    value: float = 0.0

    @classmethod
    def parse(cls, s: str) -> "SeekPosition":
        s = s.strip()
        for suffix, kind in (("ms", "ms"), ("s", "s"), ("%", "pct"),
                             ("ts", "ts")):
            if s.endswith(suffix):
                try:
                    return cls(kind, float(s[:-len(suffix)]))
                except ValueError:
                    break
        return cls("ts", 0.0)


class TorchVideo:
    def __init__(self, path):
        self.path = str(path)
        self.mp4 = MP4File(path)
        self.trak = self.mp4.video_track()
        if self.trak is None:
            raise ValueError("no video track")
        mdia = self.trak.mdia
        self.mdhd = mdia.mdhd
        self.stbl = mdia.minf(self.mp4.f).stbl
        entry = self.stbl.stsd.entries[0]
        self.codec = VIDEO_CODECS.get(entry.fourcc, "UNKNOWN")
        self.avc1 = entry.codec if entry.fourcc == b"avc1" else None

    @classmethod
    def open(cls, path) -> "TorchVideo":
        return cls(path)

    @property
    def width(self) -> float:
        return self.trak.tkhd.width if self.trak.tkhd else 0

    @property
    def height(self) -> float:
        return self.trak.tkhd.height if self.trak.tkhd else 0

    @property
    def duration_seconds(self) -> float:
        if not self.mdhd or not self.mdhd.timescale:
            return 0.0
        return self.mdhd.duration / self.mdhd.timescale

    @property
    def rotation(self) -> float:
        tkhd = self.trak.tkhd
        return tkhd.matrix.rotation() if tkhd and tkhd.matrix else 0.0

    @property
    def meta_tags(self) -> dict:
        return self.mp4.moov.meta.tags if self.mp4.moov.meta else {}

    def info(self) -> dict:
        return {
            "codec": self.codec,
            "width": self.width,
            "height": self.height,
            "duration_s": self.duration_seconds,
            "rotation": self.rotation,
            "timescale": self.mdhd.timescale if self.mdhd else 0,
            "language": self.mdhd.language if self.mdhd else "und",
        }

    def annexb_stream(self) -> bytes:
        """The elementary Annex-B stream: avcC parameter sets + every
        sample's NAL units in decode order."""
        if self.codec != "H264" or self.avc1 is None or self.avc1.avcc is None:
            raise NotImplementedError(f"codec {self.codec}")
        avcc = self.avc1.avcc
        nals = [NalUnit.parse(b) for b in avcc.sps_list + avcc.pps_list]
        for sample in self.mp4.iter_samples(self.stbl):
            nals.extend(split_avcc(sample, avcc.nal_length_size))
        return to_annexb(nals)

    def decode_frames(self, max_frames: int = 1, device="cuda",
                      timers=None, backend: str = "torch"):
        """Decode the first `max_frames` pictures (0 = all), in display
        (POC) order.  Backends, as ``Video.decode_frames``'s:

        - "torch" (the JAX package's "jax"): on `device`, with `timers` (a
          ``utils.obs.StageTimers``) the batched pipeline decoding the
          whole stream with its demux and pipeline stages accumulated for
          --stats, without it ``pipeline.decode_annexb_fast``;
        - "device-ipb": the packed I/P/B path on `device`
          (``device_ipb_packed.decode_annexb_device_packed``, its stages
          into `timers`);
        - "native": the C++ host decoder (``native.full``);
        - "scalar": the Python reference decoder."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of "
                             f"{', '.join(BACKENDS)}")
        stage = (timers.stage if timers is not None
                 else lambda _name: contextlib.nullcontext())
        with stage("demux"):
            stream = self.annexb_stream()
        if backend == "torch" and timers is not None:
            frames = decode_annexb_gop_pipelined(stream, device=device,
                                                 timers=timers)
            if max_frames:
                frames = frames[:max_frames]
            return sorted(frames, key=lambda f: f.poc)
        if backend == "device-ipb":
            from .device_ipb_packed import decode_annexb_device_packed
            frames = decode_annexb_device_packed(
                stream, max_frames=max_frames, device=device, timers=timers)
            return sorted(frames, key=lambda f: f.poc)
        with stage("decode"):
            if backend == "torch":
                frames = decode_annexb_fast(stream, max_frames=max_frames,
                                            device=device)
            elif backend == "native":
                from .native.full import decode_annexb_native
                frames = decode_annexb_native(stream, max_frames=max_frames)
            else:
                from .decoder import decode_annexb_scalar
                frames = decode_annexb_scalar(stream, max_frames=max_frames)
        return sorted(frames, key=lambda f: f.poc)

    def write_yuv(self, path, *frames):
        """Planar YUV dump, Y then Cb then Cr as uint8 (the scalar
        decoder's planes are wider integers), of one frame as
        ``Video.write_yuv`` writes it, or of several one after
        another."""
        with open(path, "wb") as f:
            for frame in frames:
                for plane in (frame.y, frame.cb, frame.cr):
                    f.write(plane.astype(np.uint8).tobytes())
