"""MP4 facade of the port: demux with the port's own container layer, and
decoding routed by backend as ``dryv_tpu.video.Video.decode_frames``
routes it.  The demux (``__init__``, the info properties and
``annexb_stream``) follows ``dryv_tpu/video.py``."""
from __future__ import annotations

import contextlib

from .avc import NalUnit, split_avcc, to_annexb
from .container import MP4File
from .container.atoms import VIDEO_CODECS
from .gop_pipeline import decode_annexb_gop_pipelined
from .pipeline import decode_annexb_fast

BACKENDS = ("torch", "device-ipb", "native", "scalar")


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

    def info(self) -> dict:
        tkhd, mdhd = self.trak.tkhd, self.mdhd
        return {
            "codec": self.codec,
            "width": tkhd.width if tkhd else 0,
            "height": tkhd.height if tkhd else 0,
            "duration_s": (mdhd.duration / mdhd.timescale
                           if mdhd and mdhd.timescale else 0.0),
            "rotation": (tkhd.matrix.rotation() if tkhd and tkhd.matrix
                         else 0.0),
            "timescale": mdhd.timescale if mdhd else 0,
            "language": mdhd.language if mdhd else "und",
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
          (``device_ipb_packed.decode_annexb_device_packed``);
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
        with stage("decode"):
            if backend == "torch":
                frames = decode_annexb_fast(stream, max_frames=max_frames,
                                            device=device)
            elif backend == "device-ipb":
                from .device_ipb_packed import decode_annexb_device_packed
                frames = decode_annexb_device_packed(
                    stream, max_frames=max_frames, device=device)
            elif backend == "native":
                from .native.full import decode_annexb_native
                frames = decode_annexb_native(stream, max_frames=max_frames)
            else:
                from .decoder import decode_annexb_scalar
                frames = decode_annexb_scalar(stream, max_frames=max_frames)
        return sorted(frames, key=lambda f: f.poc)
