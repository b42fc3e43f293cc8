"""MP4 facade of the port: ``dryv_tpu.video.Video`` demuxes, and
decoding goes through the port's batched GOP pipeline."""
from __future__ import annotations

import contextlib

from dryv_tpu.video import Video

from .gop_pipeline import decode_annexb_gop_pipelined


class TorchVideo(Video):
    def decode_frames(self, max_frames: int = 1, device="cuda",
                      timers=None):
        """Decode the first `max_frames` pictures (0 = all) on `device`;
        with `timers` (a dryv_tpu.utils.obs.StageTimers) the demux and
        pipeline stages are accumulated for --stats."""
        stage = (timers.stage if timers is not None
                 else lambda _name: contextlib.nullcontext())
        with stage("demux"):
            stream = self.annexb_stream()
        frames = decode_annexb_gop_pipelined(stream, device=device,
                                             timers=timers)
        if max_frames:
            frames = frames[:max_frames]
        return sorted(frames, key=lambda f: f.poc)
