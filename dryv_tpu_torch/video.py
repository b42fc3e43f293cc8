"""MP4 facade of the port: ``dryv_tpu.video.Video`` demuxes, and
decoding routes as ``Video.decode_frames(backend="jax")`` does: the
batched GOP pipeline with stage timers, the per-picture path without."""
from __future__ import annotations

import contextlib

from dryv_tpu.video import Video

from .gop_pipeline import decode_annexb_gop_pipelined
from .pipeline import decode_annexb_fast


class TorchVideo(Video):
    def decode_frames(self, max_frames: int = 1, device="cuda",
                      timers=None):
        """Decode the first `max_frames` pictures (0 = all) on `device`,
        in display (POC) order.  With `timers` (a
        dryv_tpu.utils.obs.StageTimers) the batched pipeline decodes the
        whole stream and the demux and pipeline stages are accumulated
        for --stats; without, ``pipeline.decode_annexb_fast`` decodes
        the first `max_frames` pictures."""
        stage = (timers.stage if timers is not None
                 else lambda _name: contextlib.nullcontext())
        with stage("demux"):
            stream = self.annexb_stream()
        if timers is None:
            frames = decode_annexb_fast(stream, max_frames=max_frames,
                                        device=device)
        else:
            frames = decode_annexb_gop_pipelined(stream, device=device,
                                                 timers=timers)
            if max_frames:
                frames = frames[:max_frames]
        return sorted(frames, key=lambda f: f.poc)
