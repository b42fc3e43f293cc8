"""CLI of the port, a drop-in for ``python -m dryv_tpu``: the same
arguments, and by default the same output file, the first decoded frame
as planar YUV (``TorchVideo.write_yuv``).

Usage: python -m dryv_tpu_torch <file.mp4> [-d] [-o OUT] [--frames N]
       [--backend torch|jax|device-ipb|native|scalar] [-s SEEK]
       [--stats] [--trace DIR] [--device cuda|cpu] [--all-frames]

--stats prints the decode's host stages (seconds and calls), its
counters (frames, CABAC bins, CAVLC slice-data bits, wire bytes, staging
retries, pictures of parallel batches, the native tasks' microseconds,
the emulation-prevention bytes removed from the slices, the calls
that started from a kept staging),
bins/s, CAVLC bits/s and the batched entropy's parallelism as JSON.  --trace DIR records the decode
under torch.profiler (host ops, and the card's kernels and copies where
CUDA is present) and writes
DIR/trace.json, a Chrome trace; it takes the stage timers as --stats
does, so the trace also holds each stage as a range ``dryv.<stage>``
on the same clock as the card's activity.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time

from .video import BACKENDS, TorchVideo


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dryv-tpu-torch",
        description="AVC decode on PyTorch + CUDA (H100)")
    ap.add_argument("filepath")
    ap.add_argument("-d", "--debug", action="store_true",
                    help="debug logging, also into debug.log")
    ap.add_argument("-o", "--output", default="temp/yuv_frame",
                    help="planar YUV output (the first frame, or every "
                         "frame with --all-frames)")
    ap.add_argument("--frames", type=int, default=1,
                    help="frames to decode (0 = all)")
    ap.add_argument("--backend", choices=BACKENDS + ("jax",),
                    default="torch",
                    help="torch (intra device paths; inter streams go to "
                         "the C++ host decoder; 'jax', the JAX CLI's name "
                         "for it, is the same), device-ipb (the packed "
                         "I/P/B device path), native (C++ host), scalar "
                         "(Python reference)")
    ap.add_argument("-s", "--seek", default=None,
                    help="seek position: Ns | Nms | N%% | Nts (parsed, "
                         "not applied, as in the JAX CLI)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timing and the decode's counters "
                         "as JSON after decoding")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the decode, with "
                         "its dryv.<stage> ranges, to DIR/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--all-frames", action="store_true",
                    help="write every decoded frame, one after another")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(levelname).1s %(name)s %(message)s")
    if args.debug:
        from .utils.obs import enable_debug_log
        enable_debug_log("debug.log")

    from .utils.obs import StageTimers, logger, trace_device

    t0 = time.time()
    v = TorchVideo.open(args.filepath)
    info = v.info()
    logger("cli").debug("%s: %s", args.filepath, info)
    for k, val in info.items():
        print(f"{k}: {val}")
    tm = StageTimers() if args.stats or args.trace else None
    backend = "torch" if args.backend == "jax" else args.backend
    with (trace_device(args.trace) if args.trace
          else contextlib.nullcontext()):
        frames = v.decode_frames(max_frames=args.frames, device=args.device,
                                 timers=tm, backend=backend)
    if frames:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        out = frames if args.all_frames else frames[:1]
        v.write_yuv(args.output, *out)
        print(f"wrote {len(out)} frame(s) to {args.output} "
              f"({frames[0].y.shape[1]}x{frames[0].y.shape[0]})")
    if args.stats:
        print("stats:", json.dumps(tm.report()))
    if args.trace:
        print(f"trace: {os.path.join(args.trace, 'trace.json')}")
    print(f"Done in {time.time() - t0:.3f}s")
    return 0
