"""CLI of the port.

Usage: python -m dryv_tpu_torch <file.mp4> [-o OUT] [--frames N]
       [--device cuda|cpu] [--backend torch|device-ipb|native|scalar]
       [--stats]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .video import BACKENDS, TorchVideo


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="dryv-tpu-torch",
        description="AVC decode on PyTorch + CUDA (H100)")
    ap.add_argument("filepath")
    ap.add_argument("-o", "--output", default="temp/yuv_frame",
                    help="planar YUV output, frames one after another")
    ap.add_argument("--frames", type=int, default=1,
                    help="frames to write (0 = all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--backend", choices=BACKENDS, default="torch",
                    help="torch (intra device paths; inter streams go to "
                         "the C++ host decoder), device-ipb (the packed "
                         "I/P/B device path), native (C++ host), scalar "
                         "(Python reference)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timing as JSON after decoding")
    args = ap.parse_args(argv)

    from .utils.obs import StageTimers

    t0 = time.time()
    v = TorchVideo.open(args.filepath)
    for k, val in v.info().items():
        print(f"{k}: {val}")
    tm = StageTimers() if args.stats else None
    frames = v.decode_frames(max_frames=args.frames, device=args.device,
                             timers=tm, backend=args.backend)
    if frames:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "wb") as f:
            for fr in frames:
                for plane in (fr.y, fr.cb, fr.cr):
                    if plane is not None:
                        # the scalar decoder's planes are wider ints
                        f.write(plane.astype(np.uint8).tobytes())
        print(f"wrote {len(frames)} frame(s) to {args.output} "
              f"({frames[0].y.shape[1]}x{frames[0].y.shape[0]})")
    if tm is not None:
        print("stats:", json.dumps(tm.report()))
    print(f"Done in {time.time() - t0:.3f}s")
    return 0
