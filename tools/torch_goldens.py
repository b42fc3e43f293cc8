#!/usr/bin/env python3
"""Write ``dryv_tpu_torch/testing/goldens.json``: the SHA-256 digests of
the libavcodec oracle's cropped planes, one entry per picture in output
order, for the bench streams that have no ``.npz`` golden.

    python tools/torch_goldens.py

Needs the JAX package's oracle (``dryv_tpu.testing.oracle``, cv2).  The
digests come from the oracle's decode only, never from the port's.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STREAMS = ("bench1080p_gop16.264", "bench1080p_ipb.264")


def main():
    from dryv_tpu.testing.oracle import decode_annexb
    from dryv_tpu_torch.testing.goldens import PATH, digest

    out = {}
    for name in STREAMS:
        with open(os.path.join(ROOT, "benchdata", name), "rb") as f:
            out[name] = [digest(*planes) for planes in decode_annexb(f.read())]
        print(f"{name}: {len(out[name])} pictures")
    PATH.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
