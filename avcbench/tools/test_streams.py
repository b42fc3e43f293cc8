"""Encode the small streams of the configurations in
``avcbench/tests/configs/``, which the CPU tests run through the harness
in place of the 1080p pools.

    python avcbench/tools/test_streams.py

``tiny-ipb``: three GOPs of 10 pictures at 320x184 (20x12 MBs, cropped as
1080p is), with the recipe of ``x264-ipb-1080p``; ``tiny-intra``: 16 IDR
pictures at 320x184 with that of ``x264-intra-1080p``
(``encode_pool.RECIPES``).  Then run ``tools/goldens.py`` on both
folders.  It runs only where libx264 is installed, and the benchmark
never imports it.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from avcbench.streams import sha256  # noqa: E402
from avcbench.tools.encode_pool import RECIPES, encode  # noqa: E402

W, H = 320, 184
TINY = {
    "tiny-ipb": ("x264-ipb-1080p", [(f"gop_s{s}.264", "panned", s, 10)
                                    for s in (1, 2, 3)]),
    "tiny-intra": ("x264-intra-1080p", [("idr16_s3.264", "stills", 3, 16)]),
}


def main():
    for name, (like, streams) in TINY.items():
        params = RECIPES[like][0]
        folder = os.path.join(ROOT, "avcbench", "tests", "configs", name)
        os.makedirs(folder, exist_ok=True)
        pool = []
        for fname, kind, seed, n in streams:
            data = encode(params, kind, seed, n, W, H)
            open(os.path.join(folder, fname), "wb").write(data)
            pool.append({"file": fname, "sha256": sha256(data),
                         "pictures": n})
        cfg = {"name": name, "width": W, "height": H, "pool": pool}
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
            f.write("\n")
        print(name, [(p["file"], p["sha256"][:12]) for p in pool])


if __name__ == "__main__":
    main()
