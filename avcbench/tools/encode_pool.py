"""Encode the pool of a configuration and write it into the
configuration's folder, with each stream's SHA-256 and x264 options in
its ``config.json``.

    python avcbench/tools/encode_pool.py avcbench/configs/x264-ipb-1080p
    python avcbench/tools/encode_pool.py avcbench/configs/x264-intra-1080p

The recipe of each configuration is below: libx264 (core 164) through the
system libavcodec at ``--preset medium`` with x264's own defaults for
everything the preset sets (CRF 23, one slice, deblocking on), single-
threaded, and only what defines the deployment on top (``keyint=1`` for
keyframe-only streams).  The sources are the synthetic random-textured
gradients of ``libav.make_source``: a GOP is one source panned 5 luma
samples a picture, an IDR pool is 8 unrelated sources.  Then run
``goldens.py`` and ``kernel_work.py`` on the folder.  The tool runs only
where libx264 is installed; the benchmark never imports it.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from avcbench.streams import sha256  # noqa: E402
from avcbench.tools import libav  # noqa: E402

W, H = 1920, 1080
# configuration -> (x264 parameters, [(file, source kind, seed, pictures)])
RECIPES = {
    "x264-ipb-1080p": ("", [(f"gop_s{s}.264", "panned", s, 10)
                            for s in (9, 10, 11)]),
    "x264-intra-1080p": ("keyint=1", [("idr8_s100.264", "stills", 100, 8)]),
}


def encode(params, kind, seed, n, width=W, height=H) -> bytes:
    frames = getattr(libav, kind)(seed, n, width, height)
    return libav.encode_x264(frames, params)


def main(folder):
    name = os.path.basename(os.path.normpath(folder))
    params, streams = RECIPES[name]
    path = os.path.join(folder, "config.json")
    cfg = json.load(open(path))
    pool, opts = [], set()
    for fname, kind, seed, n in streams:
        data = encode(params, kind, seed, n)
        open(os.path.join(folder, fname), "wb").write(data)
        opts.add(libav.options(data))
        pool.append({"file": fname, "sha256": sha256(data), "pictures": n,
                     "made_by": f"avcbench/tools/encode_pool.py {name}: "
                                f"{kind} source, seed {seed}"})
        print(fname, len(data), flush=True)
    if len(opts) != 1:
        raise SystemExit(f"the pool's x264 options differ: {opts}")
    cfg["x264_options"] = opts.pop()
    cfg["pool"] = pool
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    for folder in sys.argv[1:]:
        main(folder)
