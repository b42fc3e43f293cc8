"""Write a configuration's ``golden.json``: the SHA-256 digests of each
pool picture's cropped planes as libavcodec decodes them.

    python avcbench/tools/goldens.py avcbench/configs/x264-ipb-1080p ...

The decoder is the libavcodec bundled with OpenCV's wheel, driven through
ctypes by ``libav.decode_annexb``; the digests never come from the
program under test.  For a pool of IDR pictures the tool also decodes a
composed stream (the pictures in another order) and checks that each
picture decodes alike there, which is what lets the harness judge a
composed stream by the pool's digests.  It runs only where cv2 is
installed, and the benchmark never imports it.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(folders):
    from avcbench.check import digest
    from avcbench.streams import Pool, compose_idr, sha256
    from avcbench.tools.libav import decode_annexb

    for folder in folders:
        config = os.path.basename(os.path.normpath(folder))
        cfg = json.load(open(os.path.join(folder, "config.json")))
        out = {}
        for entry in cfg["pool"]:
            data = open(os.path.join(folder, entry["file"]), "rb").read()
            if sha256(data) != entry["sha256"]:
                raise SystemExit(f"{entry['file']}: SHA-256 differs")
            out[entry["file"]] = [digest(*p) for p in decode_annexb(data)]
            if len(out[entry["file"]]) != entry["pictures"]:
                raise SystemExit(f"{entry['file']}: "
                                 f"{len(out[entry['file']])} pictures")
            pool = Pool.parse(data)
            if all(i is not None for i in pool.idr_ids()):
                n = len(pool.pictures)
                order = [(7 * k + 2 * (k % 2)) % n for k in range(n)]
                order = [o if o % 2 == k % 2 else (o + 1) % n
                         for k, o in enumerate(order)]
                got = [digest(*p) for p in
                       decode_annexb(compose_idr(pool, order))]
                if got != [out[entry["file"]][i] for i in order]:
                    raise SystemExit(f"{entry['file']}: a picture decodes "
                                     f"differently in another order")
            print(f"{config}/{entry['file']}: {len(out[entry['file']])} "
                  f"pictures")
        with open(os.path.join(folder, "golden.json"), "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
