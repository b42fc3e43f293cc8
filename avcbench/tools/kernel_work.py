"""Write a configuration's ``work.json``: the bytes and int32 operations
of every B2 and B3 launch that decoding each pool stream makes, for the
``b2_roofline`` and ``b3_roofline`` readers.

    python avcbench/tools/kernel_work.py avcbench/configs/x264-ipb-1080p \
        avcbench/traffic/gop10.json
    python avcbench/tools/kernel_work.py avcbench/configs/x264-intra-1080p \
        avcbench/traffic/stream128.json

Each pool stream is decoded once on the CPU through the entry that the
traffic mix names (``avcbench/entries.py``) with the plain kernels and
graph=False; the calls of B2 (``intra_recon``) and B3 (``deblock``) are
watched, and each launch's work is counted by ``chip_smoke.py``'s
``b2_ops`` and ``b3_ops`` (operations, from the ``B2_*`` and ``B3_*``
counts of the kernels' code), and as its tensors' bytes (each input read once, each output written once, the tables not
counted, as ``chip_smoke.py``'s bound does).  The planes it decodes are
held against ``golden.json`` first.  A batched launch of F pictures is
stored per picture (its bytes divided by F, each picture's own
operations), so that the harness can sum any batch of pool pictures; an
I/P/B picture is one launch.  Runs for minutes; the benchmark never
imports it.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def main(folder, traffic_path):
    from dryv_tpu_torch import device_ipb_packed, gop_pipeline
    from avcbench.check import pictures_wrong
    from avcbench.entries import ENTRIES
    from chip_smoke import b2_ops, b3_ops

    calls = []
    originals = {}
    for mod in (device_ipb_packed, gop_pipeline):
        originals[mod] = (mod.intra_recon, mod.deblock)

        def b2(meta, yres, cres, tables, mb_w, mb_h, halo=None,
               _f=mod.intra_recon):
            out = _f(meta, yres, cres, tables, mb_w, mb_h, halo=halo)
            F = meta.shape[0]
            calls.append(("b2", [[nbytes(meta, yres, cres, *out) / F,
                                  b2_ops(meta[i:i + 1])]
                                 for i in range(F)]))
            return out

        def b3(prm, y, cb, cr, mb_w, mb_h, _f=mod.deblock):
            ops = [b3_ops(prm[i:i + 1], y[i:i + 1], cb[i:i + 1],
                          cr[i:i + 1], mb_w, mb_h) for i in range(y.shape[0])]
            out = _f(prm, y, cb, cr, mb_w, mb_h)
            F = y.shape[0]
            calls.append(("b3", [[nbytes(prm, y, cb, cr, *out) / F, o]
                                 for o in ops]))
            return out

        mod.intra_recon, mod.deblock = b2, b3
    try:
        config = os.path.basename(os.path.normpath(folder))
        cfg = json.load(open(os.path.join(folder, "config.json")))
        golden = json.load(open(os.path.join(folder, "golden.json")))
        traffic = json.load(open(traffic_path))
        entry = ENTRIES[traffic["entry"]](traffic, cfg, "cpu")
        out = {}
        for p in cfg["pool"]:
            data = open(os.path.join(folder, p["file"]), "rb").read()
            calls.clear()
            got = [tuple(t.numpy() for t in pic)
                   for pic in entry.call(data, None)]
            if pictures_wrong(got, golden[p["file"]]):
                raise SystemExit(f"{p['file']}: the CPU decode differs "
                                 f"from the golden digests")
            # a last batch padded to F repeats its last picture: keep the
            # stream's own pictures
            out[p["file"]] = {k: [c for kk, cs in calls if kk == k
                                  for c in cs][:p["pictures"]]
                              for k in ("b2", "b3")}
            print(f"{config}/{p['file']}: "
                  f"{len(out[p['file']]['b2'])} B2 and "
                  f"{len(out[p['file']]['b3'])} B3 pictures", flush=True)
        with open(os.path.join(folder, "work.json"), "w") as f:
            json.dump(out, f)
            f.write("\n")
    finally:
        for mod, (a, b) in originals.items():
            mod.intra_recon, mod.deblock = a, b


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
