"""The control of the comparison that decides ``correct``, and the sound
runs' readings beside it, over many seeds in one process.

    python3 -m avcbench.control --workload ipb.gop10 --seconds 10 \\
        --seeds 11 12 13 [--control]

Each seed runs the cell's window (``run.measure``) at its own size and
prints one JSON line of the numbers compared.  With ``--control`` the
program's planes are cut to 7-bit samples (the lowest bit cleared) before
they are judged: the nearest precision below the 8 bits the
configurations state, as a decoder that rounds its samples coarser would
give them.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .entries import ENTRIES, Entry
from .run import load_cell, log, measure


def lower_precision(entry: Entry) -> Entry:
    """`entry` with every sample of its planes cut to 7 bits."""
    def call(stream, timers):
        return [tuple(p & 0xFE for p in pic)
                for pic in entry.call(stream, timers)]

    return Entry(call, entry.steps, entry.fallbacks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m avcbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    _spec, _cell, folder, cfg, mix = load_cell(Path.cwd(), args.workload)
    for seed in args.seeds:
        entry = ENTRIES[mix["entry"]](mix, cfg, "cuda")
        if args.control:
            entry = lower_precision(entry)
        run, numbers = measure(folder, cfg, mix, seed, args.seconds, False,
                               "cuda", entry)
        log(f"seed {seed}: {numbers}")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "numbers": numbers,
                          "attempted": run.attempted, "frames": run.frames}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
