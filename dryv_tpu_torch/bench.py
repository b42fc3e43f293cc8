"""Benchmark of the port on one NVIDIA GPU: 1080p AVC intra decode,
frames/s per card.

    python -m dryv_tpu_torch.bench

Measures what the JAX package's root ``bench.py`` measures on one TPU,
through the port's own entry points, and prints ONE JSON line in that
script's shape (``metric``, ``value``, ``unit``, ``vs_baseline``,
``detail``).  Every phase is gated bit-exact before it is timed: the
single-thread baseline, the device reconstruction and the deblocked
device reconstruction against the stored ``.npz`` goldens, the
end-to-end decode and the 1080p I/P/B decodes against the libavcodec
oracle's digests (``testing.goldens``), and every timed end-to-end run
against the gated one.

- ``value``: the batched pipeline
  (``gop_pipeline.decode_annexb_gop_pipelined``, one CUDA-graph replay
  per batch of 16) over 8 copies of ``bench1080p_gop16.264`` (128
  distinct-content pictures) with the planes left on the card, the
  median of 5 timed runs, each ending in ``torch.cuda.synchronize()``.
- ``vs_baseline``: over the port's single-thread C++ full decode
  (``native.entropy`` with one thread + ``reconstruct_islices``) of
  ``bench1080p.264`` on the same host.
- ``device_recon_*``: F = 32 copies of ``bench1080p.264`` packed into
  one blob by the pipeline's own staging, shipped once, and the
  batched step (B1 densify, stage A, B2 intra wavefront) replayed K = 6
  times between CUDA events, best of 3; ``device_recon_deblock_fps_gop``
  the same on ``bench1080p_dblk.264`` with min(F, 16) copies and B3,
  K = 4.
- ``ipb_1080p_device_fps``: the packed I/P/B path
  (``device_ipb_packed.decode_annexb_device_packed``: B1, B4, B2, B3)
  on ``bench1080p_ipb.264``, timed in turns with the native C++ decode.

The command needs a card: without CUDA it exits non-zero and prints no
result.  The phase functions take their device, so the tests drive them
on the CPU (the kernels' plain versions) at a small size; ``main`` always
runs on "cuda".
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCHDATA = Path(__file__).resolve().parent.parent / "benchdata"
METRIC = "1080p_avc_intra_frames_per_sec_per_chip"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)


def parse_slices(stream):
    """The first picture's slices as (rbsp, bit offset, first_mb, slice
    QP), and the SPS and PPS, as the batched pipeline parses them."""
    from .gop_pipeline import _parse_pictures

    pics, sps, pps = _parse_pictures(stream)
    return pics[0][0], sps, pps


def best_of(f, n=5):
    """Least host seconds of n calls of f()."""
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def elapsed_s(fn, device):
    """Seconds of fn()'s work: between CUDA events on the card (the work
    enqueued by fn, after what was enqueued before has finished), by the
    host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def launches() -> dict:
    """The hand kernels' launch counters (a launch from a wrapper, a
    step's warm-up or its capture moves them; a replay does not)."""
    from .kernels.deblock import deblock
    from .kernels.densify import densify
    from .kernels.inter import mc_frame
    from .kernels.wavefront import intra_recon

    return {"densify": densify.launches,
            "intra_wavefront": intra_recon.launches,
            "deblock": deblock.launches, "inter_mc": mc_frame.launches}


def launched(before, keys, label, device) -> dict:
    """The launches since `before`; on the card, fail unless each kernel
    in `keys` launched."""
    got = {k: v - before[k] for k, v in launches().items()}
    if device.type == "cuda":
        missing = [k for k in keys if got[k] <= 0]
        if missing:
            raise RuntimeError(f"{label}: {missing} never launched")
    return got


def _crop(sps, y, cb, cr):
    from .decoder import DecodedFrame

    f = DecodedFrame(y, cb, cr).crop(sps)
    return f.y, f.cb, f.cr


# ---- host phases ----------------------------------------------------------

def baseline_fps(stream, golden, reps=5):
    """The port's single-thread C++ full decode of the stream's first
    picture (entropy with one thread + scalar reconstruction), gated by
    its golden (y, cb, cr); frames/s, best of `reps`."""
    from .native.entropy import decode_picture_islices, reconstruct_islices
    from .testing import goldens

    slice_datas, sps, pps = parse_slices(stream)

    def cpu_full():
        out = decode_picture_islices(slice_datas, sps, pps, n_threads=1)
        return reconstruct_islices(out, sps, pps)

    goldens.check("single-thread C++ decode", [_crop(sps, *cpu_full())],
                  [goldens.digest(*golden)])
    return 1.0 / best_of(cpu_full, reps)


def entropy_ms(stream, n_threads):
    """The C++ CABAC entropy stage on the stream's first picture with
    every host thread (best of 5) and with one (best of 3), reusing its
    output arena as the pipeline does; ms."""
    from .native.entropy import decode_picture_islices

    slice_datas, sps, pps = parse_slices(stream)
    t_all = best_of(lambda: decode_picture_islices(
        slice_datas, sps, pps, n_threads=n_threads, reuse=True), 5)
    t_one = best_of(lambda: decode_picture_islices(
        slice_datas, sps, pps, n_threads=1, reuse=True), 3)
    return t_all * 1e3, t_one * 1e3


def pack_ms(stream, n_threads):
    """``coeffs.pack_from_native`` of the first picture's entropy
    output; ms, best of 5."""
    from .coeffs import pack_from_native
    from .native.entropy import decode_picture_islices

    slice_datas, sps, pps = parse_slices(stream)
    out = decode_picture_islices(slice_datas, sps, pps, n_threads=n_threads)
    return best_of(lambda: pack_from_native(out, sps, pps), 5) * 1e3


def entropy_qp_sweep(streams, n_threads):
    """{"qp<q>_entropy_ms": ms} of the entropy stage (every thread, best
    of 3) on each stream's first picture; streams maps q to bytes."""
    from .native.entropy import decode_picture_islices

    out = {}
    for qp, stream in streams.items():
        sd, sps, pps = parse_slices(stream)
        out[f"qp{qp}_entropy_ms"] = best_of(lambda: decode_picture_islices(
            sd, sps, pps, n_threads=n_threads, reuse=True), 3) * 1e3
    return out


# ---- device phases --------------------------------------------------------

def device_recon(stream, golden, F, K, n_threads, device, rounds=3):
    """The batched device step on F copies of the stream's first picture:
    the blob (packed by ``gop_pipeline.BlobStaging`` as the pipeline
    packs a batch) shipped once, the step (``gop_pipeline.PackedGopDecoder``:
    B1, stage A, B2 and, on a deblocked stream, B3) captured by a
    ``graphs.StepCache`` of its own, its first replay's pictures gated
    by `golden` (y, cb, cr), then K replays timed (best of `rounds`).
    Returns a dict: s_per_gop (device seconds of one replay of F
    pictures), blob_bytes, launches (around the first call: warm-up and
    capture), pool_mib (the step's graph pool) and deblocked."""
    from .gop_pipeline import BlobStaging, PackedGopDecoder, _parse_pictures
    from .graphs import StepCache
    from .kernels.geometry import BLK, round_up
    from .testing import goldens
    from .utils.obs import StageTimers

    dev = torch.device(device)
    pics, sps, pps = _parse_pictures(stream)
    headers = pics[0][1]
    mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
    n = mb_w * mb_h
    # F copies of the picture in one blob, as the pipeline packs a batch
    staging = BlobStaging(F, round_up(n, BLK), n, pin=dev.type == "cuda",
                          slots=1)
    host = staging.pack(0, pics[:1] * F, sps, pps, n_threads, StageTimers())
    if host is None:
        raise ValueError("a PCM picture: the packed wire carries none")
    W, ecap, ovcap = staging.caps
    deblocked = any(h.deblocking is None or h.deblocking.disable_idc != 1
                    for h in headers)
    c0, c1 = pps.chroma_qp_index_offset, pps.second_chroma_qp_offset
    steps = StepCache(max_keys=1)
    key = (dev, mb_w, mb_h, F, deblocked, c0, c1, W, ecap, ovcap)
    before = launches()
    with steps.hold(key, lambda: functools.partial(
            PackedGopDecoder(mb_w, mb_h, F, deblocked, c0, c1, dev), W=W,
            ecap=ecap, ovcap=ovcap), [host], dev) as step:
        step.load(host)
        y, cb, cr = step()
        got = launched(before, ("densify", "intra_wavefront")
                       + (("deblock",) if deblocked else ()),
                       f"device recon x{F}", dev)
        goldens.check(f"device recon x{F}",
                      [_crop(sps, y[i], cb[i], cr[i]) for i in range(F)],
                      [goldens.digest(*golden)] * F)

        def replays():
            for _ in range(K):
                step()

        t = min(elapsed_s(replays, dev) for _ in range(rounds))
    pool = steps.pool_mib()
    for s in steps.steps.values():
        s.release()
    return {"s_per_gop": t / K, "blob_bytes": host.numel(),
            "launches": got, "pool_mib": pool, "deblocked": deblocked}


def hbm_bytes_per_frame(blob_bytes, F, mb_w, mb_h):
    """Bytes the device reconstruction must move per picture: its share
    of the shipped blob, read once, and its uncropped Y, Cb and Cr
    planes, written once."""
    return blob_bytes / F + 256 * mb_w * mb_h + 2 * 64 * mb_w * mb_h


def hbm_utilization(bytes_per_frame, ms_per_frame):
    """Share of the card's memory rate that moving bytes_per_frame in
    ms_per_frame takes; the bytes are a floor of what the device must
    move, so a share above 1 is a faulty measurement."""
    u = bytes_per_frame / (ms_per_frame / 1e3) / HBM_BYTES_PER_S
    if not 0 < u <= 1:
        raise RuntimeError(f"device_hbm_utilization {u} outside (0, 1]")
    return u


def e2e_decode(stream, device, n_threads, graph=True, timers=None,
               gop=16):
    """The end-to-end decode the headline times: the batched pipeline,
    planes left on the device (``stacked_out``), finished on the card."""
    from .gop_pipeline import decode_annexb_gop_pipelined

    out = decode_annexb_gop_pipelined(stream, gop=gop, n_threads=n_threads,
                                      device=device, stacked_out=True,
                                      timers=timers, graph=graph)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out


def _frames_of(batches):
    """Per-picture (y, cb, cr) of stacked batches, uncropped."""
    return [(y[i], cb[i], cr[i]) for y, cb, cr, nf in batches
            for i in range(nf)]


def end_to_end(stream, name, digests, device, n_threads, copies=8, runs=5):
    """One untimed decode of the stream gated picture by picture against
    the oracle digests (``goldens.check``), one warm decode of `copies`
    copies, then `runs` timed decodes of them, each picture of each
    equal to the gated decode's.  Returns a dict: fps per run in order,
    the pictures a run decodes, and the StageTimers and wall seconds of
    each run."""
    from .gop_pipeline import decode_annexb_gop_pipelined
    from .testing import goldens
    from .utils.obs import StageTimers

    dev = torch.device(device)
    _, sps, _ = parse_slices(stream)
    fallbacks = decode_annexb_gop_pipelined.fallback_calls
    gated = _frames_of(e2e_decode(stream, dev, n_threads))
    goldens.check(name, [_crop(sps, *f) for f in gated], digests)
    big = stream * copies
    e2e_decode(big, dev, n_threads)
    fps, timers, walls = [], [], []
    for _ in range(runs):
        tm = StageTimers()
        t0 = time.perf_counter()
        out = e2e_decode(big, dev, n_threads, timers=tm)
        wall = time.perf_counter() - t0
        frames = _frames_of(out)
        if len(frames) != copies * len(gated) or not all(
                torch.equal(a, b) for f, g in zip(
                    frames, gated * copies) for a, b in zip(f, g)):
            raise AssertionError("a timed end-to-end run differs from the "
                                 "gated one")
        fps.append(len(frames) / wall)
        timers.append(tm)
        walls.append(wall)
    if decode_annexb_gop_pipelined.fallback_calls != fallbacks:
        raise AssertionError("the end-to-end decode left the batched scope")
    return {"fps": fps, "frames": len(gated) * copies, "timers": timers,
            "walls": walls}


def e2e_summary(e2e):
    """value (median fps) and the detail keys of the end-to-end runs:
    runs, min, max, best (root ``bench.py``'s rule: the best of the first
    3 runs), the median run's stage ms per picture and its stage sum over
    wall."""
    fps = e2e["fps"]
    mid = sorted(range(len(fps)), key=fps.__getitem__)[len(fps) // 2]
    tm, wall = e2e["timers"][mid], e2e["walls"][mid]
    return statistics.median(fps), {
        "runs": len(fps), "min": min(fps), "max": max(fps),
        "best": max(fps[:3]),
        "e2e_stage_ms_per_frame": {k: v / e2e["frames"] * 1e3
                                   for k, v in tm.t.items()},
        "stage_sum_over_wall": sum(tm.t.values()) / wall}


def ipb_native_fps(stream, golden):
    """The native C++ I/P/B decode (deblocking on), gated by the golden
    frames (y, cb, cr); frames/s, best of 3."""
    from .native.full import decode_annexb_native
    from .testing import goldens

    got = decode_annexb_native(stream)
    goldens.check("native C++ I/P/B", [(f.y, f.cb, f.cr) for f in got],
                  [goldens.digest(*g) for g in golden])
    return len(got) / best_of(lambda: decode_annexb_native(stream), 3)


def ipb_1080p(stream, name, digests, device):
    """The native C++ decode and the packed device I/P/B path, each gated
    by the oracle digests, then timed in turns (native, device, device,
    native; best of 2 each).  Returns (native fps, device fps, the device
    path's launches around its first call)."""
    from .device_ipb_packed import decode_annexb_device_packed
    from .native.full import decode_annexb_native
    from .testing import goldens

    dev = torch.device(device)
    got = decode_annexb_native(stream)
    goldens.check(name, [(f.y, f.cb, f.cr) for f in got], digests)

    def native():
        decode_annexb_native(stream)

    host_calls = decode_annexb_device_packed.host_calls
    before = launches()
    gotd = decode_annexb_device_packed(stream, device=dev)
    n = launched(before, ("densify", "intra_wavefront", "deblock",
                          "inter_mc"), "device I/P/B", dev)
    if decode_annexb_device_packed.host_calls != host_calls:
        raise AssertionError("the device I/P/B decode fell back to the host")
    goldens.check(name, [(f.y, f.cb, f.cr) for f in gotd], digests)

    def device_ipb():
        decode_annexb_device_packed(stream, device=dev)

    t = {native: [], device_ipb: []}
    for f in (native, device_ipb, device_ipb, native):
        t[f].append(best_of(f, 1))
    return len(got) / min(t[native]), len(gotd) / min(t[device_ipb]), n


# ---- the run --------------------------------------------------------------

@dataclasses.dataclass
class Inputs:
    """The streams and goldens a run reads (a golden: (y, cb, cr) numpy
    planes; digests: ``goldens.digest`` per picture); ``benchdata()``
    gives the bench's own."""
    intra: bytes                 # bench1080p.264: baseline, entropy, recon
    intra_golden: tuple
    dblk: bytes                  # bench1080p_dblk.264: deblocked recon
    dblk_golden: tuple
    gop: bytes                   # bench1080p_gop16.264: the headline
    gop_name: str
    gop_digests: list
    ipb_small: bytes             # bench_ipb.264: native C++ I/P/B
    ipb_small_golden: list
    ipb: bytes                   # bench1080p_ipb.264: native vs device
    ipb_name: str
    ipb_digests: list
    qp_streams: dict             # QP -> stream: the entropy sweep

    @classmethod
    def benchdata(cls):
        from .testing import goldens

        def read(name):
            return (BENCHDATA / name).read_bytes()

        def npz(name):
            g = np.load(BENCHDATA / name)
            return tuple(g[k] for k in ("y", "cb", "cr"))

        g = np.load(BENCHDATA / "bench_ipb_golden.npz")
        ipb_small = [(g[f"f{i}_y"], g[f"f{i}_b"], g[f"f{i}_r"])
                     for i in range(len(g.files) // 3)]
        gop, ipb = "bench1080p_gop16.264", "bench1080p_ipb.264"
        return cls(read("bench1080p.264"), npz("bench1080p_golden.npz"),
                   read("bench1080p_dblk.264"),
                   npz("bench1080p_dblk_golden.npz"), read(gop), gop,
                   goldens.stored(gop), read("bench_ipb.264"), ipb_small,
                   read(ipb), ipb, goldens.stored(ipb),
                   {q: read(f"bench1080p_qp{q}.264") for q in (20, 40)})


def measure(inp, device, device_name, F, n_threads, copies=8, runs=5,
            log=print):
    """Every phase in root ``bench.py``'s order on `device`; returns the
    result dict (one JSON line's content).  `log` gets the lines that
    are not the result (launches, the graph pool)."""
    dev = torch.device(device)
    # host stages first, before anything touches the card
    baseline = baseline_fps(inp.intra, inp.intra_golden)
    ent_all, ent_one = entropy_ms(inp.intra, n_threads)
    recon = device_recon(inp.intra, inp.intra_golden, F, 6, n_threads, dev)
    log(f"device recon x{F}: launches at its first call (warm-up and "
        f"capture) {recon['launches']}, graph pool "
        f"{json.dumps(recon['pool_mib'])} MiB, blob {recon['blob_bytes']} "
        f"bytes")
    t_pack = pack_ms(inp.intra, n_threads)
    e2e = end_to_end(inp.gop, inp.gop_name, inp.gop_digests, dev, n_threads,
                     copies, runs)
    Fd = min(F, 16)
    dblk = device_recon(inp.dblk, inp.dblk_golden, Fd, 4, n_threads, dev)
    log(f"device recon, deblocked, x{Fd}: launches at its first call "
        f"{dblk['launches']}, graph pool {json.dumps(dblk['pool_mib'])} MiB")
    ipb_small = ipb_native_fps(inp.ipb_small, inp.ipb_small_golden)
    sweep = entropy_qp_sweep(inp.qp_streams, n_threads)
    ipb_native, ipb_dev, ipb_n = ipb_1080p(inp.ipb, inp.ipb_name,
                                           inp.ipb_digests, dev)
    log(f"device I/P/B: launches at its first call {ipb_n}")

    _, sps, _ = parse_slices(inp.intra)
    mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
    ms_frame = recon["s_per_gop"] / F * 1e3
    hbm_bytes = hbm_bytes_per_frame(recon["blob_bytes"], F, mb_w, mb_h)
    value, e2e_detail = e2e_summary(e2e)
    return {
        "metric": METRIC,
        "value": value,
        "unit": "frames/s",
        "vs_baseline": value / baseline,
        "detail": {
            "baseline_cpu_singlethread_fps": baseline,
            "entropy_ms_per_frame": ent_all,
            "entropy_ms_per_frame_1thread": ent_one,
            "pack_ms": t_pack,
            "device_recon_fps_gop": F / recon["s_per_gop"],
            "device_recon_ms_per_frame": ms_frame,
            "device_hbm_utilization": hbm_utilization(hbm_bytes, ms_frame),
            "device_hbm_bytes_per_frame": hbm_bytes,
            "device_recon_deblock_fps_gop": Fd / dblk["s_per_gop"],
            "gop_batch": F,
            "host_threads": n_threads,
            "device": device_name,
            "ipb_640x368_deblock_fps": ipb_small,
            "ipb_1080p_native_fps": ipb_native,
            "ipb_1080p_device_fps": ipb_dev,
            "entropy_qp_sweep": sweep,
            **e2e_detail,
            "graph_pool_mib_device_recon": recon["pool_mib"],
            "bit_exact": True,
            "note": (
                f"e2e = the port's batched pipeline (dryv_tpu_torch."
                f"gop_pipeline, one CUDA-graph replay per batch of 16) over "
                f"{e2e['frames']} pictures ({copies} x {inp.gop_name}), "
                f"median of {len(e2e['fps'])} runs, each equal to a run "
                f"gated against the libavcodec oracle's digests: header "
                f"parse + fused C++ entropy and pack + one pinned-blob "
                f"H2D + B1 densify, stage A and B2 intra wavefront on the "
                f"card, planes left there; device_recon = {F} copies of "
                f"one picture in one blob shipped once, the step's replays "
                f"timed by CUDA events; device_hbm_utilization = "
                f"device_hbm_bytes_per_frame (the blob's share + the output "
                f"planes) per device_recon_ms_per_frame over 3.35 TB/s; "
                f"vs_baseline over the port's single-thread C++ decode on "
                f"this host"),
        },
    }


def device_label():
    """The name of torch's card 0 and its power limit, as ``nvidia-smi``
    gives it for that card (matched by UUID: ``nvidia-smi`` numbers every
    card of the host, whatever ``CUDA_VISIBLE_DEVICES`` says); fails when
    ``nvidia-smi`` does or lists no such card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    uuid = str(torch.cuda.get_device_properties(0).uuid).lower()
    for row in smi.stdout.strip().splitlines():
        card, limit = (x.strip() for x in row.split(","))
        if card.lower().removeprefix("gpu-") == uuid.removeprefix("gpu-"):
            return f"{torch.cuda.get_device_name(0)}, {limit}"
    raise RuntimeError(f"nvidia-smi lists no card of UUID {uuid}: "
                       f"{smi.stdout!r}")


def main():
    """Run every phase on the card and print the result line; returns
    the result."""
    if not torch.cuda.is_available():
        raise SystemExit("dryv_tpu_torch.bench: torch.cuda.is_available() "
                         "is False; the benchmark measures the card and "
                         "does not run on the CPU")
    name = device_label()
    result = measure(Inputs.benchdata(), "cuda", name, 32,
                     os.cpu_count() or 1,
                     log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
