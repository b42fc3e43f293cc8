"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --compare DIR   # also time earlier B1 and B3

Builds the port's C++ host library (g++) and CUDA kernels (nvcc) from
the sources in this checkout, and holds each kernel against its plain
PyTorch version at the shapes its paths give it (1080p batches of 16
pictures, and of 1 for the per-picture path's intra wavefront and
deblock; one band of 120x17 MBs x 4 for the banded wavefront; densify
at W = 32, 96 and 256; deblock with every edge on and with random
slices and disable_deblocking_filter_idc), with a tolerance of 0: the
decoder is bit-exact.  Each kernel's bound is the bytes it must move
(each input read once, each output written once) over the card's
3.35 TB/s.  Then it drives each path of the port with the launch
counters set to 0 just before and read just after, and checks every
frame bit-exact against the native C++ decoder or a stored golden:

- the batched all-intra decode,
  ``gop_pipeline.decode_annexb_gop_pipelined`` (densify, intra
  wavefront, deblock);
- the per-picture path, ``pipeline.decode_annexb_fast`` (intra
  wavefront and deblock at F = 1), on the 1080p goldens and on
  encoder-made CAVLC and scaling-matrix pictures, which the batched
  pipeline must hand to it;
- the sharded decode, ``parallel`` (GOP-sharded, band-pipelined,
  band-sharded single frame, the dry run), on one card through meshes
  that repeat it.

It times the kernels, the end-to-end batched decode, the device span of
a batch of 16 deblocked pictures, the per-picture decode and the banded
pipeline beside the unbanded wavefront; a torch.profiler trace counts
the device kernels of one B2 and one B3 call.  With --compare DIR (a
directory holding an earlier tree's ``densify.cu`` and ``deblock.cu``
with the ``common.cuh`` they include, not part of the repo; their C
entries as they were before B3 took a scratch argument) it also builds
those kernels and times them and the current ones in turns (old, new,
new, old) at each shape.  Every timing line ends with the card's
``nvidia-smi`` name and power limit.  Any failure ends the run with a
non-zero exit and no result line.  The last line is {"ok": true,
"device": {...}}; the line before it holds the per-kernel JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

F = 16           # pictures per batch, as the benchmark runs
MB_W, MB_H = 120, 68
REPS = 5
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls (after one warm
    call), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def random_syntax(rng, mb_w, mb_h, F, below_band=False):
    """Random legal intra syntax, as tests/test_pallas_wavefront.py makes
    it: geometric availability, modes that read only available
    neighbours, residuals in [-300, 300], PCM included.  below_band:
    MB row 0 has neighbours above (a band below another band)."""
    n = mb_w * mb_h
    s = {
        "kind": rng.choice([0, 1, 2, 3], size=(F, n)).astype(np.int32),
        "i16_mode": rng.integers(0, 4, (F, n)).astype(np.int32),
        "chroma_mode": rng.integers(0, 4, (F, n)).astype(np.int32),
        "modes4": rng.integers(0, 9, (F, n, 16)).astype(np.int32),
        "modes8": rng.integers(0, 9, (F, n, 4)).astype(np.int32),
        "pcm_y": rng.integers(0, 256, (F, n, 256)).astype(np.int32),
        "pcm_c": rng.integers(0, 256, (F, n, 2, 8, 8)).astype(np.int32),
    }
    x = np.arange(n) % mb_w
    y = np.arange(n) // mb_w + (1 if below_band else 0)
    av = {"avail_a": x > 0, "avail_b": y > 0,
          "avail_c": (y > 0) & (x < mb_w - 1), "avail_d": (y > 0) & (x > 0)}
    for k, v in av.items():
        s[k] = np.broadcast_to(v, (F, n)).copy()
    a, b = s["avail_a"], s["avail_b"]
    for m in (s["modes4"], s["modes8"]):
        m[~b] = np.where(np.isin(m[~b], [0, 3, 7]), 2, m[~b])
        m[~a] = np.where(np.isin(m[~a], [1, 8]), 2, m[~a])
        m[~(a & b)] = np.where(np.isin(m[~(a & b)], [4, 5, 6]), 2,
                               m[~(a & b)])
    s["i16_mode"] = np.where(a & b, s["i16_mode"], 2).astype(np.int32)
    s["chroma_mode"] = np.where(a & b, s["chroma_mode"], 0).astype(np.int32)
    y_z = rng.integers(-300, 300, (F, n, 256)).astype(np.int32)
    c = rng.integers(-300, 300, (F, n, 2, 8, 8)).astype(np.int32)
    return s, y_z, c


def scaling_lists():
    """Custom scaling matrices, the recipe of the scal_* fixtures
    (dryv_tpu/testing/fixtures.py)."""
    from dryv_tpu_torch.avc.sps import ScalingLists

    rng = np.random.RandomState(7)
    l4 = np.stack([np.sort(np.clip(10 + rng.randint(-6, 26, 16), 1, 255))
                   for _ in range(6)]).astype(np.int32)
    l8 = np.stack([np.sort(np.clip(10 + rng.randint(-6, 38, 64), 1, 255))
                   for _ in range(6)]).astype(np.int32)
    return ScalingLists(l4, l8)


def encoder_stream(mb_w, mb_h, n_pics, qp=30, cabac=True, scaling=False):
    """Pictures from the repo's own intra encoder (no oracle needed):
    every MB kind including PCM, 8x8 transform, two MB rows per slice,
    deblocking on, chroma QP offset 2; CAVLC with cabac=False, an SPS
    scaling matrix with scaling=True."""
    from dryv_tpu_torch.encoder import default_sps_pps, encode_frame_annexb
    from dryv_tpu_torch.encoder.intra_encoder import IntraEncoder

    kinds = ["i8", "i4", "i16", "pcm"]
    out = b""
    for t in range(n_pics):
        rng = np.random.RandomState(t)
        W, H = 16 * mb_w, 16 * mb_h
        y = np.clip(rng.randint(0, 256, (H, W)) * 0.3
                    + np.linspace(0, 200, W)[None]
                    + np.linspace(0, 40, H)[:, None], 0, 255)
        cb = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 100,
                     0, 255)
        cr = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 80,
                     0, 255)
        sps, pps = default_sps_pps(mb_w, mb_h, qp=qp, transform_8x8=True,
                                   chroma_qp_offset=2, cabac=cabac)
        if scaling:
            sps.profile_idc = 100
            sps.seq_scaling_matrix_present_flag = 1
            sps.seq_scaling_lists = scaling_lists()
        enc = IntraEncoder(sps, pps, qp,
                           mb_kind_policy=lambda a, t=t: kinds[(a + t) % 4])
        mbs = enc.encode_frame(y.astype(np.int64), cb.astype(np.int64),
                               cr.astype(np.int64),
                               slice_bounds=list(range(0, mb_w * mb_h,
                                                       2 * mb_w)))
        out += encode_frame_annexb(sps, pps, 2, mbs, deblock_disable=0)
    return out


def bound_ms(*tensors):
    """Least time to move the tensors' bytes once at the card's rate."""
    return sum(t.numel() * t.element_size() for t in tensors) \
        / HBM_BYTES_PER_S * 1e3


# The C entries of the earlier kernels --compare builds: name, argument
# kinds ("p" pointer, "i" int; the stream follows), as the tree before
# this B3 had them.
OLD_ENTRIES = {"densify.cu": ("dt_densify", "pppii"),
               "deblock.cu": ("dt_deblock", "ppppiii")}


def old_kernels(src_dir):
    """Builds B1 and B3 of an earlier tree (``src_dir/densify.cu`` and
    ``deblock.cu``, each with the ``common.cuh`` beside it) into one
    library and returns {"densify": fn, "deblock": fn} with the current
    wrappers' arguments and results."""
    from pathlib import Path

    from dryv_tpu_torch import _build
    from dryv_tpu_torch._libbuild import build_library, library_path

    d = Path(src_dir).resolve()
    srcs = [d / name for name in OLD_ENTRIES]
    lib_path = library_path("libold_kernels", srcs + [d / "common.cuh"],
                            " ".join(_build.NVCC_FLAGS).encode())
    nvcc = _build._nvcc()
    build_library(lib_path, srcs,
                  lambda s, o: [nvcc, *_build.NVCC_FLAGS, "-c", str(s),
                                "-o", str(o)],
                  lambda objs, out: [nvcc, "-shared", *map(str, objs),
                                     "-o", str(out)])
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for entry, kinds in OLD_ENTRIES.values():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                       for k in kinds] + [ctypes.c_void_p]
        fns[entry] = fn

    def run(entry, *args):
        rc = fns[entry](*[a.data_ptr() if torch.is_tensor(a) else a
                          for a in args],
                        torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"earlier {entry}: CUDA error {rc}")

    def densify(bmp, vals):
        F, npad, _ = bmp.shape
        out = torch.empty((F, npad, 408), dtype=torch.int16,
                          device=bmp.device)
        run("dt_densify", bmp, vals, out, F * npad, vals.shape[-1])
        return out

    def deblock(prm, y, cb, cr, mb_w, mb_h):
        run("dt_deblock", prm, y, cb, cr, mb_w, mb_h, y.shape[0])
        return y, cb, cr

    return {"densify": densify, "deblock": deblock}


def kernel_launches_in_profile(fn, names):
    """For each of `names`, the device kernels whose name holds it in a
    torch.profiler trace of one fn() call; None when the profiler
    records no device time.  (One session per process: a second one
    records no device events.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    return {n: sum(1 for e in evs if n in e.name) for n in names}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", metavar="DIR",
                    help="time earlier B1 and B3 (DIR/densify.cu, "
                         "DIR/deblock.cu) in turns with the current ones")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    from dryv_tpu_torch import _build, gop_pipeline, parallel
    from dryv_tpu_torch.decoder import DecodedFrame
    from dryv_tpu_torch.gop_pipeline import (PackedGopDecoder,
                                             decode_annexb_gop_pipelined)
    from dryv_tpu_torch.kernels.deblock import (deblock, deblock_plain,
                                                deblock_precompute_intra,
                                                pack_params)
    from dryv_tpu_torch.kernels.densify import densify, densify_plain
    from dryv_tpu_torch.kernels.wavefront import (intra_recon,
                                                  intra_recon_plain,
                                                  recon_inputs)
    from dryv_tpu_torch.native import build as host_build
    from dryv_tpu_torch.native.full import decode_annexb_native
    from dryv_tpu_torch.pipeline import (decode_annexb_fast,
                                         frames_from_stream, recon_syntax,
                                         tables_for)
    from dryv_tpu_torch.syntax import stack_frames, syntax_tensors
    from dryv_tpu_torch.tables import decoder_tables
    from dryv_tpu_torch.utils.obs import StageTimers

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}")

    # ---- phase 2: build the host library and every kernel from the
    # checkout's sources
    t0 = time.perf_counter()
    print(f"host library: {host_build.build(force=True).name}")
    print(f"build: C++ host library {time.perf_counter() - t0:.2f} s "
          f"(g++, one process per source)  [{card}]")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    print(f"build: CUDA kernels {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a, one process per source)  [{card}]")
    old = None
    if args.compare:
        t0 = time.perf_counter()
        old = old_kernels(args.compare)
        print(f"build: earlier B1 and B3 from {args.compare} "
              f"{time.perf_counter() - t0:.2f} s  [{card}]")

    tables = decoder_tables(dev)
    rng = np.random.default_rng(2024)
    kernels = {}

    def report(label, err, ms, plain_ms, bound):
        print(f"kernel {label}: max_abs_err {err} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound:.4f} ms "
              f"({bound / ms:.2%} of it)  [{card}]")
        if err != 0:
            fail(f"{label} differs from its plain version (max {err})")

    def record(key, route_src, replaces, err, ms, plain_ms, bound):
        kernels[key] = {"name": key, "route": "cuda", "source": route_src,
                        "replaces": replaces, "launches": None,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes",
                        "library_ms": None}
        report(key, err, ms, plain_ms, bound)

    def max_err(got, want):
        return max(int((a.int() - b.int()).abs().max())
                   for a, b in zip(got, want))

    def in_turns(label, what, time_old, time_new, reps):
        """Earlier and current kernel timed old, new, new, old."""
        t = [f() for f in (time_old, time_new, time_new, time_old)]
        print(f"{label}, CUDA events, mean of {reps}, in turns: earlier "
              f"{what} {t[0]:.4f} / {t[3]:.4f} ms, this {what} {t[1]:.4f} "
              f"/ {t[2]:.4f} ms; bit-exact to each other  [{card}]")

    # ---- phase 3: each kernel against its plain version ---------------
    # B1 at the wire's shape (16 pictures x 8192 MB rows) at three value
    # strides, each with rows of 0, W, W + 1 and 408 values
    npad = 8192
    for W in (32, 96, 256):
        counts = rng.integers(0, 409, (F, npad, 1))
        counts[:, :4, 0] = [0, W, W + 1, 408]
        bits = rng.random((F, npad, 408)) * 408 < counts
        bmp = torch.from_numpy(np.packbits(bits, axis=-1,
                                           bitorder="little")).to(dev)
        vals = torch.from_numpy(rng.integers(-127, 128, (F, npad, W))
                                .astype(np.int8)).to(dev)
        out_k = densify(bmp, vals)
        err = int((out_k.int() - densify_plain(bmp, vals).int()).abs().max())
        ms = cuda_ms(lambda: densify(bmp, vals), 20)
        plain = cuda_ms(lambda: densify_plain(bmp, vals), 5)
        bound = bound_ms(bmp, vals, out_k)
        if W == 96:
            record("densify", "dryv_tpu_torch/csrc/densify.cu",
                   "dryv_tpu/kernels/densify.py:38", err, ms, plain, bound)
        else:
            report(f"densify at W = {W}", err, ms, plain, bound)
        if old:
            if not torch.equal(old["densify"](bmp, vals), out_k):
                fail(f"densify W={W}: the earlier B1 and the current differ")
            in_turns(f"densify bmp [{F}, {npad}, 51] vals [{F}, {npad}, "
                     f"{W}]", "B1",
                     lambda: cuda_ms(lambda: old["densify"](bmp, vals), 20),
                     lambda: cuda_ms(lambda: densify(bmp, vals), 20), 20)

    # B2 at the batched path's shape (F = 16) and the per-picture path's
    # (F = 1); B2b at one band of 17 MB rows x 4 pictures below another
    # band, its halo the bottom luma row and chroma rows of the band
    # above, taken from the 1080p golden picture
    BR, FB = 17, 4
    gold = np.load("benchdata/bench1080p_golden.npz")
    hy = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        gold["y"][16 * BR - 1], (FB, 16 * MB_W)))).to(dev)
    hc = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        np.stack([gold["cb"][8 * BR - 1], gold["cr"][8 * BR - 1]]),
        (FB, 2, 8 * MB_W)))).to(dev)
    b2_cases = {}
    recon = {}
    for key, rows, nf, halo in (("intra_wavefront", MB_H, F, None),
                                ("intra_wavefront_f1", MB_H, 1, None),
                                ("intra_wavefront_banded", BR, FB,
                                 (hy, hc))):
        s_np, yz_np, c_np = random_syntax(rng, MB_W, rows, nf,
                                          below_band=halo is not None)
        s = {k: torch.from_numpy(v).to(dev) for k, v in s_np.items()}
        inputs = recon_inputs(s, torch.from_numpy(yz_np).to(dev),
                              torch.from_numpy(c_np).to(dev))
        b2_cases[key] = (inputs, rows, halo)
        got = intra_recon(*inputs, tables, MB_W, rows, halo=halo)
        want = intra_recon_plain(*inputs, tables, MB_W, rows, halo)
        err = max_err(got, want)
        if halo is not None:
            zero = intra_recon(*inputs, tables, MB_W, rows,
                               halo=(hy * 0, hc * 0))
            if all(torch.equal(a, b) for a, b in zip(got, zero)):
                fail("intra_wavefront_banded: the halo changed no sample")
        else:
            recon[nf] = (s["kind"], got)
        ms = cuda_ms(lambda: intra_recon(*inputs, tables, MB_W, rows,
                                         halo=halo), 10)
        plain = cuda_ms(lambda: intra_recon_plain(*inputs, tables, MB_W,
                                                  rows, halo), 2)
        bound = bound_ms(*inputs, *got, *(halo or ()))
        if key == "intra_wavefront_f1":
            report("intra_wavefront at F = 1 (the per-picture path's "
                   "shape)", err, ms, plain, bound)
        else:
            record(key, "dryv_tpu_torch/csrc/intra_wavefront.cu",
                   "dryv_tpu/kernels/pallas_wavefront.py:140", err, ms,
                   plain, bound)

    # where B2's time goes: the same F = 1 picture with every MB of one
    # kind (PCM predicts nothing, so its time is the schedule's: flag
    # hand-offs, barriers, loads and stores)
    inputs1 = b2_cases["intra_wavefront_f1"][0]
    by_kind = {}
    for kname, kind in (("PCM", 3), ("I16", 2), ("I8", 1), ("I4", 0)):
        meta_k = inputs1[0].clone()
        meta_k[..., 0] = kind
        inp = (meta_k, *inputs1[1:])
        err = max_err(intra_recon(*inp, tables, MB_W, MB_H),
                      intra_recon_plain(*inp, tables, MB_W, MB_H))
        if err:
            fail(f"intra_wavefront, all {kname}: differs (max {err})")
        by_kind[kname] = cuda_ms(lambda: intra_recon(*inp, tables, MB_W,
                                                     MB_H), 10)
    print(f"intra_wavefront at F = 1 with every MB one kind, bit-exact, "
          f"CUDA events, mean of 10: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in by_kind.items())
          + f"  [{card}]")

    # B3 on B2's planes at F = 16 (batched path) and F = 1 (per-picture
    # path), with two parameter sets: every edge on (one slice, random
    # QPs and filter offsets), and sorted random slice ids with a random
    # disable_deblocking_filter_idc 0/1/2 per MB (slice edges with bS 0,
    # whole MBs left unfiltered)
    n = MB_W * MB_H

    def b3_params(kind, slices):
        nf = kind.shape[0]
        qp = torch.from_numpy(rng.integers(10, 52, (nf, n))).to(dev)
        offs = torch.from_numpy(2 * rng.integers(-3, 4, (nf, 1))
                                .repeat(n, 1)).to(dev)
        if slices:
            sid = torch.from_numpy(np.sort(rng.integers(0, 9, (nf, n)),
                                           axis=1)).to(dev)
            dis = torch.from_numpy(rng.integers(0, 3, (nf, n))).to(dev)
        else:
            sid = dis = torch.zeros((nf, n), dtype=torch.int32, device=dev)
        return pack_params(deblock_precompute_intra(
            kind, qp, sid, dis, offs, -offs, MB_W, MB_H, 1, -2, tables))

    def fresh_ms(fn, prm, planes, reps=10, geom=(MB_W, MB_H)):
        """Mean device ms of fn(prm, *planes, *geom) on fresh copies of
        the planes (B3 filters in place), by CUDA events around each
        call."""
        tot = 0.0
        for i in range(reps + 1):
            ps = [p.clone() for p in planes]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(prm, *ps, *geom)
            b.record()
            torch.cuda.synchronize()
            tot += a.elapsed_time(b) if i else 0.0
        return tot / reps

    b3_cases = {}
    for key, nf in (("deblock", F), ("deblock_f1", 1)):
        kind, planes = recon[nf]
        for slices in (False, True):
            prm = b3_params(kind, slices)
            dk = deblock(prm, *[p.clone() for p in planes], MB_W, MB_H)
            dp = deblock_plain(prm, *planes, MB_W, MB_H)
            err = max_err(dk, dp)
            changed = [int((a != b).sum()) for a, b in zip(dk, planes)]
            if min(changed) == 0:
                fail(f"{key}: the check filtered nothing in a plane")
            ms = fresh_ms(deblock, prm, planes)
            if not slices:
                b3_cases[key] = (prm, planes)
                record(key, "dryv_tpu_torch/csrc/deblock.cu",
                       "dryv_tpu/kernels/pallas_deblock.py:93", err, ms,
                       cuda_ms(lambda: deblock_plain(prm, *planes, MB_W,
                                                     MB_H), 2),
                       bound_ms(prm, *planes, *dk))
            else:
                print(f"kernel {key} (F = {nf}) with random slices and "
                      f"idc 0/1/2: max_abs_err {err}, changed "
                      f"{changed} samples (y, cb, cr), kernel {ms:.4f} ms"
                      f"  [{card}]")
                if err:
                    fail(f"{key} with random slices differs (max {err})")
        if old:
            prm, planes = b3_cases[key]
            if max_err(old["deblock"](prm, *[p.clone() for p in planes],
                                      MB_W, MB_H),
                       deblock(prm, *[p.clone() for p in planes], MB_W,
                               MB_H)):
                fail(f"{key}: the earlier B3 and the current differ")
            in_turns(f"{key} ({MB_W}x{MB_H} MBs x {nf})", "B3",
                     lambda: fresh_ms(old["deblock"], prm, planes),
                     lambda: fresh_ms(deblock, prm, planes), 10)

    # where B3's time goes: the F = 1 picture with the bS of some edge
    # directions set to 0 (no edge filtered: the schedule, loads and
    # stores alone)
    prm1, planes1 = b3_cases["deblock_f1"]
    by_dir = {}
    for label, cols in (("no edge", (0, 40, 80, 136)),
                        ("vertical only", (40, 136)),
                        ("horizontal only", (0, 80)), ("every edge", ())):
        prm_d = prm1.clone()
        for c0 in cols:
            prm_d[..., c0:c0 + 16] = 0
        err = max_err(deblock(prm_d, *[p.clone() for p in planes1], MB_W,
                              MB_H),
                      deblock_plain(prm_d, *planes1, MB_W, MB_H))
        if err:
            fail(f"deblock_f1 with {label} on: differs (max {err})")
        by_dir[label] = fresh_ms(deblock, prm_d, planes1)
    print(f"deblock at F = 1 with the bS of some edges set to 0, "
          f"bit-exact, CUDA events, mean of 10: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in by_dir.items())
          + f"  [{card}]")
    # the two chains of the schedule apart: MB row 0 alone (120 MB steps
    # of one walker, no waits) and MB column 0 alone (68 rows, each
    # waiting on the one above), every edge on and none
    y1, cb1, cr1 = planes1
    for label, gw, gh, prm_g, pl_g in (
            ("one MB row (120x1)", MB_W, 1, prm1[:, :MB_W],
             (y1[:, :16], cb1[:, :8], cr1[:, :8])),
            ("one MB column (1x68)", 1, MB_H, prm1[:, ::MB_W],
             (y1[..., :16], cb1[..., :8], cr1[..., :8]))):
        prm_g = prm_g.contiguous()
        pl_g = [p.contiguous() for p in pl_g]
        prm_0 = prm_g.clone()
        for c0 in (0, 40, 80, 136):
            prm_0[..., c0:c0 + 16] = 0
        t = []
        for pr in (prm_g, prm_0):
            err = max_err(deblock(pr, *[p.clone() for p in pl_g], gw, gh),
                          deblock_plain(pr, *pl_g, gw, gh))
            if err:
                fail(f"deblock on {label} differs (max {err})")
            t.append(fresh_ms(deblock, pr, pl_g, geom=(gw, gh)))
        print(f"deblock at F = 1 on {label}, bit-exact, CUDA events, mean "
              f"of 10: every edge {t[0]:.4f} ms, no edge {t[1]:.4f} ms  "
              f"[{card}]")

    # one B2 or B3 call is one launch on the device
    names = ("intra_rows_kernel", "deblock_rows_kernel")
    n_prof = kernel_launches_in_profile(
        lambda: ([intra_recon(*inputs, tables, MB_W, rows, halo=halo)
                  for inputs, rows, halo in b2_cases.values()],
                 [deblock(prm, *[p.clone() for p in planes], MB_W, MB_H)
                  for prm, planes in b3_cases.values()]), names)
    print(f"device kernels in a torch.profiler trace of {len(b2_cases)} B2 "
          f"calls ({', '.join(b2_cases)}) and {len(b3_cases)} B3 calls "
          f"({', '.join(b3_cases)}): "
          f"{'not measured' if n_prof is None else n_prof}")
    if n_prof is not None and (n_prof[names[0]] != len(b2_cases)
                               or n_prof[names[1]] != len(b3_cases)):
        fail("a B2 or B3 call launched other than one kernel")

    # ---- phases 4-6: the main path, bit-exact, counted ----------------
    nthreads = os.cpu_count() or 1
    gop_stream = open("benchdata/bench1080p_gop16.264", "rb").read()
    checks = [("bench1080p_gop16.264", gop_stream, "native C++")]
    for stem in ("bench1080p_qp20", "bench1080p_qp40"):
        checks.append((f"{stem}.264",
                       open(f"benchdata/{stem}.264", "rb").read(),
                       "native C++"))
    for stem in ("bench1080p", "bench1080p_dblk"):
        checks.append((f"{stem}.264",
                       open(f"benchdata/{stem}.264", "rb").read(),
                       f"{stem}_golden.npz"))
    checks.append(("encoder pictures (PCM/I4/I8/I16, 2-row slices, "
                   "deblocked)", encoder_stream(8, 6, 5), "native C++"))
    refs = []
    for label, stream, against in checks:
        if against == "native C++":
            refs.append([(r.y, r.cb, r.cr) for r in
                         decode_annexb_native(stream, n_threads=nthreads)])
        else:
            g = np.load(f"benchdata/{against}")
            refs.append([(g["y"], g["cb"], g["cr"])])
    def reset_counts():
        densify.launches = deblock.launches = 0
        intra_recon.launches = intra_recon.banded_launches = 0
        decode_annexb_gop_pipelined.fallback_calls = 0
        decode_annexb_fast.host_calls = 0

    def counts():
        return {"densify": densify.launches,
                "intra_wavefront": intra_recon.launches,
                "intra_wavefront_banded": intra_recon.banded_launches,
                "deblock": deblock.launches,
                "fallback_calls": decode_annexb_gop_pipelined.fallback_calls,
                "host_calls": decode_annexb_fast.host_calls}

    def check_frames(label, got, ref, against):
        """got: DecodedFrames; ref: (y, cb, cr) per frame."""
        if len(got) != len(ref):
            fail(f"{label}: port decoded {len(got)} of {len(ref)} frames")
        for i, (g, r) in enumerate(zip(got, ref)):
            if not all(np.array_equal(a, b)
                       for a, b in zip((g.y, g.cb, g.cr), r)):
                fail(f"{label} frame {i} differs from {against}")
        print(f"{label}: {len(got)}/{len(ref)} frames bit-exact vs "
              f"{against}")

    def need(path, c, keys, report=None):
        """Fail unless every kernel in keys launched on the path; the
        kernel lines in `report` (line -> counter) take their launch
        count from this path."""
        print(f"launches on the {path}: {c}")
        for k in keys:
            if c[k] <= 0:
                fail(f"kernel {k} never launched on the {path}")
        for line, k in (report or {}).items():
            kernels[line]["launches"] = c[k]

    reset_counts()
    for (label, stream, against), ref in zip(checks, refs):
        check_frames(label, decode_annexb_gop_pipelined(
            stream, gop=F, n_threads=nthreads, device=dev), ref, against)
    c = counts()
    need("main path", c, ("densify", "intra_wavefront", "deblock"),
         report={k: k for k in ("densify", "intra_wavefront", "deblock")})
    if c["fallback_calls"] != 0:
        fail("the main path left the batched scope")

    # ---- phase 7: end-to-end timing --------------------------------------
    B = 8
    big = gop_stream * B
    warm = decode_annexb_gop_pipelined(big, gop=F, n_threads=nthreads,
                                       device=dev, stacked_out=True)
    torch.cuda.synchronize()
    ref_y = torch.from_numpy(np.stack([r[0] for r in refs[0]])).to(dev)
    for y, _cb, _cr, nf in warm:
        if not torch.equal(y[:nf, :1080], ref_y[:nf]):
            fail("timed-stream batch differs from the native decode")
    fps, ratios, stage_ms = [], [], {}
    for _ in range(REPS):
        tm = StageTimers()
        t0 = time.perf_counter()
        decode_annexb_gop_pipelined(big, gop=F, n_threads=nthreads,
                                    device=dev, stacked_out=True, timers=tm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fps.append(B * 16 / wall)
        ratios.append(sum(tm.t.values()) / wall)
        stage_ms = {k: round(v / (B * 16) * 1e3, 3) for k, v in tm.t.items()}
    med = statistics.median(fps)
    print(f"e2e bench1080p_gop16 x{B} (stacked device output, "
          f"n_threads={nthreads}): median {med:.2f} fps, min {min(fps):.2f}"
          f", max {max(fps):.2f} over {REPS} runs  [{card}]")
    print(f"e2e stage ms/frame (last run): {json.dumps(stage_ms)}; "
          f"stage sum / wall: median {statistics.median(ratios):.3f}  "
          f"[{card}]")
    tm = StageTimers()
    t0 = time.perf_counter()
    host = decode_annexb_gop_pipelined(big, gop=F, n_threads=nthreads,
                                       device=dev, timers=tm)
    wall = time.perf_counter() - t0
    print(f"e2e host-frame output: {len(host) / wall:.2f} fps, stage sum "
          f"/ wall {sum(tm.t.values()) / wall:.3f}  [{card}]")

    def forward_spans(stream):
        """Decode `stream` through the batched pipeline (stacked device
        output) with CUDA events recorded around each batch's
        PackedGopDecoder.forward (nothing synchronises inside the run);
        returns (output, device ms per batch, wall s)."""
        spans = []
        forward = PackedGopDecoder.forward

        def timed_forward(self, *args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = forward(self, *args)
            e1.record()
            spans.append((e0, e1))
            return out

        PackedGopDecoder.forward = timed_forward
        try:
            t0 = time.perf_counter()
            out = decode_annexb_gop_pipelined(stream, gop=F,
                                              n_threads=nthreads, device=dev,
                                              stacked_out=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            PackedGopDecoder.forward = forward
        return out, [a.elapsed_time(b) for a, b in spans], wall

    _, spans, wall = forward_spans(big)
    busy = sum(spans)
    print(f"device span of the batch stage: {busy / len(spans):.3f} ms per "
          f"batch of {F}, {busy / 1e3 / wall:.4f} of the {wall:.3f} s wall "
          f"[{card}]")

    # one batch of 16 deblocked pictures: bench1080p_dblk.264 x 16, so
    # that B3 runs at the batched path's shape on a real picture
    dblk = open("benchdata/bench1080p_dblk.264", "rb").read() * F
    gd = np.load("benchdata/bench1080p_dblk_golden.npz")
    want = [torch.from_numpy(gd[k]).to(dev) for k in ("y", "cb", "cr")]

    def dblk_batch(b3):
        """Device ms of the deblocked batch with `b3` as the pipeline's
        deblock; every frame checked against the golden."""
        gop_pipeline.deblock = b3
        try:
            out, sp, _ = forward_spans(dblk)
        finally:
            gop_pipeline.deblock = deblock
        if len(out) != 1 or out[0][3] != F:
            fail("bench1080p_dblk x 16 did not decode as one batch of 16")
        y, cb, cr, _ = out[0]
        for got, w in zip((y, cb, cr), want):
            if not torch.equal(got[:, :w.shape[0], :w.shape[1]],
                               w.expand(F, *w.shape)):
                fail("deblocked batch differs from "
                     "bench1080p_dblk_golden.npz")
        return sp[0]

    reset_counts()
    dspans = [dblk_batch(deblock) for _ in range(3)]
    c = counts()
    print(f"device span of one batch of {F} deblocked pictures "
          f"(bench1080p_dblk.264 x {F}, every frame bit-exact vs "
          f"bench1080p_dblk_golden.npz), CUDA events, 3 runs: "
          f"{', '.join(f'{v:.3f}' for v in dspans)} ms; launches {c}  "
          f"[{card}]")
    if c["deblock"] != 3 or c["fallback_calls"]:
        fail("the deblocked batch did not run B3 once per batch")
    if old:
        t = [statistics.mean(dblk_batch(b3) for _ in range(3))
             for b3 in (old["deblock"], deblock, deblock, old["deblock"])]
        print(f"device span of the deblocked batch, mean of 3 runs, in "
              f"turns: earlier B3 "
              f"{t[0]:.3f} / {t[3]:.3f} ms, this B3 {t[1]:.3f} / "
              f"{t[2]:.3f} ms; every frame bit-exact  [{card}]")

    # ---- phase 8: the per-picture path (CAVLC, scaling matrices) -------
    pp_checks = []
    for stem in ("bench1080p", "bench1080p_dblk"):
        g = np.load(f"benchdata/{stem}_golden.npz")
        pp_checks.append((f"per-picture {stem}.264",
                          open(f"benchdata/{stem}.264", "rb").read(),
                          [(g["y"], g["cb"], g["cr"])],
                          f"{stem}_golden.npz"))
    cavlc = encoder_stream(8, 6, 3, cabac=False)
    scal = encoder_stream(8, 6, 3, scaling=True)
    for label, stream in (("CAVLC", cavlc), ("SPS scaling-matrix", scal)):
        pp_checks.append((f"per-picture encoder {label} pictures (8x6 MBs,"
                          f" PCM/I4/I8/I16, deblocked)", stream,
                          [(r.y, r.cb, r.cr) for r in decode_annexb_native(
                              stream, n_threads=nthreads)], "native C++"))
    reset_counts()
    for label, stream, ref, against in pp_checks:
        check_frames(label, decode_annexb_fast(stream, n_threads=nthreads,
                                               device=dev), ref, against)
    c = counts()
    need("per-picture path", c, ("intra_wavefront", "deblock"),
         report={"deblock_f1": "deblock"})
    if c["host_calls"] != 0:
        fail("the per-picture path sent a stream to the host decoder")

    reset_counts()
    check_frames("batched pipeline on the CAVLC pictures",
                 decode_annexb_gop_pipelined(cavlc, gop=F,
                                             n_threads=nthreads, device=dev),
                 pp_checks[2][2], "native C++")
    c = counts()
    print(f"launches, CAVLC through the batched pipeline: {c}")
    if (c["fallback_calls"] != 1 or c["host_calls"] != 0
            or c["intra_wavefront"] <= 0 or c["deblock"] <= 0):
        fail("the batched pipeline did not hand the CAVLC stream to the "
             "per-picture device path")

    fps = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = decode_annexb_fast(gop_stream, n_threads=nthreads, device=dev)
        fps.append(len(got) / (time.perf_counter() - t0))
    check_frames("per-picture bench1080p_gop16.264 (timed)", got, refs[0],
                 "native C++")
    print(f"per-picture decode_annexb_fast bench1080p_gop16 (host frames): "
          f"median {statistics.median(fps):.2f} fps, min {min(fps):.2f}, "
          f"max {max(fps):.2f} over 3 runs  [{card}]")

    # ---- phase 9: the sharded paths on one card -------------------------
    frames, gsps = frames_from_stream(gop_stream, n_threads=nthreads)

    def check_planes(label, planes, ref):
        check_frames(label, [DecodedFrame(*p).crop(gsps) for p in planes],
                     ref, "native C++")

    reset_counts()
    n_cards = torch.cuda.device_count()
    meshes = [["cuda:0"] * 2] + ([[f"cuda:{i}" for i in range(n_cards)]]
                                 if n_cards > 1 else [])
    for devs in meshes:
        planes = parallel.decode_gop_sharded(
            frames, parallel.make_mesh({"gop": len(devs)}, devs))
        check_planes(f"decode_gop_sharded over {devs}",
                     list(zip(*planes)), refs[0])
    run4 = parallel.make_banded_gop_fn(
        parallel.make_mesh({"band": 4}, ["cuda:0"] * 4), MB_W, MB_H, 16,
        Fi=4)
    check_planes("make_banded_gop_fn, 4 bands of 17 MB rows, Fi=4",
                 list(zip(*run4(frames))), refs[0])
    run3 = parallel.make_banded_frame_fn(
        parallel.make_mesh({"band": 3}, ["cuda:0"] * 3), MB_W, MB_H)
    check_planes("make_banded_frame_fn, 3 bands (23/23/22 MB rows)",
                 [run3(frames[0])], refs[0][:1])
    parallel.dryrun_multichip(4, ["cuda:0"] * 4, stream=gop_stream,
                              n_threads=nthreads)
    need("sharded paths", counts(),
         ("intra_wavefront", "intra_wavefront_banded"),
         report={"intra_wavefront_banded": "intra_wavefront_banded"})

    # device span of stage A + wavefront over the 16 pictures, syntax
    # already on the card: banded pipeline (4 bands on one card) beside
    # the unbanded B2
    syn = syntax_tensors(stack_frames(frames), dev)
    band_syn = run4.upload(frames)
    tabs = tables_for(dev)

    def unbanded():
        return recon_syntax(syn, tabs, MB_W, MB_H)

    def banded():
        return run4.reconstruct(band_syn, device_out=True)

    if not all(torch.equal(a, b) for a, b in zip(banded(), unbanded())):
        fail("banded pipeline differs from the unbanded wavefront")

    def span_ms(fn, reps=3):
        """Mean (device span by CUDA events, host time to enqueue) ms."""
        fn()
        torch.cuda.synchronize()
        tot = host = 0.0
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
            b.record()
            torch.cuda.synchronize()
            tot += a.elapsed_time(b)
        return tot / reps, host * 1e3 / reps

    times = [span_ms(f) for f in (unbanded, banded, banded, unbanded)]
    print(f"device span (host enqueue), 16 pictures of bench1080p_gop16, "
          f"stage A + wavefront, CUDA events, mean of 3: unbanded B2 "
          f"{times[0][0]:.3f} ({times[0][1]:.3f}) / {times[3][0]:.3f} "
          f"({times[3][1]:.3f}) ms, banded pipeline 4 bands Fi=4 "
          f"{times[1][0]:.3f} ({times[1][1]:.3f}) / {times[2][0]:.3f} "
          f"({times[2][1]:.3f}) ms  [{card}]")

    for k, v in kernels.items():
        if not v["launches"]:
            fail(f"kernel {k} launched on no driven path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
