"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --compare DIR   # also time earlier B1 and B3

Builds the port's C++ host library (g++) and CUDA kernels (nvcc) from
the sources in this checkout, and holds each kernel against its plain
PyTorch version at the shapes its paths give it (1080p batches of 16
pictures, and of 1 for the per-picture and I/P/B paths' intra wavefront
and deblock and the I/P/B path's densify; one band of 120x17 MBs x 4
for the banded wavefront; densify at W = 32, 96 and 256; deblock with every edge on, with random
slices and disable_deblocking_filter_idc, and on inter edge parameters;
motion compensation at 120x68 MBs over stacks of 3 pictures, P and B,
weighted prediction 0/1/2, local and far vectors), with a tolerance of
0: the decoder is bit-exact.  Each kernel's bound is the larger of the
bytes it must move (each input read once, each output written once)
over the card's 3.35 TB/s and, for motion compensation, the integer
operations its inputs need over the card's int32 rate (64 a clock per
SM, at its SM count and its maximum SM clock).  Then it drives each path of
the port with the launch counters set to 0 just before and read just
after, and checks every frame bit-exact against the native C++ decoder
or a stored golden:

- the batched all-intra decode,
  ``gop_pipeline.decode_annexb_gop_pipelined`` (densify, intra
  wavefront, deblock);
- the per-picture path, ``pipeline.decode_annexb_fast`` (intra
  wavefront and deblock at F = 1), on the 1080p goldens and on
  encoder-made CAVLC and scaling-matrix pictures, which the batched
  pipeline must hand to it;
- the sharded decode, ``parallel`` (GOP-sharded, band-pipelined,
  band-sharded single frame, the dry run), on one card through meshes
  that repeat it;
- the packed I/P/B path, ``device_ipb_packed.decode_annexb_device_packed``
  (densify, motion compensation, intra wavefront and deblock at F = 1),
  on ``bench_ipb.264`` and ``bench1080p_ipb.264``;
- banded P recon, ``parallel.make_banded_p_recon_fn``, against motion
  compensation on the whole plane, on meshes of one card and of several.

It times the kernels, the end-to-end batched decode, the device span of
a batch of 16 deblocked pictures, the per-picture decode, the banded
pipeline beside the unbanded wavefront, and the 1080p I/P/B decode
beside the native C++ decode with its device span per picture; a
torch.profiler trace counts the device kernels of one B2, B3 and B4
call.  With --compare DIR (a
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
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

F = 16           # pictures per batch, as the benchmark runs
MB_W, MB_H = 120, 68
REPS = 5
SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's ~2 GHz SM clock
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
# 32-bit integer add, shift, compare, min/max and logic results per clock
# per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# "Arithmetic Instructions" throughput table); times the card's SM count
# and maximum SM clock it gives B4's operations rate, ~16.7 T/s on an
# H100 SXM (132 SMs, 1980 MHz)
INT32_OPS_PER_CLOCK_PER_SM = 64
# integer operations of one 4x4 luma block's quarter-pel prediction by
# phase 4*fy + fx: a 6-tap value with its rounding 13, an average 3, the
# j lattice (36 horizontal taps, then 6-tap per sample) 532
LUMA_OPS = (0, 256, 208, 256, 256, 464, 644, 464,
            208, 788, 532, 788, 256, 464, 644, 464)
CHROMA_OPS = 80     # two 2x2 bilinear blocks: weights, 4 taps a sample


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls (after one warm
    call), by CUDA events.  A sleep kernel ahead of the first event holds
    the card while the host enqueues the calls, so that a kernel shorter
    than its wrapper's host time is timed by its device work and not by
    the enqueue (as long as the calls are enqueued within the sleep)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
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


@functools.cache
def int32_ops_per_s():
    """The card's peak rate of 32-bit integer operations:
    ``INT32_OPS_PER_CLOCK_PER_SM`` x its SMs x its maximum SM clock
    (``nvidia-smi``)."""
    mhz = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def b4_bound(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w, mb_h):
    """(bound ms, "bytes" or "operations") of one B4 call on these
    inputs, the larger of: the predictions written, each list's slots
    (and reference indices under weighted prediction) and the WP tables
    read, and for every block and list it uses, its vector and its 16
    luma + 8 chroma reference samples once, over the memory rate; the
    operations its phases need (``LUMA_OPS``, ``CHROMA_OPS``) and the
    combine's 6 per sample (9 when bi-predicted), over the int32 rate."""
    n = mb_w * mb_h
    mode = wp["mode"]
    lists = [(rs0, mv0)] + ([(rs1, mv1)] if rs1 is not None else [])
    nbytes = n * 384 + rs0.numel() * len(lists) * (2 if mode else 1)
    if mode:
        nbytes += 2 * 32 * 6 * 2 + 256 * 2 * 2 + 16
    ops = 0
    used = []
    phase_ops = torch.tensor(LUMA_OPS, device=rs0.device)
    for rs, mv in lists:
        u = rs >= 0
        k = int(u.sum())
        nbytes += k * (4 + 24)
        ph = (mv[:, 1].long() & 3) * 4 + (mv[:, 0].long() & 3)
        ops += int(phase_ops[ph][u].sum()) + CHROMA_OPS * k
        used.append(u)
    either = used[0] if len(used) == 1 else used[0] | used[1]
    both = 0 if len(used) == 1 else int((used[0] & used[1]).sum())
    ops += 24 * (6 * int(either.sum()) + 3 * both)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int32_ops_per_s() * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def motion_field(rng, n4, R, reach, dev):
    """A random motion field on the packed wire's fields: int16 vectors
    [n4, 2 lists, 2] within +-reach quarter pels, int8 slots and
    reference indices [n4, 4] (rs0, rs1, ri0, ri1; a quarter of the
    blocks use list 0 only, a quarter list 1 only, a quarter both, a
    quarter none), and WP tables (explicit [2,32,6] and implicit [256,2]
    int16, zero-padded; misc int32 = denominators 5 and 6, n_ref1 6)."""
    mv = rng.integers(-reach, reach + 1, (n4, 2, 2)).astype(np.int16)
    use = rng.integers(0, 4, n4)
    rs0 = np.where(use & 1, rng.integers(0, R, n4), -1)
    rs1 = np.where(use & 2, rng.integers(0, R, n4), -1)
    rsri = np.stack([rs0, rs1, np.where(rs0 >= 0, rng.integers(0, 6, n4),
                                        -1),
                     np.where(rs1 >= 0, rng.integers(0, 6, n4), -1)], 1)
    expl = np.zeros((2, 32, 6), np.int16)
    expl[:, :6] = rng.integers(-128, 128, (2, 6, 6))
    imp = np.zeros((256, 2), np.int16)
    imp[:36] = rng.integers(-64, 129, (36, 2))
    t = [torch.from_numpy(a).to(dev)
         for a in (mv, rsri.astype(np.int8), expl, imp)]
    return t + [torch.tensor([5, 6, 6, 0], dtype=torch.int32, device=dev)]


def b4_args(stacks, field, nlists, mode, mb_w, mb_h):
    """``mc_frame``'s arguments for a P (nlists 1) or B picture."""
    mv, rsri, expl, imp, misc = field
    b = nlists == 2
    wp = {"mode": mode, "ri0": rsri[:, 2], "ri1": rsri[:, 3], "expl": expl,
          "imp": imp, "misc": misc}
    return (*stacks, rsri[:, 0], rsri[:, 1] if b else None, mv[:, 0],
            mv[:, 1] if b else None, wp, mb_w, mb_h)


def inter_edge_params(rng, mb_w, mb_h, tables, dev):
    """B3's parameter rows [1, n, 192] of a random I/P/B picture through
    ``deblock_precompute``: intra and inter kinds, sorted slice ids with
    disable_deblocking_filter_idc 0/1/2, coded flags and small vectors per
    4x4 block, so that bS 1 and 2 occur and change along an edge."""
    from dryv_tpu_torch.kernels.deblock import (deblock_precompute,
                                                pack_params)

    n = mb_w * mb_h
    H4, W4 = 4 * mb_h, 4 * mb_w

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)[None]

    offs = 2 * rng.integers(-3, 4, n)
    return pack_params(deblock_precompute(
        t(rng.choice([0, 1, 2, 4, 5, 6, 7, 8, 9, 10], n,
                     p=[.04, .03, .03] + [.9 / 7] * 7)),
        t(rng.integers(10, 52, n)), t(np.sort(rng.integers(0, 9, n))),
        t(rng.choice([0, 1, 2], n, p=[.8, .1, .1])), t(offs), t(-offs),
        mb_w, mb_h, 1, -2, tables, t(rng.integers(0, 2, n)),
        t(rng.random((H4, W4)) < 0.3), t(rng.integers(-6, 7, (H4, W4, 2))),
        t(rng.integers(-6, 7, (H4, W4, 2))), t(rng.integers(-1, 3, (H4, W4))),
        t(rng.integers(-1, 3, (H4, W4)))))


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
    """For each of `names`, the device ms of each device kernel whose
    name holds it, in launch order, in a torch.profiler trace of one
    fn() call; None when the profiler records no device time.  (One
    session per process: a second one records no device events.)"""
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
    return {n: [round((e.time_range.end - e.time_range.start) / 1e3, 4)
                for e in sorted(evs, key=lambda e: e.time_range.start)
                if n in e.name] for n in names}


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

    from dryv_tpu_torch import _build, device_ipb_packed, gop_pipeline, \
        parallel
    from dryv_tpu_torch.decoder import DecodedFrame
    from dryv_tpu_torch.device_ipb_packed import (
        PackedPictureDecoder, decode_annexb_device_packed)
    from dryv_tpu_torch.gop_pipeline import (PackedGopDecoder,
                                             decode_annexb_gop_pipelined)
    from dryv_tpu_torch.kernels.deblock import (deblock, deblock_plain,
                                                deblock_precompute,
                                                pack_params)
    from dryv_tpu_torch.kernels.densify import densify, densify_plain
    from dryv_tpu_torch.kernels.inter import mc_frame, mc_frame_wire_plain
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

    print(f"int32 peak {int32_ops_per_s() / 1e12:.3f} T/s "
          f"({INT32_OPS_PER_CLOCK_PER_SM} a clock per SM, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} "
          f"SMs, maximum SM clock)  [{card}]")
    tables = decoder_tables(dev)
    rng = np.random.default_rng(2024)
    kernels = {}

    def report(label, err, ms, plain_ms, bound):
        print(f"kernel {label}: max_abs_err {err} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound:.4f} ms "
              f"({bound / ms:.2%} of it)  [{card}]")
        if err != 0:
            fail(f"{label} differs from its plain version (max {err})")

    def record(key, route_src, replaces, err, ms, plain_ms, bound,
               bound_by="bytes"):
        kernels[key] = {"name": key, "route": "cuda", "source": route_src,
                        "replaces": replaces, "launches": None,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
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
    # B1 at the wire's shapes (16 pictures x 8192 MB rows on the batched
    # path, 1 picture on the I/P/B path) at three value strides, each
    # with rows of 0, W, W + 1 and 408 values
    npad = 8192
    b1_cases = {}
    for nf, W in [(F, w) for w in (32, 96, 256)] + [(1, w)
                                                    for w in (32, 96, 256)]:
        counts = rng.integers(0, 409, (nf, npad, 1))
        counts[:, :4, 0] = [0, W, W + 1, 408]
        bits = rng.random((nf, npad, 408)) * 408 < counts
        bmp = torch.from_numpy(np.packbits(bits, axis=-1,
                                           bitorder="little")).to(dev)
        vals = torch.from_numpy(rng.integers(-127, 128, (nf, npad, W))
                                .astype(np.int8)).to(dev)
        out_k = densify(bmp, vals)
        err = int((out_k.int() - densify_plain(bmp, vals).int()).abs().max())
        ms = cuda_ms(lambda: densify(bmp, vals), 20)
        plain = cuda_ms(lambda: densify_plain(bmp, vals), 5)
        bound = bound_ms(bmp, vals, out_k)
        if W == 96:
            b1_cases[nf] = (bmp, vals)
            record("densify" if nf == F else "densify_f1",
                   "dryv_tpu_torch/csrc/densify.cu",
                   "dryv_tpu/kernels/densify.py:38", err, ms, plain, bound)
        else:
            report(f"densify at F = {nf}, W = {W}", err, ms, plain, bound)
        if old and nf == F:
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
        return pack_params(deblock_precompute(
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

    # B3 at F = 1 on inter edge parameters (the I/P/B path's): bS 1 and
    # 2, changing from one 4-line segment to the next along an edge
    prm_in = inter_edge_params(rng, MB_W, MB_H, tables, dev)
    bs_seen = sorted(torch.unique(prm_in[..., :16]).tolist())
    err = max_err(deblock(prm_in, *[p.clone() for p in planes1], MB_W,
                          MB_H), deblock_plain(prm_in, *planes1, MB_W, MB_H))
    changed = [int((a != b).sum()) for a, b in zip(
        deblock(prm_in, *[p.clone() for p in planes1], MB_W, MB_H), planes1)]
    print(f"kernel deblock (F = 1) on inter edge parameters (luma vertical "
          f"bS {bs_seen}): max_abs_err {err}, changed {changed} samples "
          f"(y, cb, cr), kernel {fresh_ms(deblock, prm_in, planes1):.4f} "
          f"ms  [{card}]")
    if err or min(changed) == 0 or not {1, 2} <= set(bs_seen):
        fail("deblock on inter edge parameters differs, filtered nothing "
             "or saw no bS 1 and 2")

    # B4 at the I/P/B path's shape: 120x68 MBs over random stacks of 3
    # pictures; P (list 0) and B (both lists) under weighted prediction
    # 0/1/2; vectors within 48 pixels ("local") and reaching past every
    # edge of the picture ("far")
    n4 = 16 * n
    stacks = [torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
              .to(dev) for shape in ((3, 16 * MB_H, 16 * MB_W),
                                     (3, 8 * MB_H, 8 * MB_W),
                                     (3, 8 * MB_H, 8 * MB_W))]
    b4_cases = {}
    for motion, reach in (("far", 4 * (16 * MB_W + 64)), ("local", 4 * 48)):
        field = motion_field(rng, n4, 3, reach, dev)
        for nl, mode in ((1, 0), (1, 1), (2, 0), (2, 1), (2, 2)):
            args = b4_args(stacks, field, nl, mode, MB_W, MB_H)
            err = max_err(mc_frame(*args), mc_frame_wire_plain(*args))
            if err:
                fail(f"inter_mc ({motion}, {'PB'[nl - 1]}, WP {mode}) "
                     f"differs from its plain version (max {err})")
            b4_cases[(motion, nl, mode)] = (args, cuda_ms(
                lambda: mc_frame(*args), 20))
    print("kernel inter_mc, bit-exact in every case, CUDA events, mean of "
          "20: " + ", ".join(
              f"{m} {'PB'[nl - 1]} WP {wm} {ms:.4f} ms (bound "
              f"{b4_bound(*a)[0]:.4f} ms)"
              for (m, nl, wm), (a, ms) in b4_cases.items()) + f"  [{card}]")
    args, ms = b4_cases[("local", 2, 2)]
    record("inter_mc", "dryv_tpu_torch/csrc/inter_mc.cu",
           "dryv_tpu/kernels/inter.py:146", 0, ms,
           cuda_ms(lambda: mc_frame_wire_plain(*args), 3), *b4_bound(*args))

    # one B1, B2, B3 or B4 call is one launch on the device; the trace's
    # device time of each kernel, beside cuda_ms's
    names = ("densify_kernel", "intra_rows_kernel", "deblock_rows_kernel",
             "inter_mc_kernel")
    b4_prof = [b4_cases[("local", 1, 1)][0], b4_cases[("local", 2, 2)][0]]
    n_prof = kernel_launches_in_profile(
        lambda: ([densify(*b1_cases[nf]) for nf in (F, 1)],
                 [intra_recon(*inputs, tables, MB_W, rows, halo=halo)
                  for inputs, rows, halo in b2_cases.values()],
                 [deblock(prm, *[p.clone() for p in planes], MB_W, MB_H)
                  for prm, planes in b3_cases.values()],
                 [mc_frame(*a) for a in b4_prof]), names)
    print(f"device ms of each device kernel in a torch.profiler "
          f"trace of 2 B1 calls (W = 96 at F = {F}, 1), {len(b2_cases)} B2 "
          f"calls ({', '.join(b2_cases)}), {len(b3_cases)} B3 calls "
          f"({', '.join(b3_cases)}) and {len(b4_prof)} B4 calls (P, B): "
          f"{'not measured' if n_prof is None else n_prof}  [{card}]")
    if n_prof is not None and [len(n_prof[k]) for k in names] != [
            2, len(b2_cases), len(b3_cases), len(b4_prof)]:
        fail("a B1, B2, B3 or B4 call launched other than one kernel")

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
        densify.launches = deblock.launches = mc_frame.launches = 0
        intra_recon.launches = intra_recon.banded_launches = 0
        decode_annexb_gop_pipelined.fallback_calls = 0
        decode_annexb_fast.host_calls = 0
        decode_annexb_device_packed.host_calls = 0

    def counts():
        return {"densify": densify.launches,
                "intra_wavefront": intra_recon.launches,
                "intra_wavefront_banded": intra_recon.banded_launches,
                "deblock": deblock.launches,
                "inter_mc": mc_frame.launches,
                "fallback_calls": decode_annexb_gop_pipelined.fallback_calls,
                "host_calls": decode_annexb_fast.host_calls,
                "ipb_host_calls": decode_annexb_device_packed.host_calls}

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

    # ---- phase 10: the packed I/P/B path ----------------------------------
    gi = np.load("benchdata/bench_ipb_golden.npz")
    ipb_small = open("benchdata/bench_ipb.264", "rb").read()
    ipb = open("benchdata/bench1080p_ipb.264", "rb").read()
    ipb_ref = [(r.y, r.cb, r.cr) for r in
               decode_annexb_native(ipb, n_threads=nthreads)]
    seen = {}         # (nlists, wp_mode) -> pictures
    captured = {}     # nlists -> one B4 call's arguments on bench1080p
    forward = PackedPictureDecoder.forward
    mc_of_path = device_ipb_packed.mc_frame

    def seen_forward(self, blob, W, ecap, ovcap, refs, nlists, wp_mode,
                     *rest):
        key = ("IPB"[nlists], wp_mode)
        seen[key] = seen.get(key, 0) + 1
        return forward(self, blob, W, ecap, ovcap, refs, nlists, wp_mode,
                       *rest)

    def capture_mc(*args):
        if args[3].shape[0] == 16 * MB_W * MB_H:
            captured.setdefault(1 if args[4] is None else 2, args)
        return mc_of_path(*args)

    PackedPictureDecoder.forward = seen_forward
    device_ipb_packed.mc_frame = capture_mc
    reset_counts()
    try:
        check_frames("packed I/P/B bench_ipb.264 (640x368, 9 pictures)",
                     decode_annexb_device_packed(ipb_small,
                                                 n_threads=nthreads,
                                                 device=dev),
                     [(gi[f"f{i}_y"], gi[f"f{i}_b"], gi[f"f{i}_r"])
                      for i in range(9)], "bench_ipb_golden.npz")
        check_frames("packed I/P/B bench1080p_ipb.264 (1080p, 10 pictures)",
                     decode_annexb_device_packed(ipb, n_threads=nthreads,
                                                 device=dev),
                     ipb_ref, "native C++")
    finally:
        PackedPictureDecoder.forward = forward
        device_ipb_packed.mc_frame = mc_of_path
    c = counts()
    print(f"pictures by type and weighted-prediction mode on the packed "
          f"I/P/B path: {seen}")
    need("packed I/P/B path", c, ("densify", "intra_wavefront", "deblock",
                                  "inter_mc"),
         report={"inter_mc": "inter_mc", "densify_f1": "densify"})
    if c["ipb_host_calls"]:
        fail("the packed I/P/B path sent a stream to the host decoder")
    for nl, a in sorted(captured.items()):
        print(f"kernel inter_mc on a {'PB'[nl - 1]} picture of "
              f"bench1080p_ipb.264 (WP {a[7]['mode']}, stack of "
              f"{a[0].shape[0]}), CUDA events, mean of 20: "
              f"{cuda_ms(lambda: mc_frame(*a), 20):.4f} ms, plain "
              f"{cuda_ms(lambda: mc_frame_wire_plain(*a), 3):.4f} ms, "
              f"bound {b4_bound(*a)[0]:.4f} ms ({b4_bound(*a)[1]})  "
              f"[{card}]")

    # end to end, frames to host, in turns with the native C++ decode
    fps = {"native C++": [], "packed I/P/B": []}
    for label in ("native C++", "packed I/P/B") * 3:
        tm = StageTimers()
        t0 = time.perf_counter()
        if label == "native C++":
            got = decode_annexb_native(ipb, n_threads=nthreads)
        else:
            got = decode_annexb_device_packed(ipb, n_threads=nthreads,
                                              device=dev, timers=tm)
        wall = time.perf_counter() - t0
        fps[label].append(len(got) / wall)
        check_frames(f"{label} bench1080p_ipb.264 (timed)", got, ipb_ref,
                     "native C++")
    print("e2e bench1080p_ipb.264 (10 pictures, frames to host, "
          f"n_threads={nthreads}), in turns: " + "; ".join(
              f"{k} median {statistics.median(v):.2f} fps (runs "
              f"{', '.join(f'{x:.2f}' for x in v)})" for k, v in fps.items())
          + f"  [{card}]")
    per_pic = {k: round(v / len(got) * 1e3, 3) for k, v in tm.t.items()}
    print(f"e2e packed I/P/B stage ms/picture (last run): "
          f"{json.dumps(per_pic)}; stage sum / wall "
          f"{sum(tm.t.values()) / wall:.3f}  [{card}]")

    # the device span of each picture: CUDA events around
    # PackedPictureDecoder.forward, nothing synchronising inside the run
    spans = []

    def timed_forward(self, *a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = forward(self, *a)
        e1.record()
        spans.append((e0, e1, "IPB"[a[5]]))
        return out

    PackedPictureDecoder.forward = timed_forward
    try:
        t0 = time.perf_counter()
        decode_annexb_device_packed(ipb, n_threads=nthreads, device=dev,
                                    device_out=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PackedPictureDecoder.forward = forward
    ms = [(a.elapsed_time(b), t) for a, b, t in spans]
    print(f"device span per picture of bench1080p_ipb.264 (device output), "
          f"CUDA events: " + ", ".join(f"{t} {v:.3f}" for v, t in ms)
          + f" ms; mean {statistics.mean(v for v, _ in ms):.3f} ms, "
          f"{sum(v for v, _ in ms) / 1e3 / wall:.4f} of the {wall:.3f} s "
          f"wall  [{card}]")

    # the host side of the device stage: kernel launches per picture in a
    # CPU-activity torch.profiler trace (the process's first profiler run
    # took the device events), and the calls that synchronise with the
    # card
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_annexb_device_packed(ipb, n_threads=nthreads, device=dev,
                                    device_out=True)
        torch.cuda.synchronize()
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        decode_annexb_device_packed(ipb, n_threads=nthreads, device=dev,
                                    device_out=True)
    torch.cuda.set_sync_debug_mode(0)
    n_sync = sum("synchronizing" in str(x.message) for x in caught)
    print(f"packed I/P/B bench1080p_ipb.264 host side: {n_launch / 10:.1f} "
          f"kernel launches per picture (cudaLaunchKernel in a CPU-activity "
          f"torch.profiler trace), {n_sync} synchronizing calls in a decode "
          f"(torch.cuda sync debug mode)  [{card}]")

    # ---- phase 11: banded P recon, equal to B4 on the whole plane -------
    prng = np.random.default_rng(5)
    n4 = 16 * n
    pmv = np.stack([prng.integers(-4 * 80, 4 * 80 + 1, n4),
                    prng.integers(-4 * 48, 4 * 48 + 1, n4)], 1)
    prs = np.where(prng.random(n4) < 0.05, -1, 0)
    yres = prng.integers(-30, 31, (n, 16, 16))
    cres = prng.integers(-30, 31, (n, 2, 8, 8))
    ref = [p[0] for p in stacks]
    py, pc = mc_frame(*(p[None] for p in ref),
                      torch.from_numpy(prs.astype(np.int8)).to(dev), None,
                      torch.from_numpy(pmv.astype(np.int16)).to(dev), None,
                      {"mode": 0}, MB_W, MB_H)
    ty = (py.int() + torch.from_numpy(yres).to(dev)).clamp(0, 255)
    tc = (pc.int() + torch.from_numpy(cres).to(dev)).clamp(0, 255)
    want = (ty.view(MB_H, MB_W, 16, 16).permute(0, 2, 1, 3)
            .reshape(16 * MB_H, 16 * MB_W),
            *(tc[:, p].reshape(MB_H, MB_W, 8, 8).permute(0, 2, 1, 3)
              .reshape(8 * MB_H, 8 * MB_W) for p in (0, 1)))
    reset_counts()
    for devs in [["cuda:0"] * 4] + ([[f"cuda:{i}" for i in range(
            min(4, n_cards))]] if n_cards > 1 else []):
        run = parallel.make_banded_p_recon_fn(
            parallel.make_mesh({"band": len(devs)}, devs), MB_W, MB_H,
            apron=64)
        got = run(*(p.cpu().numpy() for p in ref), pmv, prs, yres, cres,
                  device_out=True)
        if not all(torch.equal(g.to(dev), w.to(torch.uint8))
                   for g, w in zip(got, want)):
            fail(f"banded P recon over {devs} differs from B4 on the whole "
                 f"plane")
        print(f"banded P recon over {devs} ({MB_H // len(devs)} MB rows a "
              f"band, apron 64): equal to B4 on the whole plane")
    need("banded P recon", counts(), ("inter_mc",))

    for k, v in kernels.items():
        if not v["launches"]:
            fail(f"kernel {k} launched on no driven path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
