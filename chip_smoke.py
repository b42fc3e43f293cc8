"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --compare DIR [DIR ...]   # also time earlier
                                                    # B1, B3-B6
    python3 chip_smoke.py --multichip   # only the sharded paths over the
                                        # first four cards (two or more)

Builds the port's C++ host library (g++) and CUDA kernels (nvcc) from
the sources in this checkout, and holds each kernel against its plain
PyTorch version at the shapes its paths give it (1080p batches of 16
pictures, and of 1 for the per-picture and I/P/B paths' intra wavefront
and deblock and the I/P/B path's densify; one band of 120x17 MBs x 4
for the banded wavefront; densify at W = 32, 96 and 256; stage A (B5) on random kinds, QPs 0-51,
chroma offsets -12 and +12 and random LevelScale lists, its levels as column slices of the dense
rows and as separate segments, and with the coded flags (nz4) it writes for the I/P/B step; the
deblock parameters (B6) with random
slices and disable_deblocking_filter_idc 0/1/2 and on an inter motion field; deblock with every
edge on, with random slices and disable_deblocking_filter_idc, and on inter edge parameters;
motion compensation at 120x68 MBs over stacks of 3 pictures, P and B,
weighted prediction 0/1/2, random vectors per 4x4 block near and far,
and H.264 macroblock layouts from ``testing.motion.partitioned_field``,
and on every P and B picture of ``bench_ipb.264``, ``bench1080p_ipb.264``
and the corpus streams of ``tests/conformance`` that the I/P/B path
takes, each stream bit-exact to the native C++ decode and each picture
described by its groups per MB and its share of full-pel MBs), with a
tolerance of 0: the decoder is bit-exact.  Each kernel's bound is the
larger of the bytes it must move (each input read once, each output
written once) over the card's 3.35 TB/s and, for motion compensation,
the integer operations its inputs need (each half-sample intermediate
once per group of blocks sharing list, slot and vector in an MB) over
the card's int32 rate (64 a clock per SM, at its SM count and its
maximum SM clock).  Then it drives each path of
the port with the launch counters set to 0 just before and read just
after, and checks every frame bit-exact against the native C++ decoder
or a stored golden:

- the batched all-intra decode,
  ``gop_pipeline.decode_annexb_gop_pipelined`` (densify, intra
  wavefront, deblock);
- the per-picture path, ``pipeline.decode_annexb_fast`` (intra
  wavefront and deblock at F = 1), on the 1080p goldens and on
  encoder-made CAVLC and scaling-matrix pictures, which the batched
  pipeline must hand to it; the LevelScale lists are inputs of its
  step, so the flat and the scaling-matrix pictures of one geometry
  must share one key;
- ``pipeline.entry()``, the counterpart of ``__graft_entry__.entry()``
  (the per-picture step at 4x4 MBs, intra wavefront at F = 1), on its
  example arguments and on random non-flat lists: one step made for
  both, each call equal to the plain run on the CPU and the flat one to
  native C++, its replay timed;
- the sharded decode, ``parallel`` (GOP-sharded, band-pipelined,
  band-sharded single frame, the dry run), on one card through meshes
  that repeat it: each path eager and graphed (one step of
  ``parallel.STEPS`` replayed, every slot stream inside its graph), the
  one-card meshes required to take the graphed route, two graphed calls
  on other inputs (the pictures reversed) each right while the first
  call's planes are held;
- the packed I/P/B path, ``device_ipb_packed.decode_annexb_device_packed``
  (densify, motion compensation, intra wavefront and deblock at F = 1),
  on ``bench_ipb.264`` and ``bench1080p_ipb.264``;
- banded P recon, ``parallel.make_banded_p_recon_fn``, against motion
  compensation on the whole plane, eager and graphed on a mesh of one
  card (two graphed calls on two pictures);
- the sharded paths' per-group route, where each group of a mesh axis's
  slots on one card is a graph of its own and every exchange between
  groups (halos, P recon's ghost bands, each group's planes into the
  step's planes) runs inside their graphs, card to card
  (``graphs.peer_copy``): the 4
  slots of one card cut in 2 and in 4 groups through the private seam
  ``parallel.mesh._slot_group`` (``slot_groups_of``), the GOP over
  {gop: 4} (F_local = 4), the band pipeline (4 bands of 17 MB rows, F =
  16, Fi = 4) and the banded frame over {band: 4}, banded P recon over
  {band: 4} (apron 64), the GOP and the banded frame over the 2-D mesh
  {gop: 2, band: 2}, each graphed, eager, graphed and eager on other
  inputs, bit-exact to the one-group route and native C++ (P recon: B4
  on the whole plane); with several cards the same over the first four
  (``multi_card_phase``: B2, B2b and B4 against their plain versions on
  every card, each path's two input sets alternated 8 calls back to back
  with no synchronisation and every held result bit-exact, the dry run
  over the cards twice, each path's step alone and whole call timed on
  one card and on the cards in turns, the per-call host ms line of each
  graphed step (0 cudaMalloc in its calls over the cards) and whole
  call, each whole call by phase, the census of its kernels per card,
  the CUDA runtime calls of one graphed step (one graph launch a card,
  no copy outside the graphs but the loads and the results'), the host
  ms of a graph launch on each card for small graphs with and without
  the nodes a part holds over several cards and of each part's replay
  in every graphed step (``replay_costs``), each card's graph pool).
  ``--multichip`` runs only the build and that
  phase.

Each decode path runs both ways: eager (``graph=False``, every op
enqueued from the host) and graphed (the default: one captured CUDA
graph replayed per batch or picture, ``dryv_tpu_torch.graphs``), the two
bit-exact to each other and to the reference; one set of I/P/B steps is
captured with torch.cuda's sync debug mode set to "error" inside the
captured function.  A replay launches its kernels without calling their
wrappers, so the run ends with one torch.profiler device trace (the
census): one call of each kernel, then every graphed path's streams
again, each kernel counted by name; a graphed path's count must equal
its eager decode's wrapper counts, and the per-kernel JSON takes its
launches from there.  B5 must show on every path's step, B6 on every
deblocked one, and ``entry()``'s replay must hold fewer than 100 device
activities.  The same trace splits each step's device time by part:
eager runs of the steps, the device time each ``torch.profiler`` range
of ``dryv_tpu_torch.kernels.RANGES`` launched; a range whose work moved
into a kernel (``GONE_RANGES``: nz4, now B5's) must launch nothing.
It times the kernels, the end-to-end batched decode eager and graphed in
turns, the device span of
a batch of 16 deblocked pictures, the per-picture decode eager and
graphed, the sharded paths eager and graphed in turns (the band pipeline beside
the unbanded wavefront with the syntax on the card, whole calls, the
device part of ``decode_gop_sharded``, banded P recon per 1080p P
picture, with host enqueue beside each device span), and the
1080p I/P/B decode eager and graphed in turns with the native C++
decode, with each path's device span per batch or picture (CUDA events
around its device call), its host enqueue, its cudaLaunchKernel and
cudaGraphLaunch calls (CPU-activity torch.profiler traces, after the
census) and its captured steps (keys, capture ms, the MiB of their
graph pool).  With --compare DIR [DIR ...]
(directories outside the repo's sources, each holding an earlier tree's
``densify.cu``, ``deblock.cu``, ``inter_mc.cu``, ``stage_a.cu`` or
``deblock_params.cu``, any of them, with the ``common.cuh`` they
include; densify and deblock with their C entries as they were before
B3 took a scratch argument, inter_mc with today's, stage_a and
deblock_params as B5 and B6 first had them) it also builds those
kernels (one nvcc per source, all at once), prints their ptxas report,
and times them and the current ones in turns (old, new, new, old; B1,
B3, B5 and B6 of the first DIR that holds them, at each of their shapes
above, bit-exact to the current ones; B4 of every DIR): B4 in every
case above and on every real picture beside its bound, with sums per
stream and over the pictures under 90% full-pel MBs.  It prints the
registers, shared memory, stack and spills ptxas reports for B5 and B6.
Every timing line ends with the card's ``nvidia-smi`` name and power
limit.  Any failure ends the run with a
non-zero exit and no result line.  The last line is {"ok": true,
"device": {...}}; the line before it holds the per-kernel JSON.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import functools
import gc
import glob
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import torch

F = 16           # pictures per batch, as the benchmark runs
# profiler ranges of earlier trees whose work moved into a kernel: the
# census holds each at 0 device activities (nz4: the I/P/B step's coded
# flags, written by B5 since it took them over)
GONE_RANGES = ("nz4",)
ONE_CARD = ["cuda:0"] * 4   # the sharded paths' slots on one card
MB_W, MB_H = 120, 68
REPS = 3    # runs of each end-to-end timing, in turns
SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's ~2 GHz SM clock
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
# 32-bit integer add, shift, compare, min/max and logic results per clock
# per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# "Arithmetic Instructions" throughput table); times the card's SM count
# and maximum SM clock it gives B4's operations rate, ~16.7 T/s on an
# H100 SXM (132 SMs, 1980 MHz)
INT32_OPS_PER_CLOCK_PER_SM = 64
# integer operations of one 4x4 luma block's quarter-pel prediction by
# phase 4*fy + fx, the block alone: a 6-tap value with its rounding 13,
# an average 3, the j lattice 532 (36 unrounded horizontal sums of 9
# operations, then a 6-tap of those with its rounding per sample)
LUMA_OPS = (0, 256, 208, 256, 256, 464, 644, 464,
            208, 788, 532, 788, 256, 464, 644, 464)
J_PHASES = (6, 9, 10, 11, 14)
# blocks that share list, slot and vector in one MB (a group) need each
# unrounded horizontal sum once: 16 a block and 20 a vertical run of
# blocks in a column of the group, where a block alone needs 36
J_SUM_OPS = 9
CHROMA_SAMPLE_OPS = 9    # 4 products, 3 sums, the rounding
CHROMA_GROUP_OPS = 8     # the four bilinear weights, once a group
# B2's integer operations on the data (csrc/intra_wavefront.cu), counted
# from its code: arithmetic on samples and their sums (add, subtract,
# multiply, shift, compare, select, min/max), not addressing; what the
# kernel's lanes each compute for a whole block is counted once a block
B2_RES = 3            # a sample's residual add and clip to [0, 255]
B2_TAP = 7            # a directional sample: three taps and the shift
B2_PLANE = 10         # a plane-mode sample: 2 differences, 2 products, 3
                      # sums, the shift, the clip
B2_I16_PRE = 87       # an I16 or PCM MB (the kernel takes these for both):
                      # above and left sums 15 + 15, the plane's 16
                      # weighted differences 32 and their sums 7 + 7, b
                      # and c 6, a 2, the DC 3
B2_I8_FILTER = 125    # an I8 block's 25 reference samples, 5 each
B2_I8_DC = 17         # an I8 DC block's two sums 7 + 7 and the DC 3
B2_I4_DC = 9          # a 4x4 DC block's two sums 3 + 3 and the DC 3
B2_C_DC = 9           # a chroma 4x4 quadrant's DC, the same
B2_C_PLANE_PRE = 32   # a chroma plane's plane-mode sums: 8 weighted
                      # differences 24, b and c 6, a 2
# B3's per line across an edge whose bS is not 0 (csrc/deblock.cu): the
# gate (3 absolute differences, 3 compares, 2 ands); past it, luma ap/aq
# 6, at bS 4 the strong test 3 and its 2 ands, each side 22 strong or 5
# weak; at bS 1-3 tc 2, delta 9, the average 3, p0 and q0 3 each, p1 and
# q1 8 each where ap / aq; chroma at bS 4 5 a side, at bS 1-3 tc 1,
# delta 9, p0 and q0 3 each
B3_GATE = 11
B3_LUMA_AP = 6
B3_STRONG, B3_STRONG_SIDE, B3_WEAK_SIDE = 5, 22, 5
B3_NORMAL, B3_NORMAL_P1 = 20, 8
B3_CHROMA_BS4, B3_CHROMA_NORMAL = 10, 16


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
    neighbours, residuals in [-300, 300] as B2 reads them (int16,
    clamped to [-255, 255]), PCM included.  below_band:
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
    y_z, c = (np.clip(rng.integers(-300, 300, shape), -255, 255)
              .astype(np.int16) for shape in ((F, n, 256), (F, n, 2, 8, 8)))
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


def ptxas_report(log, kernels=("stage_a_kernel", "deblock_params_kernel")):
    """One line per entry function of `log` (nvcc -Xptxas -v) whose name
    holds one of `kernels`: registers, static shared memory, stack frame
    and spills (B6's intra and inter forms by their template argument)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            if name and "ILb" in m.group(1):
                name += " <inter>" if "ILb1E" in m.group(1) else " <intra>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            stack, spill = m.groups()
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem|$)", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{m.group(2) or 0} B static shared, {stack} B "
                       f"stack, {spill} B spill stores")
            name = None
    return "; ".join(out)


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


def larger_bound(bytes_ms, ops):
    """(bound ms, "bytes" or "operations", both terms as text) of a call
    that moves bytes_ms's bytes and does `ops` int32 operations."""
    ops_ms = ops / int32_ops_per_s() * 1e3
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms > bytes_ms else "bytes",
            f"bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms ({ops} "
            f"int32)")


def b2_ops(meta):
    """B2's integer operations on one call's MBs (meta [F, n, 32] uint8,
    ``kernels.wavefront.recon_inputs``'s rows: kind, I16 mode, chroma
    mode, the 16 I4 and 4 I8 modes), by the ``B2_*`` counts; the banded
    form's halo adds none."""
    m = meta.reshape(-1, meta.shape[-1]).long()
    kind, cm = m[:, 0], m[:, 2]
    i8, i16, pcm = kind == 1, kind == 2, kind == 3
    i4 = ~(i8 | i16 | pcm)
    luma = (i16 | pcm) * B2_I16_PRE + i16 * 256 * (
        B2_RES + (m[:, 1] == 3) * B2_PLANE)
    luma = luma + i8 * (4 * (B2_I8_FILTER + 64 * B2_RES) + torch.where(
        m[:, 23:27] == 2, B2_I8_DC, 64 * B2_TAP).sum(1))
    luma = luma + i4 * (256 * B2_RES + torch.where(
        m[:, 7:23] == 2, B2_I4_DC, 16 * B2_TAP).sum(1))
    chroma = ~pcm * (128 * B2_RES + (cm == 0) * 8 * B2_C_DC + (cm == 3) * (
        2 * B2_C_PLANE_PRE + 128 * B2_PLANE))
    return int((luma + chroma).sum())


def b3_edge_ops(lines, prm, bs_at, a_at, b_at, luma):
    """B3's operations (``B3_*``) on one direction's edges of one plane:
    `lines` [F, L, X] uint8, each row a line crossing the edges at x =
    16 * mb + 4 * e (luma, 4 edges) or 8 * mb + 4 * e (chroma, 2), edge 0
    only past the first MB; prm [F, mb_l, mb_x, 192] the MBs' parameter
    rows in the same order; the byte offsets of edge 0's bS (luma: one a
    4 lines, chroma: one a line), alpha and beta (luma: the next edges'
    follow, chroma: every other byte).  The filters' decisions are read
    on the planes as given, before any filtering."""
    F, L, X = lines.shape
    dev = lines.device
    mb, E, G, gap, t = (16, 4, 4, 1, 4) if luma else (8, 2, 8, 2, 2)
    mb_x = X // mb
    e = torch.arange(E, device=dev)
    q0 = torch.arange(mb_x, device=dev)[:, None] * mb + 4 * e   # [mb_x, E]
    idx = (q0[..., None] + torch.arange(-t, t, device=dev)).clamp(0, X - 1)
    v = lines[:, :, idx].int()                       # [F, L, mb_x, E, 2t]
    my = torch.arange(L, device=dev) // mb
    sub = torch.arange(L, device=dev) % mb // (mb // G)
    bsm = prm[..., bs_at:bs_at + E * G].reshape(F, -1, mb_x, E, G)
    bs = bsm.permute(0, 1, 4, 2, 3)[:, my, sub].int()   # [F, L, mb_x, E]
    alpha = prm[..., a_at:a_at + gap * E:gap][:, my].int()
    beta = prm[..., b_at:b_at + gap * E:gap][:, my].int()
    on = (bs > 0) & ((torch.arange(mb_x, device=dev)[:, None] > 0) | (e > 0))
    p0, p1, q0_, q1 = v[..., t - 1], v[..., t - 2], v[..., t], v[..., t + 1]
    passed = on & ((p0 - q0_).abs() < alpha) & ((p1 - p0).abs() < beta) \
        & ((q1 - q0_).abs() < beta)
    if not luma:
        body = torch.where(bs == 4, B3_CHROMA_BS4, B3_CHROMA_NORMAL)
    else:
        ap = (v[..., t - 3] - p0).abs() < beta
        aq = (v[..., t + 2] - q0_).abs() < beta
        strong = (p0 - q0_).abs() < (alpha >> 2) + 2

        def side(a):
            return torch.where(a & strong, B3_STRONG_SIDE, B3_WEAK_SIDE)

        body = B3_LUMA_AP + torch.where(
            bs == 4, B3_STRONG + side(ap) + side(aq),
            B3_NORMAL + B3_NORMAL_P1 * (ap.int() + aq.int()))
    return int((on * B3_GATE + passed * body).sum())


def b3_ops(prm, y, cb, cr, mb_w, mb_h):
    """B3's integer operations on one call (prm [F, n, 192] as
    ``kernels.deblock.pack_params`` lays it out): ``b3_edge_ops`` over
    luma and both chroma planes, vertical edges on the rows and
    horizontal ones on the columns."""
    F = y.shape[0]
    pv = prm.view(F, mb_h, mb_w, -1)
    ph = pv.transpose(1, 2)
    ops = b3_edge_ops(y, pv, 0, 32, 36, True)
    ops += b3_edge_ops(y.transpose(1, 2), ph, 40, 72, 76, True)
    for k, c in enumerate((cb, cr)):
        ops += b3_edge_ops(c, pv, 80, 128 + k, 132 + k, False)
        ops += b3_edge_ops(c.transpose(1, 2), ph, 136, 184 + k, 188 + k,
                           False)
    return ops


def popcount16(m):
    return ((np.asarray(m)[..., None] >> np.arange(16)) & 1).sum(-1)


def b4_bound(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w, mb_h):
    """(bound ms, "bytes" or "operations") of one B4 call on these
    inputs, the larger of: the predictions written, each list's slots
    (and reference indices under weighted prediction) and the WP tables
    read, and for every block and list it uses, its vector and its 16
    luma + 8 chroma reference samples once, over the memory rate; the
    operations the inputs need over the int32 rate.  Those are counted
    per group (``testing.motion.mb_groups``: the blocks of one MB that
    share list, slot and vector), each half-pel intermediate once: for a
    group of s blocks in r vertical runs, s x ``LUMA_OPS`` of its phase,
    less 20 x ``J_SUM_OPS`` x (s - r) when the phase takes j (the
    horizontal sums the group's blocks share), 8 s chroma samples of
    ``CHROMA_SAMPLE_OPS`` and ``CHROMA_GROUP_OPS``; then the combine's 6
    a sample (9 when bi-predicted), 24 samples a block."""
    from dryv_tpu_torch.testing.motion import mb_groups

    n = mb_w * mb_h
    mode = wp["mode"]
    lists = [(rs0, mv0)] + ([(rs1, mv1)] if rs1 is not None else [])
    nbytes = n * 384 + rs0.numel() * len(lists) * (2 if mode else 1)
    if mode:
        nbytes += 2 * 32 * 6 * 2 + 256 * 2 * 2 + 16
    ops = 0
    used = []
    for rs, mv in lists:
        rs, mv = rs.cpu().numpy(), mv.cpu().numpy()
        u = rs >= 0
        nbytes += int(u.sum()) * (4 + 24)
        _, mask, vec = mb_groups(rs, mv, mb_w, mb_h)
        size = popcount16(mask)
        runs = popcount16(mask & ~(mask << 4) & 0xFFFF)
        ph = (vec[:, 1] & 3) * 4 + (vec[:, 0] & 3)
        ops += int((size * np.take(LUMA_OPS, ph)
                    - 20 * J_SUM_OPS * (size - runs) * np.isin(ph, J_PHASES)
                    + 8 * CHROMA_SAMPLE_OPS * size + CHROMA_GROUP_OPS).sum())
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
    quarter none), and WP tables (``wp_tables``)."""
    mv = rng.integers(-reach, reach + 1, (n4, 2, 2)).astype(np.int16)
    use = rng.integers(0, 4, n4)
    rs0 = np.where(use & 1, rng.integers(0, R, n4), -1)
    rs1 = np.where(use & 2, rng.integers(0, R, n4), -1)
    rsri = np.stack([rs0, rs1, np.where(rs0 >= 0, rng.integers(0, 6, n4),
                                        -1),
                     np.where(rs1 >= 0, rng.integers(0, 6, n4), -1)], 1)
    return [torch.from_numpy(a).to(dev)
            for a in (mv, rsri.astype(np.int8))] + wp_tables(rng, 6, dev)


def partitioned_motion(rng, R, nlists, kinds, dev, full_pel=False):
    """``motion_field``'s tensors for H.264 MB layouts of the kinds given
    at MB_W x MB_H (``testing.motion.partitioned_field``, reference
    indices below 3 in list 0 and 2 in list 1); full_pel: vectors
    rounded down to full samples."""
    from dryv_tpu_torch.testing.motion import partitioned_field

    f = partitioned_field(rng, MB_W, MB_H, R, nlists, kinds)
    mv = np.stack([f["mv0"], f["mv1"]], 1)
    if full_pel:
        mv &= ~3
    rsri = np.stack([f["rs0"], f["rs1"], f["ri0"], f["ri1"]], 1)
    return [torch.from_numpy(a).to(dev) for a in (mv, rsri)] + \
        wp_tables(rng, 2, dev)


def wp_tables(rng, n_ref1, dev):
    """Random WP tables: explicit [2,32,6] and implicit [256,2] int16,
    zero-padded; misc int32 = denominators 5 and 6, n_ref1."""
    expl = np.zeros((2, 32, 6), np.int16)
    expl[:, :6] = rng.integers(-128, 128, (2, 6, 6))
    imp = np.zeros((256, 2), np.int16)
    imp[:36] = rng.integers(-64, 129, (36, 2))
    return [torch.from_numpy(a).to(dev) for a in (expl, imp)] + [
        torch.tensor([5, 6, n_ref1, 0], dtype=torch.int32, device=dev)]


def b4_args(stacks, field, nlists, mode, mb_w, mb_h):
    """``mc_frame``'s arguments for a P (nlists 1) or B picture."""
    mv, rsri, expl, imp, misc = field
    b = nlists == 2
    wp = {"mode": mode, "ri0": rsri[:, 2], "ri1": rsri[:, 3], "expl": expl,
          "imp": imp, "misc": misc}
    return (*stacks, rsri[:, 0], rsri[:, 1] if b else None, mv[:, 0],
            mv[:, 1] if b else None, wp, mb_w, mb_h)


def inter_edge_inputs(rng, mb_w, mb_h, dev):
    """B6's inputs for a random I/P/B picture, on the packed wire's layout
    (``deblock_params``): intra and inter kinds, sorted slice ids with
    disable_deblocking_filter_idc 0/1/2, coded flags and small vectors per
    4x4 block, so that bS 1 and 2 occur and change along an edge.
    Returns (the per-MB fields, {t8, nz4, mv, rs})."""
    n = mb_w * mb_h
    n4 = 16 * n

    def t(a, dt=np.int32):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)[None]

    offs = 2 * rng.integers(-3, 4, n)
    per_mb = (t(rng.choice([0, 1, 2, 4, 5, 6, 7, 8, 9, 10], n,
                           p=[.04, .03, .03] + [.9 / 7] * 7)),
              t(rng.integers(10, 52, n)), t(np.sort(rng.integers(0, 9, n))),
              t(rng.choice([0, 1, 2], n, p=[.8, .1, .1])), t(offs),
              t(-offs))
    return per_mb, {"t8": t(rng.integers(0, 2, n)),
                    "nz4": t(rng.random((4 * mb_h, 4 * mb_w)) < 0.3, bool),
                    "mv": t(rng.integers(-6, 7, (n4, 2, 2)), np.int16),
                    "rs": t(rng.integers(-1, 3, (n4, 4)), np.int8)}


def inter_edge_params(rng, mb_w, mb_h, tables, dev):
    """B3's parameter rows [1, n, 192] of a random I/P/B picture
    (``inter_edge_inputs``) through B6's plain version."""
    from dryv_tpu_torch.kernels.deblock import deblock_params_plain

    per_mb, inter = inter_edge_inputs(rng, mb_w, mb_h, dev)
    return deblock_params_plain(*per_mb, mb_w, mb_h, 1, -2, tables, **inter)


# The C entries of the earlier kernels --compare builds: source, name,
# argument kinds ("p" pointer, "i" int; the stream follows).  densify.cu
# and deblock.cu as the trees before B3 took a scratch argument had them,
# inter_mc.cu as every tree since B4 came has it, stage_a.cu and
# deblock_params.cu as B5 and B6 first came (before B5 wrote nz4).
OLD_ENTRIES = {"densify.cu": ("dt_densify", "pppii"),
               "deblock.cu": ("dt_deblock", "ppppiii"),
               "inter_mc.cu": ("dt_inter_mc", "p" * 14 + "i" * 10),
               "stage_a.cu": ("dt_stage_a", "p" * 14 + "i" * 10),
               "deblock_params.cu": ("dt_deblock_params", "p" * 15 + "i" * 5)}


def old_kernels(src_dir, label):
    """Builds those of B1, B3, B4, B5 and B6 that an earlier tree's
    sources in ``src_dir`` hold (``densify.cu``, ``deblock.cu``,
    ``inter_mc.cu``, ``stage_a.cu``, ``deblock_params.cu``, with the
    ``common.cuh`` they include) into one library named after `label` and
    returns ({"densify": fn, "deblock": fn, "inter_mc": fn, "stage_a":
    fn, "deblock_params": fn}, those built, with the current wrappers'
    arguments and results (B5 without nz4); nvcc's ptxas report)."""
    from pathlib import Path

    from dryv_tpu_torch import _build
    from dryv_tpu_torch._libbuild import build_library, library_path

    d = Path(src_dir).resolve()
    present = {k: v for k, v in OLD_ENTRIES.items() if (d / k).exists()}
    if not present:
        fail(f"--compare {src_dir}: none of {', '.join(OLD_ENTRIES)}")
    srcs = [d / name for name in present]
    lib_path = library_path(f"libearlier_{label}", srcs + [d / "common.cuh"],
                            " ".join(_build.NVCC_FLAGS).encode())
    nvcc = _build._nvcc()
    log = build_library(lib_path, srcs,
                        lambda s, o: [nvcc, *_build.NVCC_FLAGS, "-Xptxas",
                                      "-v", "-c", str(s), "-o", str(o)],
                        lambda objs, out: [nvcc, "-shared", *map(str, objs),
                                           "-o", str(out)], force=True)
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for entry, kinds in present.values():
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

    def inter_mc(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w,
                 mb_h, row0=0):
        n, mode = mb_w * mb_h, wp["mode"]
        pred_y = torch.empty((n, 16, 16), dtype=torch.uint8,
                             device=refs_y.device)
        pred_c = torch.empty((n, 2, 8, 8), dtype=torch.uint8,
                             device=refs_y.device)
        run("dt_inter_mc", refs_y, refs_cb, refs_cr, mv0, mv1, rs0, rs1,
            *(wp.get(k) if mode else None
              for k in ("ri0", "ri1", "expl", "imp", "misc")),
            pred_y, pred_c, *refs_y.shape, mb_w, mb_h, row0, mv0.stride(0),
            rs0.stride(0), 1 if rs1 is None else 2, mode)
        return pred_y, pred_c

    def stage_a(s, tables):
        from dryv_tpu_torch.kernels.transform import LEVELS, LS_KEYS, PER_MB

        F, n = s["kind"].shape
        dev = s["kind"].device
        levels = [s[k] for k, _ in LEVELS]
        yres = torch.empty((F, n, 256), dtype=torch.int16, device=dev)
        cres = torch.empty((F, n, 2, 8, 8), dtype=torch.int16, device=dev)
        run("dt_stage_a", *(s[k] for k in PER_MB), *levels,
            *(tables[k] for k in LS_KEYS), yres, cres, F, n,
            *(st for t in levels for st in t.stride()[:2]))
        return yres, cres

    def deblock_params(kind, qp_y, sid, dis, offa, offb, mb_w, mb_h, c0, c1,
                       tables, t8=None, nz4=None, mv=None, rs=None):
        F, n = kind.shape
        prm = torch.empty((F, n, 192), dtype=torch.uint8, device=kind.device)
        run("dt_deblock_params", kind, qp_y, sid, dis, offa, offb, t8, nz4,
            mv, rs, *(tables[k] for k in ("alpha", "beta", "tc0", "qpc_tab")),
            prm, mb_w, mb_h, F, c0, c1)
        return prm

    made = {"densify.cu": ("densify", densify),
            "deblock.cu": ("deblock", deblock),
            "inter_mc.cu": ("inter_mc", inter_mc),
            "stage_a.cu": ("stage_a", stage_a),
            "deblock_params.cu": ("deblock_params", deblock_params)}
    return dict(made[k] for k in present), log


def earlier_builds(dirs):
    """``old_kernels`` of each of `dirs`, built side by side (one nvcc
    per source): {label: kernels}, the label a directory's name (made
    unique), in the order given."""
    from concurrent.futures import ThreadPoolExecutor

    labels = []
    for d in dirs:
        base = "".join(c if c.isalnum() or c in "-_." else "_" for c in
                       os.path.basename(os.path.normpath(d))) or "dir"
        label, k = base, 2
        while label in labels:
            label, k = f"{base}.{k}", k + 1
        labels.append(label)
    with ThreadPoolExecutor(len(dirs)) as pool:
        built = list(pool.map(old_kernels, dirs, labels))
    for label, d, (_, log) in zip(labels, dirs, built):
        print(f"ptxas of the earlier kernels of {label} ({d}):\n{log}")
        if ptxas_report(log):
            print(f"ptxas of the earlier B5 and B6 of {label}: "
                  f"{ptxas_report(log)}")
    return {label: fns for label, (fns, _) in zip(labels, built)}


def activity(seg):
    """(count, ms from the first start to the last end, ms summed, ms
    with at least one running) of device activities `seg`, in start
    order."""
    busy, cur = 0.0, None
    for e in seg:      # the union of the activities' intervals
        a, b = e.time_range.start, e.time_range.end
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0 if cur is None else cur[1] - cur[0]
    return (len(seg), (max(e.time_range.end for e in seg)
                       - seg[0].time_range.start) / 1e3 if seg else 0.0,
            sum(e.time_range.end - e.time_range.start for e in seg) / 1e3,
            busy / 1e3)


def device_kernels_in_profile(segments, names):
    """One torch.profiler session over `segments`, [(label, fn)], each
    fn() run and synchronised in a record_function range of its own,
    20 ms apart.  For each label and each of `names`, the device ms of
    each device kernel whose name holds it and whose start falls in the
    label's range (give or take 10 ms), in launch order, and under
    "by_device" their counts by card; kernels a CUDA graph replays are
    traced like the others.  Under the key "all", the
    label's device activities of any name (kernels, copies, fills) as
    ``activity`` gives them, and under "all_by_device" the same by card.  None
    when the profiler records no device time.  It must be the process's
    first session: a second one records no device events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in segments:
            with record_function(f"segment {label}"):
                fn()
                sync_all()
            time.sleep(0.02)
    from dryv_tpu_torch.kernels import RANGES

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = prof.events()
    kern = sorted((e for e in evs if e.device_type == cuda),
                  key=lambda e: e.time_range.start)
    if not kern:
        return None
    seg_ev = {e.name[len("segment "):]: e for e in evs
              if e.device_type == cpu and e.name.startswith("segment ")}
    starts = {k: e.time_range.start for k, e in seg_ev.items()}
    ranges = [e for e in evs if e.device_type == cpu
              and e.name in RANGES + GONE_RANGES]

    def launched(e):
        """The device activities launched inside CPU event e and its
        children, as the profiler links them."""
        return list(e.kernels) + [k for c in e.cpu_children
                                  for k in launched(c)]
    bounds = [starts[label] - 1e4 for label, _ in segments] + [float("inf")]
    out = {}
    for i, (label, _) in enumerate(segments):
        seg = [e for e in kern
               if bounds[i] <= e.time_range.start < bounds[i + 1]]
        out[label] = {n: [round((e.time_range.end - e.time_range.start)
                                / 1e3, 4) for e in seg if n in e.name]
                      for n in names}
        out[label]["by_device"] = {n: dict(sorted(collections.Counter(
            e.device_index for e in seg if n in e.name).items()))
            for n in names}
        out[label]["all"] = activity(seg)
        out[label]["all_by_device"] = {
            d: activity([e for e in seg if e.device_index == d])
            for d in sorted({e.device_index for e in seg})}
        # device ms and activities by RANGES name, for eager runs (a
        # replay's kernels link to its one graph launch)
        span = seg_ev[label].time_range
        by_range = {}
        for e in ranges:
            if span.start <= e.time_range.start <= span.end:
                ks = launched(e)
                ms, cnt = by_range.get(e.name, (0.0, 0))
                by_range[e.name] = (ms + sum(k.duration for k in ks) / 1e3,
                                    cnt + len(ks))
        out[label]["ranges"] = by_range
    return out


# one call inside spans_around: CUDA events around it, the host ms it
# took to return, a tag of its arguments and the stall counts it moved
Call = collections.namedtuple("Call", "e0 e1 host tag counts")
# the caching allocator's counters that move when a call takes card memory
# afresh (cudaMalloc: num_device_alloc, segment.all.allocated), gives it
# back (num_device_free), frees its cache and retries, or synchronises
# every stream; the pinned host allocator's cudaHostAlloc / cudaFreeHost;
# each where the installed torch has it
ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
              "num_sync_all_streams", "segment.all.allocated")
PINNED_KEYS = ("num_host_alloc", "num_host_free")


class Calls(list):
    """spans_around's ``Call``s; ``window`` holds the stall counts that
    the whole window moved."""
    window = None


class GcClock:
    """Python's garbage-collector passes while it sits in
    ``gc.callbacks``: their count, the full (generation 2) ones among them
    and the ms they took."""

    def __init__(self):
        self.n, self.n2, self.ms, self._t0 = 0, 0, 0.0, None

    def now(self):
        return self.n, self.n2, self.ms

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.n2 += info["generation"] == 2
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None


def stall_counts(caught):
    """The counters a host stall may move, now: ``ALLOC_KEYS`` of
    torch.cuda.memory_stats(), summed over the cards, ``PINNED_KEYS`` of
    torch.cuda.host_memory_stats() ("pinned ..."), and the synchronising
    calls torch.cuda's sync debug mode warned of in `caught` ("sync")."""
    m = [torch.cuda.memory_stats(i)
         for i in range(torch.cuda.device_count())]
    out = {k: sum(x[k] for x in m) for k in ALLOC_KEYS if k in m[0]}
    if hasattr(torch.cuda, "host_memory_stats"):
        h = torch.cuda.host_memory_stats()
        out.update({f"pinned {k}": h[k] for k in PINNED_KEYS if k in h})
    out["sync"] = sum("synchroniz" in str(w.message) for w in caught)
    return out


def count_delta(a, b):
    return {k: b[k] - a[k] for k in b if k in a}


def count_sum(dicts):
    out = collections.Counter()
    for d in dicts:
        out.update(d)
    return {k: round(v, 3) if isinstance(v, float) else v
            for k, v in out.items()}


@contextlib.contextmanager
def spans_around(owner, attr, tag=lambda *a: None):
    """Patches ``owner.attr`` so that every call records CUDA events
    around it, the host time it takes to return (its enqueue) and the
    stall counts (``stall_counts``, read outside the timed part, and the
    garbage collector's passes, full passes and ms inside it: "gc",
    "gc2", "gc_ms") it moved;
    yields the ``Calls``, whose ``window`` the counts of the whole block
    get.  Nothing synchronises inside; torch.cuda's sync debug mode warns
    there of each call that does."""
    spans = Calls()
    orig = getattr(owner, attr)
    clock = GcClock()
    caught = []

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        c0 = stall_counts(caught)
        g0 = clock.now()
        e0.record()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        host = (time.perf_counter() - t0) * 1e3
        g1 = clock.now()
        e1.record()
        c = count_delta(c0, stall_counts(caught))
        c.update(zip(("gc", "gc2", "gc_ms"), (b - a for a, b in zip(g0, g1))))
        spans.append(Call(e0, e1, host, tag(*a), c))
        return out

    setattr(owner, attr, timed)
    gc.callbacks.append(clock)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            w0 = stall_counts(caught)
            yield spans
            spans.window = count_delta(w0, stall_counts(caught))
            spans.window.update(zip(("gc", "gc2", "gc_ms"), clock.now()))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        gc.callbacks.remove(clock)
        setattr(owner, attr, orig)


@contextlib.contextmanager
def host_ms_of(owner, attr):
    """Patches ``owner.attr`` to append the host ms each call takes to
    the list it yields."""
    ms = []
    orig = getattr(owner, attr)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(owner, attr, timed)
    try:
        yield ms
    finally:
        setattr(owner, attr, orig)


def pooled(calls):
    """The ``Calls`` of several windows as one: every call, the windows'
    counts summed."""
    out = Calls(c for cs in calls for c in cs)
    out.window = count_sum(cs.window for cs in calls)
    return out


def span_summary(spans):
    """(device ms of each span, median device ms, median host ms, max host
    ms) of spans_around's spans, after the work they bracket has
    finished."""
    torch.cuda.synchronize()
    dev = [c.e0.elapsed_time(c.e1) for c in spans]
    host = [c.host for c in spans]
    return dev, statistics.median(dev), statistics.median(host), max(host)


def stall_line(label, spans, card, **extra):
    """One JSON line for a graphed path's calls: host ms to return, median
    and max over every call, beside the device span's median and max; the
    calls whose host ms exceeds the device span's median (they took longer
    to enqueue than the card to run) with their host ms; the stall counts
    in those calls, in the others and over the whole window; and `extra`.
    Returns the line's dict."""
    dev, d_med, h_med, h_max = span_summary(spans)
    stalled = [c for c in spans if c.host > d_med]
    clean = [c for c in spans if c.host <= d_med]
    line = {"path": label, "calls": len(spans),
            "host_ms_median": round(h_med, 4),
            "host_ms_max": round(h_max, 4),
            "device_ms_median": round(d_med, 4),
            "device_ms_max": round(max(dev), 4),
            "stalled": len(stalled),
            "stalled_host_ms": [round(c.host, 3) for c in stalled],
            "counts_stalled": count_sum(c.counts for c in stalled),
            "counts_other": count_sum(c.counts for c in clean),
            "counts_window": count_sum([spans.window]), **extra}
    print(f"per-call host ms of a graphed path: {json.dumps(line)}  "
          f"[{card}]")
    return line


# CUDA runtime calls host_calls_in_profile counts, besides every
# *Synchronize call
HOST_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMalloc",
              "cudaFree", "cudaHostAlloc", "cudaFreeHost")


# and besides those, for a sharded step's call: the copies and the event
# records and waits the host enqueues between and after the replays
STEP_CALLS = HOST_CALLS + ("cudaMemcpyAsync", "cudaMemcpy2DAsync",
                           "cudaMemcpyPeerAsync", "cudaEventRecord",
                           "cudaEventRecordWithFlags", "cudaStreamWaitEvent")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemcpyPeerAsync")


def host_calls_in_profile(fn, names=HOST_CALLS):
    """{CUDA runtime call: count} in a CPU-activity torch.profiler trace
    of fn() (the process's first profiler run took the device events):
    `names` (0 where none) and every call named *Synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    out = {k: calls.get(k, 0) for k in names}
    out.update({k: v for k, v in calls.items()
                if k.startswith("cuda") and k.endswith("Synchronize")})
    return out


def sync_calls(fn):
    """Calls that synchronise with the card during fn() (torch.cuda sync
    debug mode, warnings)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(x.message) for x in caught)


def sync_all():
    """Wait for every card's work."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def span_host_ms(fn, reps=3):
    """(median device span by CUDA events on the current card, median and
    max host time to return) ms of fn() over `reps` calls, after one warm
    call, every card idle at each start: the span runs from the current
    card's start to its end, after which a sharded call's work has met
    there."""
    fn()
    sync_all()
    dev, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        sync_all()
        dev.append(a.elapsed_time(b))
    return statistics.median(dev), statistics.median(host), max(host)


@contextlib.contextmanager
def slot_groups_of(size):
    """Every `size` neighbouring slots of a mesh axis form a group, and so
    a part of a sharded step with a graph of its own, as the slots of one
    card do on a mesh of several (the private seam
    ``parallel.mesh._slot_group``); None leaves the grouping by card."""
    from dryv_tpu_torch.parallel import mesh

    orig = mesh._slot_group
    if size is not None:
        mesh._slot_group = lambda i, d: (d, i // size)
    try:
        yield
    finally:
        mesh._slot_group = orig


def p_case(seed, ref, mb_w, mb_h):
    """A random P picture over the reference planes `ref` (y, cb, cr on
    one card): vectors within +-80 x +-48 pixels, 5% of blocks without a
    reference.  Returns the host arguments of a banded P recon call and
    its planes from B4 on the whole plane and the residual add."""
    from dryv_tpu_torch.kernels.inter import mc_frame

    dev = ref[0].device
    n = mb_w * mb_h
    prng = np.random.default_rng(seed)
    n4 = 16 * n
    pmv = np.stack([prng.integers(-4 * 80, 4 * 80 + 1, n4),
                    prng.integers(-4 * 48, 4 * 48 + 1, n4)], 1)
    prs = np.where(prng.random(n4) < 0.05, -1, 0)
    yres = prng.integers(-30, 31, (n, 16, 16))
    cres = prng.integers(-30, 31, (n, 2, 8, 8))
    py, pc = mc_frame(*(p[None] for p in ref),
                      torch.from_numpy(prs.astype(np.int8)).to(dev), None,
                      torch.from_numpy(pmv.astype(np.int16)).to(dev), None,
                      {"mode": 0}, mb_w, mb_h)
    ty = (py.int() + torch.from_numpy(yres).to(dev)).clamp(0, 255)
    tc = (pc.int() + torch.from_numpy(cres).to(dev)).clamp(0, 255)
    want = (ty.view(mb_h, mb_w, 16, 16).permute(0, 2, 1, 3)
            .reshape(16 * mb_h, 16 * mb_w),
            *(tc[:, p].reshape(mb_h, mb_w, 8, 8).permute(0, 2, 1, 3)
              .reshape(8 * mb_h, 8 * mb_w) for p in (0, 1)))
    host = [p.cpu().numpy() for p in ref]
    return (*host, pmv, prs, yres, cres), [w.to(torch.uint8) for w in want]


def sharded_paths(frames, sps, p_cases):
    """The sharded paths over a mesh of 4 slots: {name: (call,
    step_args, frames_of)}, call(devs, graph, i) -> the frames' planes as
    numpy (y, cb, cr) per frame, cropped, for input set i (0: the
    pictures in order, 1: reversed; P recon: picture i),
    step_args(devs, i) -> (key, maker, host inputs) of that call's
    step, and frames_of(planes) -> the frames of the step's results
    `planes` as call gives them.  Run objects are made anew for each
    call; their steps persist in ``parallel.STEPS`` by key."""
    from dryv_tpu_torch import parallel
    from dryv_tpu_torch.decoder import DecodedFrame

    def order(i):
        return frames if i == 0 else frames[::-1]

    def crop(planes):
        return [(c.y, c.cb, c.cr) for c in
                (DecodedFrame(*p).crop(sps) for p in zip(*planes))]

    def host(planes):
        return [p.cpu().numpy() if torch.is_tensor(p) else p
                for p in planes]

    def stack(planes):
        return crop(host(planes))[:len(frames)]

    def mesh(axes, devs):
        return parallel.make_mesh(axes, devs)

    def gop(axes):
        return (lambda devs, g, i: crop(parallel.decode_gop_sharded(
                    order(i), mesh(axes, devs), graph=g)),
                lambda devs, i: parallel.gop.step_args(order(i),
                                                       mesh(axes, devs)),
                stack)

    def band_gop(devs, g):
        return parallel.make_banded_gop_fn(mesh({"band": 4}, devs), MB_W,
                                           MB_H, 16, Fi=4, graph=g)

    def frame(axes):
        def run(devs, g):
            return parallel.make_banded_frame_fn(mesh(axes, devs), MB_W, MB_H,
                                                 graph=g)
        return (lambda devs, g, i: crop([p[None] for p in host(
                    run(devs, g)(order(i)[0], device_out=True))]),
                lambda devs, i: run(devs, True).step_args(order(i)[0]),
                stack)

    def p_run(devs, g):
        return parallel.make_banded_p_recon_fn(mesh({"band": 4}, devs), MB_W,
                                               MB_H, apron=64, graph=g)

    return {
        "decode_gop_sharded {gop: 4}": gop({"gop": 4}),
        "make_banded_gop_fn {band: 4}": (
            lambda devs, g, i: crop(host(band_gop(devs, g)(
                order(i), device_out=True))),
            lambda devs, i: band_gop(devs, True).step_args(order(i)),
            stack),
        "make_banded_frame_fn {band: 4}": frame({"band": 4}),
        "make_banded_p_recon_fn {band: 4}": (
            lambda devs, g, i: [tuple(host(p_run(devs, g)(
                *p_cases[i][0], device_out=True)))],
            lambda devs, i: p_run(devs, True).step_args(*p_cases[i][0]),
            lambda planes: [tuple(host(planes))]),
        "decode_gop_sharded {gop: 2, band: 2}": gop({"gop": 2, "band": 2}),
        "make_banded_frame_fn {gop: 2, band: 2}": frame({"gop": 2,
                                                        "band": 2}),
    }


def sharded_routes(card, label, devs, paths, want, size=None):
    """Every path of ``sharded_paths`` over the 4 slots `devs` (their
    slots cut in groups of `size` through ``slot_groups_of``, or grouped
    by card), graphed, eager, graphed on the other inputs (the first
    call's planes held), eager on them: each graphed call a step of one
    part per group (one graph per part), counted in no eager call, each
    eager call counted once; every result bit-exact to the others and to
    want[name][i] (the one-card graphed route's planes, checked against
    native C++ or B4 on the whole plane).  Fails on any difference."""
    from dryv_tpu_torch import parallel

    ng = {}
    for name, (call, step_args, _) in paths.items():
        with slot_groups_of(size):
            key = step_args(devs, 0)[0]
            held = []
            for g, i in ((True, 0), (False, 0), (True, 1), (False, 1)):
                e0 = parallel.STEPS.eager
                got = call(devs, g, i)
                if parallel.STEPS.eager - e0 != (not g):
                    fail(f"{name} over {label}, graph={g}: "
                         f"{parallel.STEPS.eager - e0} eager calls counted")
                for f, (a, b) in enumerate(zip(got, want[name][i])):
                    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                        fail(f"{name} over {label}, graph={g}, input set "
                             f"{i}: frame {f} differs from the one-card "
                             f"graphed route")
                if len(got) != len(want[name][i]):
                    fail(f"{name} over {label}: {len(got)} frames")
                held.append(got)
            for f, (a, b) in enumerate(zip(held[0], want[name][0])):
                if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                    fail(f"{name} over {label}: the first graphed call's "
                         f"frame {f} changed under later calls")
        step = parallel.STEPS.steps.get(key)
        parts = [] if step is None else step.split.parts
        devs_of = [str(d) for d, _, _ in parts]
        if step is None or (step.devices[0].type == "cuda"
                            and len(step.graphs or ()) != len(parts)):
            fail(f"{name} over {label}: no graphed step of its key")
        ng[name] = len(parts)
        print(f"{name} over {label}: graphed ({len(parts)} parts on "
              f"{devs_of}, one graph each) and eager, on two input sets, "
              f"bit-exact to each other and to the one-card graphed route "
              f"(native C++ / B4 on the whole plane)")
    return ng


def one_card_wants(paths, refs, p_cases):
    """The planes of each path of ``sharded_paths`` on the one-card
    graphed route (['cuda:0'] * 4, one group), for both input sets, each
    held against `refs` (native C++, per frame, the pictures in order)
    or B4 on the whole plane."""
    want = {}
    for name, (call, _, _) in paths.items():
        want[name] = []
        for i in (0, 1):
            got = call(ONE_CARD, True, i)
            if "p_recon" in name:
                exp = [tuple(w.cpu().numpy() for w in p_cases[i][1])]
            else:
                exp = refs if i == 0 else refs[::-1]
                exp = exp[:len(got)]
            if len(got) != len(exp) or not all(
                    np.array_equal(x, y) for a, b in zip(got, exp)
                    for x, y in zip(a, b)):
                fail(f"{name} over ['cuda:0'] * 4, graphed, input set {i}, "
                     f"differs from native C++ / B4 on the whole plane")
            want[name].append(got)
    print(f"one-card graphed route (['cuda:0'] * 4, one graph a step) of "
          f"{len(paths)} sharded paths on two input sets: bit-exact to native "
          f"C++ / B4 on the whole plane")
    return want


def kernels_on_cards(card, cards):
    """B2 at 120x68 MBs x 4 (decode_gop_sharded's F_local on 4 slots), B2b
    at 120x17 x 4 under a band with a halo, and B4 on a band of 17 MB rows
    with 64-row aprons (banded P recon's call) on every card, bit-exact to
    their plain versions (run once, on the first card)."""
    from dryv_tpu_torch.kernels.inter import mc_frame, mc_frame_wire_plain
    from dryv_tpu_torch.kernels.wavefront import (intra_recon,
                                                  intra_recon_plain,
                                                  recon_inputs)
    from dryv_tpu_torch.tables import decoder_tables

    rng = np.random.default_rng(99)
    cases = []
    for rows, below in ((MB_H, False), (17, True)):
        s_np, yz, c = random_syntax(rng, MB_W, rows, 4, below_band=below)
        halo = (torch.from_numpy(rng.integers(0, 256, (4, 16 * MB_W))
                                 .astype(np.uint8)),
                torch.from_numpy(rng.integers(0, 256, (4, 2, 8 * MB_W))
                                 .astype(np.uint8))) if below else None
        ins = recon_inputs({k: torch.from_numpy(v) for k, v in s_np.items()},
                           torch.from_numpy(yz), torch.from_numpy(c))
        cases.append((f"intra_wavefront{'_banded' if below else ''} at "
                      f"{MB_W}x{rows} x 4",
                      lambda d, a, tab, rows=rows: (
                          intra_recon(*a[:-2], tab, MB_W, rows,
                                      halo=a[-2:] if a[-1] is not None
                                      else None)),
                      lambda d, a, tab, rows=rows: intra_recon_plain(
                          *a[:-2], tab, MB_W, rows,
                          a[-2:] if a[-1] is not None else None),
                      [*ins, *(halo or (None, None))]))
    hb, A = 17, 64
    n4 = 16 * hb * MB_W
    ext = [torch.from_numpy(rng.integers(0, 256, shp).astype(np.uint8))
           for shp in ((1, 16 * hb + 2 * A, 16 * MB_W),
                       (1, 8 * hb + A, 8 * MB_W), (1, 8 * hb + A, 8 * MB_W))]
    rs = torch.from_numpy(np.where(rng.random(n4) < 0.05, -1, 0)
                          .astype(np.int8))
    mv = torch.from_numpy(np.stack([rng.integers(-320, 321, n4),
                                    rng.integers(-192, 193, n4)], 1)
                          .astype(np.int16))
    b4 = (*ext, rs, None, mv, None, {"mode": 0}, MB_W, hb)
    cases.append((f"inter_mc on a band of {MB_W}x{hb} with {A}-row aprons",
                  lambda d, a, tab: mc_frame(*a, row0=A // 4),
                  lambda d, a, tab: mc_frame_wire_plain(*a, row0=A // 4),
                  b4))

    def on(a, d):
        return [x.to(d) if torch.is_tensor(x) else x for x in a]

    for label, kernel, plain, args in cases:
        d0 = torch.device(cards[0])
        want = plain(d0, on(args, d0), decoder_tables(d0))
        for c in dict.fromkeys(cards):
            d = torch.device(c)
            got = kernel(d, on(args, d), decoder_tables(d))
            torch.cuda.synchronize(d)
            if any(not torch.equal(g.to(d0), w) for g, w in zip(got, want)):
                fail(f"{label} on {c} differs from its plain version")
        print(f"kernel {label}: bit-exact to its plain version on "
              f"{list(dict.fromkeys(cards))}  [{card}]")


def card_census_segments(label, call, devs, size=None):
    """Census segments of one sharded call over `devs`, graphed and eager
    (slots cut by ``slot_groups_of(size)``), and the eager call's wrapper
    counts of B2 + B2b and of B4, taken here."""
    from dryv_tpu_torch.kernels.inter import mc_frame
    from dryv_tpu_torch.kernels.wavefront import intra_recon

    def run(graph):
        def fn():
            with slot_groups_of(size):
                call(devs, graph, 0)
        return fn

    before = [intra_recon.launches + intra_recon.banded_launches,
              mc_frame.launches]
    run(False)()
    sync_all()
    eager = {"intra_rows_kernel": intra_recon.launches
             + intra_recon.banded_launches - before[0],
             "inter_mc_kernel": mc_frame.launches - before[1]}
    return [(f"{label}, graphed", run(True)), (f"{label}, eager", run(False))
            ], eager


def check_card_census(card, trace, entries):
    """entries: (label, eager wrapper counts) of ``card_census_segments``;
    the graphed call's device kernels per card in the trace must equal
    the eager call's, and their sums the eager wrapper counts."""
    for label, eager in entries:
        g, e = ({n: trace[f"{label}, {r}"]["by_device"][n] for n in eager}
                for r in ("graphed", "eager"))
        act = trace[f"{label}, graphed"]["all_by_device"]
        print(f"device kernels per card of {label}, in the census trace: "
              f"graphed {g}, eager {e}; eager wrapper counts {eager}; "
              f"graphed, each card's device activities (count, ms first "
              f"start to last end, ms summed, ms busy): " + ", ".join(
                  f"cuda:{d} ({n}, {sp:.3f}, {sm:.3f}, {b:.3f})"
                  for d, (n, sp, sm, b) in act.items()) + f"  [{card}]")
        if g != e or {n: sum(c.values()) for n, c in g.items()} != eager:
            fail(f"{label}: the graphed call launched other kernels per "
                 f"card than the eager one")


def cards_numbers(card, cards, paths):
    """For every path, the one-card route (['cuda:0'] * 4) and the route
    over `cards`, in turns (one card, cards, cards, one card): the step
    alone with its inputs loaded, graphed (the replays and the planes'
    meeting on the first card) and eager (its parts op by op on inputs
    already on the cards), and the whole call (FrameSyntax or host arrays
    in, planes out) graphed and eager, each as device span (CUDA events
    on cuda:0, every card idle at the start, so from the first card's
    fork to the join) and host ms to return; the graphs a graphed call
    replays."""
    from dryv_tpu_torch import parallel

    n = len(set(cards))
    routes = {"1 card": ONE_CARD, f"{n} cards": cards}
    for name, (call, step_args, _) in paths.items():
        t = {}
        for r in list(routes) + list(routes)[::-1]:
            devs = routes[r]
            key, make, xs = step_args(devs, 0)
            with parallel.STEPS.hold(key, make, xs) as st:
                st.load(*xs)
                n_graphs = len(st.graphs or ())
                g_step = span_host_ms(st)
            split = make()
            on = [d for d, k, _ in split.parts for _ in range(k)]
            ins = [x.to(d) for x, d in zip(xs, on)]
            e_step = span_host_ms(lambda: split(*ins))
            g_call = span_host_ms(lambda: call(devs, True, 0), 2)
            e_call = span_host_ms(lambda: call(devs, False, 0), 2)
            t.setdefault(r, []).append((g_step, e_step, g_call, e_call,
                                        n_graphs))
        cols = ("step graphed", "step eager", "whole call graphed",
                "whole call eager")
        print(f"{name}, {' / '.join(routes)} in turns, device span (host "
              f"ms to return, median / max), median of 3 (whole calls: 2): "
              + "; ".join(
                  f"{c} " + ", ".join(f"{r} " + " / ".join(
                      "{:.3f} ({:.3f} / {:.3f})".format(*v[j]) for v in t[r])
                      for r in routes) for j, c in enumerate(cols))
              + "; graphs replayed a call: " + ", ".join(
                  f"{r} {t[r][0][4]}" for r in routes) + f"  [{card}]")


def back_to_back(card, cards, paths, want):
    """Every path's graphed step over `cards`, its two input sets
    alternated four times (P recon: its two pictures), each call's inputs
    loaded from pinned host memory and its results held, with no
    synchronisation between the calls; then each result bit-exact to the
    one-card graphed route (itself checked against native C++ or B4 on
    the whole plane).  A ghost band or a halo read before its load, or a
    load or replay overwriting what an earlier call still reads, shows
    here.  Fails on any difference."""
    from dryv_tpu_torch.parallel import mesh

    for name, (_, step_args, frames_of) in paths.items():
        args = [step_args(cards, i) for i in (0, 1)]
        pinned = [[x.pin_memory() for x in xs] for _, _, xs in args]
        sync_all()
        held = [(i, mesh.run_step(args[i][0], args[i][1], pinned[i]))
                for i in (0, 1) * 4]
        sync_all()
        for k, (i, planes) in enumerate(held):
            got = frames_of(planes)
            if len(got) != len(want[name][i]) or not all(
                    np.array_equal(x, y) for a, b in zip(got, want[name][i])
                    for x, y in zip(a, b)):
                fail(f"{name} over {cards}, graphed, call {k} of 8 back to "
                     f"back (input set {i}), differs from the one-card "
                     f"graphed route")
        print(f"{name} over {cards}: 8 graphed calls back to back, input "
              f"sets 0 and 1 in turns, pinned inputs, no synchronisation "
              f"between them, each result held and bit-exact to the "
              f"one-card graphed route (native C++ / B4 on the whole plane)"
              f"  [{card}]")


def in_graphs(key):
    """Whether the step of `key` in ``parallel.STEPS`` runs its exchanges
    inside its graphs: its ``Split`` has neither ``before`` nor ``after``
    (an earlier tree's, run for comparison, has one or both, and copies
    between and after the replays by design)."""
    from dryv_tpu_torch import parallel

    split = parallel.STEPS.steps[key].split
    return all(getattr(split, a, None) is None for a in ("before", "after"))


def card_stalls(card, cards, paths):
    """For every path over the one-card route and over `cards`, graphed:
    the per-call host ms line (``stall_line``) of the step's call
    (``graphs.Step.__call__``: its replays and its results' copy, inputs
    loaded before it) over 8 calls, input sets in turns, and of the whole
    call (FrameSyntax or host arrays in, planes out) over 8 calls; over
    `cards` the step's calls must take no cudaMalloc (``in_graphs``
    steps)."""
    from dryv_tpu_torch import graphs
    from dryv_tpu_torch.parallel import mesh

    n = len(set(cards))
    for name, (call, step_args, _) in paths.items():
        for label, devs in (("1 card", ONE_CARD), (f"{n} cards", cards)):
            args = [step_args(devs, i) for i in (0, 1)]
            mesh.run_step(*args[0])
            sync_all()
            with spans_around(graphs.Step, "__call__") as spans:
                for k in range(8):
                    mesh.run_step(*args[k % 2])
            line = stall_line(f"{name} over {label}, graphed step", spans,
                              card)
            if devs is cards and in_graphs(args[0][0]) and line[
                    "counts_window"].get("num_device_alloc", 0):
                fail(f"{name} over {cards}: the graphed step's calls took "
                     f"{line['counts_window']['num_device_alloc']} "
                     f"cudaMalloc")
            whole = types.SimpleNamespace(call=lambda i: call(devs, True, i))
            sync_all()
            with spans_around(whole, "call") as spans:
                for k in range(8):
                    whole.call(k % 2)
            stall_line(f"{name} over {label}, graphed whole call", spans,
                       card)


def step_host_calls(card, cards, paths):
    """The CUDA runtime calls of one graphed step over `cards` (its
    inputs' loads and its call, inside one hold; CPU-activity
    torch.profiler) for every path, beside its loads and results: a call
    must launch one graph per part (a card) and copy nothing outside the
    graphs but its loads and its results (``in_graphs`` steps; an
    earlier tree's counts print ungated)."""
    from dryv_tpu_torch import parallel

    for name, (_, step_args, _) in paths.items():
        key, make, xs = step_args(cards, 0)

        def one():
            with parallel.STEPS.hold(key, make, xs) as st:
                st.load(*xs)
                return st()

        res = one()
        st = parallel.STEPS.steps[key]
        calls = host_calls_in_profile(one, STEP_CALLS)
        parts = len(st.split.parts)
        copies = sum(calls[k] for k in COPY_CALLS)
        gated = in_graphs(key)
        print(f"{name} over {cards}: CUDA runtime calls of one graphed "
              f"step (load + call, CPU-activity torch.profiler) "
              f"{json.dumps(calls)}; {parts} parts, {len(xs)} loads, "
              f"{len(res)} results; copies outside the graphs {copies}"
              f"{'' if gated else ' (an earlier tree: not gated)'}  "
              f"[{card}]")
        if gated and (calls["cudaGraphLaunch"] != parts
                      or copies > len(xs) + len(res)):
            fail(f"{name} over {cards}: a graphed step launched "
                 f"{calls['cudaGraphLaunch']} graphs for {parts} parts or "
                 f"made {copies} copies for {len(xs)} loads and "
                 f"{len(res)} results")


def call_phases(card, cards, paths):
    """Each path's graphed whole call split by phase, on the one-card
    route and over `cards`, median host ms of 4 calls (input sets in
    turns): stacking the host inputs (``step_args``), their loads,
    the step's call (replays and results' copy enqueued), the wait for
    every card, and the results' copy to the host."""
    from dryv_tpu_torch import parallel

    n = len(set(cards))
    cols = ("stack", "load", "step call", "device wait", "to host")
    for name, (_, step_args, _) in paths.items():
        out = {}
        for label, devs in (("1 card", ONE_CARD), (f"{n} cards", cards)):
            ms = []
            for k in range(4):
                sync_all()
                t = [time.perf_counter()]
                key, make, xs = step_args(devs, k % 2)
                t.append(time.perf_counter())
                with parallel.STEPS.hold(key, make, xs) as st:
                    st.load(*xs)
                    t.append(time.perf_counter())
                    planes = st()
                t.append(time.perf_counter())
                sync_all()
                t.append(time.perf_counter())
                [p.cpu() for p in planes]
                t.append(time.perf_counter())
                ms.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
            out[label] = [statistics.median(c) for c in zip(*ms)]
        print(f"{name}, graphed whole call by phase, median host ms of 4 "
              f"(" + ", ".join(cols) + "): " + "; ".join(
                  f"{label} " + ", ".join(f"{v:.3f}" for v in vals)
                  for label, vals in out.items()) + f"  [{card}]")


# the small graphs of replay_costs: one kernel, and beside it the nodes a
# part's graph holds over several cards
REPLAY_VARIANTS = ("kernel", "kernel + copy on its card",
                   "kernel + peer copy", "kernel + external event record",
                   "kernel + external event wait", "wait + kernel + peer "
                   "copy + record")


def replay_costs(card, cards, paths, rounds=200):
    """Host ms of a graph launch (``CUDAGraph.replay`` under
    ``torch.cuda.device`` of its card, as ``graphs.Step`` replays a part)
    on each of `cards`, median of `rounds` rounds that launch one graph a
    card in card order, for small graphs: one kernel (a 16 KiB add), and
    beside it a 16 KiB copy on its card, a 16 KiB copy into another card
    (``graphs.peer_copy``), an external event record, a wait on an
    external event recorded on another card, and all of these as a part
    over several cards holds them; the host ms of a device switch alone
    and of a stream's wait on an external event.  Then, for every path's
    graphed step over `cards` and on one card, the host ms of each part's
    replay and of the rest of the step's call (20 calls, medians)."""
    from dryv_tpu_torch import graphs, parallel
    from dryv_tpu_torch.parallel import mesh

    devs = [torch.device(d) for d in dict.fromkeys(cards)]
    mesh.enable_peers(devs)
    # an earlier tree, run for comparison, has it in mesh
    peer_copy = getattr(graphs, "peer_copy", None) or mesh.peer_copy
    src = {d: torch.zeros(1 << 14, dtype=torch.uint8, device=d) for d in devs}
    dst = {d: torch.zeros(1 << 14, dtype=torch.uint8, device=d) for d in devs}
    rec = {d: torch.cuda.Event(external=True) for d in devs}
    stale = {d: torch.cuda.Event(external=True) for d in devs}
    for d in devs:
        stale[d].record(torch.cuda.current_stream(d))
    made = {}
    for d in devs:
        other = devs[1] if d == devs[0] else devs[0]
        for v in REPLAY_VARIANTS:
            with torch.cuda.device(d):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=graphs._capture_stream(d)):
                    cur = torch.cuda.current_stream()
                    if "wait" in v:
                        cur.wait_event(stale[other])
                    src[d].add_(1)
                    if v == "kernel + copy on its card":
                        peer_copy(dst[d], src[d])
                    elif "peer copy" in v:
                        peer_copy(dst[other], src[d])
                    if "record" in v:
                        rec[d].record(cur)
            made[d, v] = g
    sync_all()

    def rounds_of(fn):
        ms = {d: [] for d in devs}
        for r in range(rounds):
            for d in devs:
                t0 = time.perf_counter()
                fn(d)
                ms[d].append((time.perf_counter() - t0) * 1e3)
            if r % 50 == 49:
                sync_all()
        sync_all()
        return [round(statistics.median(ms[d]), 4) for d in devs]

    def launch(v):
        def fn(d):
            with torch.cuda.device(d):
                made[d, v].replay()
        return fn

    out = {v: rounds_of(launch(v)) for v in REPLAY_VARIANTS}

    def switch(d):
        with torch.cuda.device(d):
            pass

    out["device switch alone"] = rounds_of(switch)
    out["first card's stream waits on an external event"] = rounds_of(
        lambda d: torch.cuda.current_stream(devs[0]).wait_event(stale[d]))
    print(f"graph launch host ms on cards {[str(d) for d in devs]} "
          f"(median of {rounds} rounds, one launch a card a round): "
          f"{json.dumps(out)}  [{card}]")
    del made
    n = len(devs)
    for name, (_, step_args, _) in paths.items():
        res = {}
        for label, on in (("1 card", ONE_CARD), (f"{n} cards", cards)):
            key, make, xs = step_args(on, 0)
            mesh.run_step(key, make, xs)
            sync_all()
            st = parallel.STEPS.steps[key]
            part_of = {id(g): i for i, g in enumerate(st.graphs)}
            per = [[] for _ in st.graphs]
            with host_ms_of(graphs.Step, "__call__") as call_ms:
                orig = torch.cuda.CUDAGraph.replay

                def timed(g):
                    t0 = time.perf_counter()
                    orig(g)
                    per[part_of[id(g)]].append(
                        (time.perf_counter() - t0) * 1e3)

                torch.cuda.CUDAGraph.replay = timed
                try:
                    for _ in range(20):
                        mesh.run_step(key, make, xs)
                finally:
                    torch.cuda.CUDAGraph.replay = orig
            sync_all()
            replays = [statistics.median(m) for m in per]
            whole = statistics.median(call_ms)
            res[label] = {"replay_ms_by_part": [round(x, 4)
                                                for x in replays],
                          "call_ms": round(whole, 4),
                          "rest_of_call_ms": round(whole - sum(replays), 4)}
        print(f"{name}, graphed step's call, host ms by part (median of 20 "
              f"calls; the part's devices "
              f"{[str(d) for d, _, _ in st.split.parts]}): "
              f"{json.dumps(res)}  [{card}]")


def multi_card_phase(card, cards, paths, want, gop_stream, nthreads):
    """The sharded paths over the 4 slots `cards` (several cards, repeated
    when fewer than 4), graphed and eager in turns against the one-card
    graphed route, native C++ and B4 on the whole plane, and graphed back
    to back with no synchronisation; the dry run over cards * 2; their
    numbers beside the one-card route's (in turns, per-call host ms,
    whole calls by phase, replay costs).  Returns the census segments
    and entries, and the host-side launch counts to take after the
    census."""
    from dryv_tpu_torch import parallel

    n = len(set(cards))
    label = f"{cards}"
    sharded_routes(card, label, cards, paths, want)
    back_to_back(card, cards, paths, want)
    e0 = parallel.STEPS.eager
    parallel.dryrun_multichip(8, cards * 2, stream=gop_stream,
                              n_threads=nthreads)
    if parallel.STEPS.eager != e0:
        fail("dryrun_multichip over several cards counted eager calls")
    cards_numbers(card, cards, paths)
    card_stalls(card, cards, paths)
    call_phases(card, cards, paths)
    replay_costs(card, cards, paths)
    segments, entries = [], []
    for name, (call, _, _) in paths.items():
        segs, eager = card_census_segments(f"{name} over {n} cards", call,
                                           cards)
        segments += segs
        entries.append((f"{name} over {n} cards", eager))

    def host_side():
        for name, (call, _, _) in paths.items():
            print(f"{name}: CUDA runtime calls of a graphed whole call "
                  f"(CPU-activity torch.profiler): 1 card "
                  f"{host_calls_in_profile(lambda: call(ONE_CARD, True, 0))}"
                  f", {n} cards "
                  f"{host_calls_in_profile(lambda: call(cards, True, 0))}")
        step_host_calls(card, cards, paths)
        st = parallel.STEPS.stats()
        print(f"captured steps of the sharded paths: {json.dumps(st)}  "
              f"[{card}]")
    return segments, entries, host_side


def multichip_only(card, name, cards, gop_stream, nthreads, phase,
                   phase_s):
    """``--multichip``: B2, B2b and B4 against their plain versions on
    every card, the sharded paths over `cards` (``multi_card_phase``),
    the census of their launches per card (the run's one device trace),
    then their host-side launch counts; ends with the result line."""
    from dryv_tpu_torch.native.full import decode_annexb_native
    from dryv_tpu_torch.pipeline import frames_from_stream

    phase("3 kernels on every card")
    kernels_on_cards(card, cards)
    phase("9-11 sharded paths over several cards")
    frames, sps = frames_from_stream(gop_stream, n_threads=nthreads)
    refs = [(r.y, r.cb, r.cr) for r in
            decode_annexb_native(gop_stream, n_threads=nthreads)]
    rng = np.random.default_rng(2024)
    ref = [torch.from_numpy(rng.integers(0, 256, shp).astype(np.uint8))
           .to("cuda:0") for shp in ((16 * MB_H, 16 * MB_W),
                                     (8 * MB_H, 8 * MB_W),
                                     (8 * MB_H, 8 * MB_W))]
    p_cases = [p_case(seed, ref, MB_W, MB_H) for seed in (5, 6)]
    paths = sharded_paths(frames, sps, p_cases)
    want = one_card_wants(paths, refs, p_cases)
    segments, entries, host_side = multi_card_phase(
        card, cards, paths, want, gop_stream, nthreads)
    phase("12 census")
    trace = device_kernels_in_profile(segments, ("intra_rows_kernel",
                                                 "inter_mc_kernel"))
    if trace is None:
        fail("the profiler recorded no device time")
    check_card_census(card, trace, entries)
    host_side()
    phase("end")
    print(f"seconds from the start at which each phase began: "
          f"{json.dumps(phase_s)}  [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", metavar="DIR", nargs="+",
                    help="time earlier B1, B3 and B4 (those of "
                         "DIR/densify.cu, DIR/deblock.cu, DIR/inter_mc.cu "
                         "that DIR holds, with DIR/common.cuh) in turns "
                         "with the current ones; B1 and B3 from the first "
                         "DIR that holds them, B4 from each")
    ap.add_argument("--multichip", action="store_true",
                    help="only the build, B2, B2b and B4 against their plain "
                         "versions on every card, and the sharded paths over "
                         "the first four cards (needs two or more)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    from dryv_tpu_torch import _build, device_ipb_packed, gop_pipeline, \
        graphs, parallel, pipeline
    from dryv_tpu_torch.decoder import DecodedFrame
    from dryv_tpu_torch.device_ipb_packed import (
        PackedPictureDecoder, decode_annexb_device_packed)
    from dryv_tpu_torch.gop_pipeline import (PackedGopDecoder,
                                             decode_annexb_gop_pipelined)
    from dryv_tpu_torch.kernels.deblock import (deblock, deblock_params,
                                                deblock_params_plain,
                                                deblock_plain,
                                                deblock_precompute,
                                                pack_params)
    from dryv_tpu_torch.kernels.densify import densify, densify_plain
    from dryv_tpu_torch.kernels.inter import mc_frame, mc_frame_wire_plain
    from dryv_tpu_torch.kernels.transform import (LEVELS, stage_a,
                                                  stage_a_plain)
    from dryv_tpu_torch.kernels.wavefront import (intra_recon,
                                                  intra_recon_plain,
                                                  recon_inputs)
    from dryv_tpu_torch.native import build as host_build
    from dryv_tpu_torch.native.full import decode_annexb_native
    from dryv_tpu_torch.pipeline import (decode_annexb_fast,
                                         frames_from_stream, recon_syntax,
                                         tables_for)
    from dryv_tpu_torch.refimpl.transform import (level_scale_4x4,
                                                  level_scale_8x8)
    from dryv_tpu_torch.syntax import stack_frames, syntax_tensors
    from dryv_tpu_torch.tables import chroma_qp, decoder_tables
    from dryv_tpu_torch.testing.motion import (KINDS, full_pel_census,
                                               group_census)
    from dryv_tpu_torch.utils.obs import StageTimers

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    t_run = time.perf_counter()
    phase_s = {}     # seconds from the start at which each phase began

    def phase(label):
        phase_s[label] = round(time.perf_counter() - t_run, 1)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}")

    # ---- phase 2: build the host library and every kernel from the
    # checkout's sources
    phase("2 build")
    t0 = time.perf_counter()
    print(f"host library: {host_build.build(force=True).name}")
    print(f"build: C++ host library {time.perf_counter() - t0:.2f} s "
          f"(g++, one process per source)  [{card}]")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _build.build(verbose=True)
    print(buf.getvalue())
    _build.lib()
    print(f"ptxas of B5 and B6 (B5's ring and tiles are dynamic shared "
          f"memory): {ptxas_report(buf.getvalue())}  [{card}]")
    print(f"build: CUDA kernels {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a, one process per source)  [{card}]")
    old = {}       # B1 and B3 of the first DIR that holds them
    old_b4 = {}    # label -> each DIR's B4
    if args.compare:
        t0 = time.perf_counter()
        for label, fns in earlier_builds(args.compare).items():
            for k, fn in fns.items():
                old.setdefault(k, fn)
            if "inter_mc" in fns:
                old_b4[label] = fns["inter_mc"]
        print(f"build: earlier kernels from {' '.join(args.compare)} "
              f"{time.perf_counter() - t0:.2f} s (one nvcc per source)  "
              f"[{card}]")

    n_cards = torch.cuda.device_count()
    print(f"peer access (row: card, column: peer; "
          f"torch.cuda.can_device_access_peer): " + json.dumps(
              [[int(i == j or torch.cuda.can_device_access_peer(i, j))
                for j in range(n_cards)] for i in range(n_cards)]))
    cards = ([f"cuda:{i}" for i in range(min(4, n_cards))] * 4)[:4]
    nthreads = os.cpu_count() or 1
    gop_stream = open("benchdata/bench1080p_gop16.264", "rb").read()
    # this run makes up to 18 sharded keys (one-card, seam and multi-card
    # groupings) and its census replays their steps as made, so none may
    # be released before it: the run's own bound, above the default 8
    parallel.STEPS.max_keys = 32
    if args.multichip:
        if n_cards < 2:
            fail("--multichip needs two or more cards")
        multichip_only(card, name, cards, gop_stream, nthreads, phase,
                       phase_s)
        return

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

    def b4_census(a):
        """MBs of one B4 call's picture by their groups over its lists."""
        lists = [(a[3], a[5])] + ([(a[4], a[6])] if a[4] is not None
                                  else [])
        return group_census([(r.cpu().numpy(), v.cpu().numpy())
                             for r, v in lists], a[8], a[9])

    def b4_in_turns(label, a, bound, quiet=False):
        """Every earlier B4 (--compare) and this one on one call's
        arguments: bit-exact to each other, timed in turns (the earlier
        ones in order, this one twice, the earlier ones reversed), beside
        the bound.  Returns {build: mean ms}, "this" for this B4."""
        want = mc_frame(*a)
        for k, fn in old_b4.items():
            if max_err(fn(*a), want):
                fail(f"inter_mc {label}: the earlier B4 of {k} and the "
                     f"current differ")
        order = [*old_b4, "this", "this", *reversed(old_b4)]
        t = {}
        for k in order:
            fn = mc_frame if k == "this" else old_b4[k]
            t.setdefault(k, []).append(cuda_ms(lambda: fn(*a), 20))
        bd, by = bound
        if not quiet:
            print(f"inter_mc {label}, CUDA events, mean of 20, in turns: "
                  + ", ".join(f"{'this B4' if k == 'this' else k} "
                              f"{v[0]:.4f} / {v[1]:.4f} ms"
                              for k, v in t.items())
                  + f"; bound {bd:.4f} ms ({by}): " + ", ".join(
                      f"{k} {bd / statistics.mean(v):.1%}"
                      for k, v in t.items())
                  + f" of it; bit-exact to each other  [{card}]")
        return {k: statistics.mean(v) for k, v in t.items()}

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
    phase("3 kernels")
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
        if old and "densify" in old and nf == F:
            if not torch.equal(old["densify"](bmp, vals), out_k):
                fail(f"densify W={W}: the earlier B1 and the current differ")
            in_turns(f"densify bmp [{F}, {npad}, 51] vals [{F}, {npad}, "
                     f"{W}]", "B1",
                     lambda: cuda_ms(lambda: old["densify"](bmp, vals), 20),
                     lambda: cuda_ms(lambda: densify(bmp, vals), 20), 20)

    # B5 at the batched path's shape (F = 16, levels as column slices of
    # the dense [F, 8192, 408] rows: one bulk copy a tile) and at F = 1
    # (the per-picture and I/P/B paths), each also on separate contiguous
    # segments (the per-picture syntax: one bulk copy a segment): random
    # kinds (I4, I8, I16, PCM), QP 0..51, chroma QP offsets -12 and +12,
    # random LevelScale lists of each list, levels in [-64, 64] with half
    # the 4x4 luma blocks all 0; at F = 1 also with the coded flags nz4
    # (the I/P/B step's call).  With an earlier B5 (--compare), each
    # shape in turns with it, bit-exact to it
    n_mb = MB_W * MB_H
    rl = np.random.default_rng(12)
    w4 = [level_scale_4x4(rl.integers(4, 64, (4, 4))) for _ in range(3)]
    lists_a = decoder_tables(dev, *w4, level_scale_8x8(
        rl.integers(4, 64, (8, 8))))
    b5_cases = {}
    for key, nf in (("stage_a", F), ("stage_a_f1", 1)):
        qp = torch.from_numpy(rng.integers(0, 52, (nf, n_mb))
                              .astype(np.int32)).to(dev)
        lv = rng.integers(-64, 65, (nf, npad, 408))
        lv[..., :256].reshape(nf, npad, 16, 16)[
            rng.random((nf, npad, 16)) < 0.5] = 0
        dense = torch.from_numpy(lv.astype(np.int16)).to(dev)
        sa = {"kind": torch.from_numpy(rng.integers(0, 4, (nf, n_mb))
                                       .astype(np.int32)).to(dev),
              "qp_y": qp,
              "qp_cb": chroma_qp(qp, -12, tables["qpc_tab"]).contiguous(),
              "qp_cr": chroma_qp(qp, 12, tables["qpc_tab"]).contiguous()}
        col = 0
        for k, width in LEVELS:
            sa[k] = dense[:, :n_mb, col:col + width]
            col += width
        b5_cases[key] = sa
        b5_cases[f"{key} separate"] = {k: v.contiguous()
                                       for k, v in sa.items()}
    for key, sa in b5_cases.items():
        got = stage_a(sa, lists_a)
        err = max_err(got, stage_a_plain(sa, lists_a))
        ms = cuda_ms(lambda: stage_a(sa, lists_a), 20)
        plain = cuda_ms(lambda: stage_a_plain(sa, lists_a), 3)
        bound = bound_ms(*sa.values(), *got)
        if key.endswith("separate"):
            report(f"{key} (segments apart)", err, ms, plain, bound)
        else:
            record(key, "dryv_tpu_torch/csrc/stage_a.cu",
                   "dryv_tpu/kernels/pallas_wavefront.py:641", err, ms,
                   plain, bound)
        if "stage_a" in old:
            if max_err(old["stage_a"](sa, lists_a), got):
                fail(f"{key}: the earlier B5 and the current differ")
            in_turns(f"{key}", "B5",
                     lambda: cuda_ms(lambda: old["stage_a"](sa, lists_a), 20),
                     lambda: cuda_ms(lambda: stage_a(sa, lists_a), 20), 20)
    sa = b5_cases["stage_a_f1"]
    got = stage_a(sa, lists_a, MB_W)
    report(f"stage_a_f1 with nz4 ({got[2].float().mean():.1%} of 4x4 "
           f"blocks coded)", max_err(got, stage_a_plain(sa, lists_a, MB_W)),
           cuda_ms(lambda: stage_a(sa, lists_a, MB_W), 20),
           cuda_ms(lambda: stage_a_plain(sa, lists_a, MB_W), 3),
           bound_ms(*sa.values(), *got))

    # B6 at F = 16 and F = 1, intra (random kinds, QPs, sorted slice ids
    # with disable_deblocking_filter_idc 0/1/2 per MB, filter offsets up
    # to +-12, chroma QP offsets 12 and -12), and at F = 1 on the I/P/B
    # path's inter field (``inter_edge_inputs``: bS 1 and 2).  With an
    # earlier B6 (--compare), each in turns with it, bit-exact to it
    b6_cases = {}
    for key, nf in (("deblock_params", F), ("deblock_params_f1", 1)):
        def r32(lo, hi):
            return torch.from_numpy(rng.integers(lo, hi, (nf, n_mb))
                                    .astype(np.int32)).to(dev)
        b6_cases[key] = ((r32(0, 4), r32(0, 52), torch.from_numpy(np.sort(
            rng.integers(0, 9, (nf, n_mb)), 1).astype(np.int32)).to(dev),
            r32(0, 3), 2 * r32(-6, 7), 2 * r32(-6, 7)), {})
    b6_cases["deblock_params_f1 inter"] = inter_edge_inputs(rng, MB_W, MB_H,
                                                            dev)
    for key, (per_mb, ex) in b6_cases.items():
        a6 = (*per_mb, MB_W, MB_H, 12, -12, tables)
        got = deblock_params(*a6, **ex)
        err = max_err([got], [deblock_params_plain(*a6, **ex)])
        ms = cuda_ms(lambda: deblock_params(*a6, **ex), 20)
        plain = cuda_ms(lambda: deblock_params_plain(*a6, **ex), 3)
        bound = bound_ms(*per_mb, *ex.values(), got)
        bs = sorted(torch.unique(got[..., :16]).tolist())
        if "deblock_params" in old:
            if max_err([old["deblock_params"](*a6, **ex)], [got]):
                fail(f"{key}: the earlier B6 and the current differ")
            in_turns(f"{key}", "B6",
                     lambda: cuda_ms(lambda: old["deblock_params"](*a6, **ex),
                                     20),
                     lambda: cuda_ms(lambda: deblock_params(*a6, **ex), 20),
                     20)
        if key == "deblock_params_f1":
            report(f"deblock_params at F = 1, intra (luma vertical bS "
                   f"{bs})", err, ms, plain, bound)
            continue
        if ex and not {1, 2} <= set(bs):
            fail("deblock_params on the inter field saw no bS 1 and 2")
        print(f"{key}: luma vertical bS {bs}  [{card}]")
        record(key.replace(" inter", ""),
               "dryv_tpu_torch/csrc/deblock_params.cu",
               "dryv_tpu/kernels/deblock.py:410", err, ms, plain, bound)

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
        bound, by, terms = larger_bound(
            bound_ms(*inputs, *got, *(halo or ())), b2_ops(inputs[0]))
        print(f"bound terms of {key} ({MB_W}x{rows} MBs x {nf}): {terms}; "
              f"its dependency chain {MB_W + 2 * (rows - 1)} MB steps "
              f"(mb_w + 2 (mb_h - 1))  [{card}]")
        if key == "intra_wavefront_f1":
            report("intra_wavefront at F = 1 (the per-picture path's "
                   "shape)", err, ms, plain, bound)
        else:
            record(key, "dryv_tpu_torch/csrc/intra_wavefront.cu",
                   "dryv_tpu/kernels/pallas_wavefront.py:140", err, ms,
                   plain, bound, by)

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
                bound, by, terms = larger_bound(
                    bound_ms(prm, *planes, *dk),
                    b3_ops(prm, *planes, MB_W, MB_H))
                print(f"bound terms of {key} ({MB_W}x{MB_H} MBs x {nf}): "
                      f"{terms}; its dependency chain "
                      f"{MB_W + 2 * (MB_H - 1)} MB steps  [{card}]")
                record(key, "dryv_tpu_torch/csrc/deblock.cu",
                       "dryv_tpu/kernels/pallas_deblock.py:93", err, ms,
                       cuda_ms(lambda: deblock_plain(prm, *planes, MB_W,
                                                     MB_H), 2),
                       bound, by)
            else:
                print(f"kernel {key} (F = {nf}) with random slices and "
                      f"idc 0/1/2: max_abs_err {err}, changed "
                      f"{changed} samples (y, cb, cr), kernel {ms:.4f} ms"
                      f"  [{card}]")
                if err:
                    fail(f"{key} with random slices differs (max {err})")
        if old and "deblock" in old:
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
    # 0/1/2; random vectors per 4x4 block within 48 pixels ("local") and
    # reaching past every edge of the picture ("far"), and H.264 MB
    # layouts (testing.motion.partitioned_field, a field each for P and
    # B): every kind mixed ("mixed"), no sub-8x8 split ("coarse"), and
    # that at full-pel vectors ("full-pel": B4's copy paths)
    n4 = 16 * n
    stacks = [torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
              .to(dev) for shape in ((3, 16 * MB_H, 16 * MB_W),
                                     (3, 8 * MB_H, 8 * MB_W),
                                     (3, 8 * MB_H, 8 * MB_W))]
    fields = {}
    for m, reach in (("far", 4 * (16 * MB_W + 64)), ("local", 4 * 48)):
        fields[(m, 1)] = fields[(m, 2)] = motion_field(rng, n4, 3, reach,
                                                       dev)
    for m, kinds in (("mixed", KINDS), ("coarse", KINDS[:-1]),
                     ("full-pel", KINDS[:-1])):
        for nl in (1, 2):
            fields[(m, nl)] = partitioned_motion(rng, 3, nl, kinds, dev,
                                                 full_pel=m == "full-pel")
    b4_cases = {}
    for (motion, nl), field in fields.items():
        for mode in ((0, 1) if nl == 1 else (0, 1, 2)):
            args = b4_args(stacks, field, nl, mode, MB_W, MB_H)
            err = max_err(mc_frame(*args), mc_frame_wire_plain(*args))
            if err:
                fail(f"inter_mc ({motion}, {'PB'[nl - 1]}, WP {mode}) "
                     f"differs from its plain version (max {err})")
            b4_cases[(motion, nl, mode)] = (args, cuda_ms(
                lambda: mc_frame(*args), 20), b4_bound(*args))
    print("kernel inter_mc, bit-exact in every case, CUDA events, mean of "
          "20: " + ", ".join(
              f"{m} {'PB'[nl - 1]} WP {wm} {ms:.4f} ms (bound {bd:.4f} ms, "
              f"{by})" for (m, nl, wm), (a, ms, (bd, by)) in
              b4_cases.items()) + f"  [{card}]")
    for m in ("mixed", "coarse", "full-pel"):
        print(f"B4 case {m}: MBs by groups over both lists (0 = intra), P "
              f"{b4_census(b4_cases[(m, 1, 0)][0])}, B "
              f"{b4_census(b4_cases[(m, 2, 0)][0])}")
    if old_b4:
        for (m, nl, wm), (a, _, bd) in b4_cases.items():
            b4_in_turns(f"{m} {'PB'[nl - 1]} WP {wm}", a, bd)
    args, ms, bd = b4_cases[("local", 2, 2)]
    record("inter_mc", "dryv_tpu_torch/csrc/inter_mc.cu",
           "dryv_tpu/kernels/inter.py:146", 0, ms,
           cuda_ms(lambda: mc_frame_wire_plain(*args), 3), *bd)

    # one B1, B2, B3 or B4 call is one launch on the device: the first
    # segment of the trace at the end of the run
    names = ("densify_kernel", "intra_rows_kernel", "deblock_rows_kernel",
             "inter_mc_kernel", "stage_a_kernel", "deblock_params_kernel")
    b4_prof = [b4_cases[("local", 1, 1)][0], b4_cases[("local", 2, 2)][0]]

    def per_call():
        [stage_a(sa, lists_a) for sa in b5_cases.values()]
        [deblock_params(*per_mb, MB_W, MB_H, 12, -12, tables, **ex)
         for per_mb, ex in b6_cases.values()]
        [densify(*b1_cases[nf]) for nf in (F, 1)]
        [intra_recon(*inputs, tables, MB_W, rows, halo=halo)
         for inputs, rows, halo in b2_cases.values()]
        [deblock(prm, *[p.clone() for p in planes], MB_W, MB_H)
         for prm, planes in b3_cases.values()]
        [mc_frame(*a) for a in b4_prof]

    # ---- phases 4-6: the main path, bit-exact, counted ----------------
    phase("4-6 main path")
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
        stage_a.launches = deblock_params.launches = 0
        decode_annexb_gop_pipelined.fallback_calls = 0
        decode_annexb_fast.host_calls = 0
        decode_annexb_device_packed.host_calls = 0

    def counts():
        return {"densify": densify.launches,
                "intra_wavefront": intra_recon.launches,
                "intra_wavefront_banded": intra_recon.banded_launches,
                "deblock": deblock.launches,
                "inter_mc": mc_frame.launches,
                "stage_a": stage_a.launches,
                "deblock_params": deblock_params.launches,
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

    def need(path, c, keys):
        """Fail unless every kernel in keys launched on the path."""
        print(f"launches on the {path}: {c}")
        for k in keys:
            if c[k] <= 0:
                fail(f"kernel {k} never launched on the {path}")

    # a path's kernel launches on the card, graphed, are counted from
    # the device trace at the end of the run ("census"): each path's
    # streams decoded once more through its captured steps, every device
    # kernel counted by name; they must equal the eager decode's
    # wrapper counts, and the kernels line takes them
    census = []      # (path, fn, eager counts, {kernels line: counter})

    def main_path(graph):
        for (label, stream, against), ref in zip(checks, refs):
            check_frames(f"{label}, {('eager', 'graphed')[graph]}",
                         decode_annexb_gop_pipelined(
                             stream, gop=F, n_threads=nthreads, device=dev,
                             graph=graph), ref, against)

    # graphed (the default), every step made here: the wrappers count the
    # launches of each step's warm-up and the ones its capture records
    reset_counts()
    main_path(True)
    c = counts()
    main_keys = ("densify", "stage_a", "intra_wavefront", "deblock_params",
                 "deblock")
    need("main path, graphed, first run (warm-ups and captures)", c,
         main_keys)
    if c["fallback_calls"] != 0:
        fail("the main path left the batched scope")
    reset_counts()
    main_path(False)
    c = counts()
    need("main path, eager", c, main_keys)
    census.append(("main path", lambda: main_path(True), c,
                   {k: k for k in main_keys}))

    # ---- phase 7: end-to-end timing, eager and graphed ----------------
    # graph=False enqueues PackedGopDecoder op by op; graph=True (the
    # default) replays one captured step per batch
    phase("7 batched timing")
    B = 8
    big = gop_stream * B
    ref_y = torch.from_numpy(np.stack([r[0] for r in refs[0]])).to(dev)

    def batched(graph, timers=None, stream=big):
        # the batched entry, planes left on the card, finished there
        out = decode_annexb_gop_pipelined(
            stream, gop=F, n_threads=nthreads, device=dev, stacked_out=True,
            timers=timers, graph=graph)
        torch.cuda.synchronize()
        return out

    runs = {}
    for graph in (False, True):
        reset_counts()
        runs[graph] = (batched(graph), counts())
    need("batched timing decode, eager", runs[False][1],
         ("densify", "stage_a", "intra_wavefront"))
    for a, b in zip(*(runs[g][0] for g in (False, True))):
        if a[3] != b[3] or not all(torch.equal(x, y)
                                   for x, y in zip(a[:3], b[:3])):
            fail("batched: the graphed decode differs from the eager one")
    for y, _cb, _cr, nf in runs[True][0]:
        if not torch.equal(y[:nf, :1080], ref_y[:nf]):
            fail("timed-stream batch differs from the native decode")
    print(f"batched bench1080p_gop16 x{B} ({len(runs[True][0])} batches of "
          f"{F}): graphed bit-exact vs eager and native C++; launches eager "
          f"{runs[False][1]}, graphed (wrapper calls of warm-ups and "
          f"captures only) {runs[True][1]}")
    fps = {False: [], True: []}
    ratios = {False: [], True: []}
    stage_ms = {}
    for graph in (False, True) * REPS:
        tm = StageTimers()
        t0 = time.perf_counter()
        batched(graph, tm)
        wall = time.perf_counter() - t0
        fps[graph].append(B * 16 / wall)
        ratios[graph].append(sum(tm.t.values()) / wall)
        stage_ms[graph] = {k: round(v / (B * 16) * 1e3, 3)
                           for k, v in tm.t.items()}
    for graph in (False, True):
        f = fps[graph]
        print(f"e2e bench1080p_gop16 x{B} {('eager', 'graphed')[graph]} "
              f"(stacked device output, n_threads={nthreads}), in turns: "
              f"median {statistics.median(f):.2f} fps, min {min(f):.2f}, "
              f"max {max(f):.2f} over {REPS} runs; stage ms/frame (last "
              f"run): {json.dumps(stage_ms[graph])}; stage sum / wall: "
              f"median {statistics.median(ratios[graph]):.3f}  [{card}]")
    tm = StageTimers()
    with spans_around(graphs.Step, "__call__") as spans:
        t0 = time.perf_counter()
        host = decode_annexb_gop_pipelined(big, gop=F, n_threads=nthreads,
                                           device=dev, timers=tm)
        wall = time.perf_counter() - t0
    check_frames(f"batched bench1080p_gop16 x{B}, host frames (graphed)",
                 host, refs[0] * B, "native C++")
    print(f"e2e host-frame output (graphed): {len(host) / wall:.2f} fps, "
          f"stage sum / wall {sum(tm.t.values()) / wall:.3f}; stage "
          f"ms/frame {json.dumps({k: round(v / len(host) * 1e3, 3) for k, v in tm.t.items()})}  [{card}]")
    del host
    stall_line(f"batched bench1080p_gop16 x{B}, F = {F}, host frames",
               spans, card)

    def batch_spans(stream, graph):
        """Decode `stream` through the batched pipeline (stacked device
        output) with CUDA events around each batch's device call
        (PackedGopDecoder.forward eager, the step's replay graphed);
        returns (output, its ``Calls``, wall s); graphed, the ``Calls``
        hold in ``replay_ms`` the host ms of each graph's replay inside
        them."""
        owner, attr = ((graphs.Step, "__call__") if graph
                       else (PackedGopDecoder, "forward"))
        with spans_around(owner, attr) as spans, \
                host_ms_of(torch.cuda.CUDAGraph, "replay") as replay_ms:
            t0 = time.perf_counter()
            out = batched(graph, stream=stream)
            wall = time.perf_counter() - t0
        spans.replay_ms = [round(x, 3) for x in replay_ms]
        return out, spans, wall

    for graph in (False, True):
        _, spans, wall = batch_spans(big, graph)
        ms, d_med, h_med, h_max = span_summary(spans)
        print(f"device span of the batch stage {('eager', 'graphed')[graph]}"
              f": median {d_med:.3f} ms per batch of {F} (host median "
              f"{h_med:.3f}, max {h_max:.3f} ms to enqueue it), "
              f"{sum(ms) / 1e3 / wall:.4f} of the {wall:.3f} s wall  "
              f"[{card}]")
        if graph:
            stall_line(f"batched bench1080p_gop16 x{B}, F = {F}, "
                       f"stacked_out (batch_spans)", spans, card,
                       replay_host_ms=spans.replay_ms)

    def batched_host_calls():
        n_calls = {g: host_calls_in_profile(lambda: batched(g))
                   for g in (False, True)}
        print(f"batched bench1080p_gop16 x{B} host side, per batch of {F} "
              f"(CPU-activity torch.profiler trace, CUDA runtime calls): "
              + ", ".join(f"{('eager', 'graphed')[g]} " + json.dumps(
                  {k: v / B for k, v in c.items()})
                  for g, c in n_calls.items()) + f"  [{card}]")

    # CPU-activity traces run after the census, the run's one device trace
    host_side = [batched_host_calls]

    # one batch of 16 deblocked pictures: bench1080p_dblk.264 x 16, so
    # that B3 runs at the batched path's shape on a real picture
    dblk = open("benchdata/bench1080p_dblk.264", "rb").read() * F
    gd = np.load("benchdata/bench1080p_dblk_golden.npz")
    dblk_want = [torch.from_numpy(gd[k]).to(dev) for k in ("y", "cb", "cr")]

    def dblk_batch(b3, graph):
        """Device ms of the deblocked batch with `b3` as the pipeline's
        deblock (an eager decode reads it at each call; a step holds the
        one it was captured with); every frame checked against the
        golden."""
        gop_pipeline.deblock = b3
        try:
            out, sp, _ = batch_spans(dblk, graph)
        finally:
            gop_pipeline.deblock = deblock
        if len(out) != 1 or out[0][3] != F:
            fail("bench1080p_dblk x 16 did not decode as one batch of 16")
        y, cb, cr, _ = out[0]
        for got, w in zip((y, cb, cr), dblk_want):
            if not torch.equal(got[:, :w.shape[0], :w.shape[1]],
                               w.expand(F, *w.shape)):
                fail("deblocked batch differs from "
                     "bench1080p_dblk_golden.npz")
        return sp

    batched(True, stream=dblk)       # the step's capture, untimed
    dspans = {}
    for g in (False, True):
        reset_counts()
        calls = [dblk_batch(deblock, g) for _ in range(3)]
        dcalls = pooled(calls)
        dcalls.replay_ms = [x for cs in calls for x in cs.replay_ms]
        dspans[g] = span_summary(dcalls)[0]
        if not g:
            c = counts()
    stall_line(f"deblocked batch, bench1080p_dblk x {F}, stacked_out, 3 "
               f"decodes", dcalls, card, replay_host_ms=dcalls.replay_ms)
    print(f"device span of one batch of {F} deblocked pictures "
          f"(bench1080p_dblk.264 x {F}, every frame bit-exact vs "
          f"bench1080p_dblk_golden.npz, eager and graphed), CUDA events, 3 "
          f"runs each: eager {', '.join(f'{v:.3f}' for v in dspans[False])}"
          f" ms, graphed {', '.join(f'{v:.3f}' for v in dspans[True])} ms; "
          f"launches eager {c}  [{card}]")
    if c["deblock"] != 3 or c["fallback_calls"] or c["stage_a"] != 3 \
            or c["deblock_params"] != 3:
        fail("the deblocked batch did not run B5, B6 and B3 once per "
             "batch")
    census.append(("deblocked batch x3",
                   lambda: [dblk_batch(deblock, True) for _ in range(3)], c,
                   {}))
    if old and "deblock" in old:
        t = [statistics.mean(span_summary(dblk_batch(b3, False))[1]
                             for _ in range(3))
             for b3 in (old["deblock"], deblock, deblock, old["deblock"])]
        print(f"device span of the deblocked batch (eager), mean of 3 runs, "
              f"in turns: earlier B3 "
              f"{t[0]:.3f} / {t[3]:.3f} ms, this B3 {t[1]:.3f} / "
              f"{t[2]:.3f} ms; every frame bit-exact  [{card}]")
    print(f"captured steps of the batched path: "
          f"{json.dumps(gop_pipeline.STEPS.stats())}  [{card}]")

    # ---- phase 8: the per-picture path (CAVLC, scaling matrices) -------
    phase("8 per-picture")
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
    def per_picture(graph):
        for label, stream, ref, against in pp_checks:
            check_frames(f"{label}, {('eager', 'graphed')[graph]}",
                         decode_annexb_fast(stream, n_threads=nthreads,
                                            device=dev, graph=graph),
                         ref, against)

    reset_counts()
    per_picture(True)
    c = counts()
    pp_keys = ("stage_a", "intra_wavefront", "deblock_params", "deblock")
    need("per-picture path, graphed, first run (warm-ups and captures)", c,
         pp_keys)
    if c["host_calls"] != 0:
        fail("the per-picture path sent a stream to the host decoder")
    reset_counts()
    per_picture(False)
    c = counts()
    need("per-picture path, eager", c, pp_keys)
    census.append(("per-picture path", lambda: per_picture(True), c,
                   {"deblock_f1": "deblock", "stage_a_f1": "stage_a"}))

    reset_counts()
    check_frames("batched pipeline on the CAVLC pictures, eager",
                 decode_annexb_gop_pipelined(cavlc, gop=F,
                                             n_threads=nthreads, device=dev,
                                             graph=False),
                 pp_checks[2][2], "native C++")
    c = counts()
    print(f"launches, CAVLC through the batched pipeline (eager): {c}")
    if (c["fallback_calls"] != 1 or c["host_calls"] != 0
            or min(c[k] for k in pp_keys) <= 0):
        fail("the batched pipeline did not hand the CAVLC stream to the "
             "per-picture device path")

    fps = {False: [], True: []}
    for graph in (False, True) * REPS:
        t0 = time.perf_counter()
        got = decode_annexb_fast(gop_stream, n_threads=nthreads, device=dev,
                                 graph=graph)
        fps[graph].append(len(got) / (time.perf_counter() - t0))
        check_frames(f"per-picture bench1080p_gop16.264 (timed, "
                     f"{('eager', 'graphed')[graph]})", got, refs[0],
                     "native C++")
    print("per-picture decode_annexb_fast bench1080p_gop16 (host frames), "
          "in turns: " + "; ".join(
              f"{('eager', 'graphed')[g]} median {statistics.median(f):.2f} "
              f"fps, min {min(f):.2f}, max {max(f):.2f} over {REPS} runs"
              for g, f in fps.items()) + f"  [{card}]")
    for graph in (False, True):
        # the device call of a picture: stage A + B2 eager (the stream
        # has no in-loop filter), the step's replay graphed
        owner, attr = ((graphs.Step, "__call__") if graph
                       else (pipeline, "recon_syntax"))
        with spans_around(owner, attr) as spans:
            t0 = time.perf_counter()
            decode_annexb_fast(gop_stream, n_threads=nthreads, device=dev,
                               graph=graph)
            wall = time.perf_counter() - t0
        ms, d_med, h_med, h_max = span_summary(spans)
        print(f"per-picture bench1080p_gop16 {('eager', 'graphed')[graph]}:"
              f" device span median {d_med:.3f} ms per picture (host median "
              f"{h_med:.3f}, max {h_max:.3f} ms to enqueue it), "
              f"{sum(ms) / 1e3 / wall:.4f} of the {wall:.3f} s wall  "
              f"[{card}]")
        if graph:
            stall_line("per-picture bench1080p_gop16", spans, card)

    def per_picture_host_calls():
        for graph in (False, True):
            c = host_calls_in_profile(lambda: decode_annexb_fast(
                gop_stream, n_threads=nthreads, device=dev, graph=graph))
            print(f"per-picture bench1080p_gop16 "
                  f"{('eager', 'graphed')[graph]}: CUDA runtime calls per "
                  f"picture " + json.dumps(
                      {k: v / len(refs[0]) for k, v in c.items()})
                  + f" (CPU-activity torch.profiler trace)  [{card}]")

    host_side.append(per_picture_host_calls)
    print(f"captured steps of the per-picture path: "
          f"{json.dumps(pipeline.STEPS.stats())}  [{card}]")
    # the LevelScale lists are inputs of the step: the flat CAVLC and the
    # SPS scaling-matrix pictures (8x6 MBs, deblocked, PCM in each) share
    # one key
    step_keys = [(k[1], k[2], k[3], len(k[4]))
                 for k in pipeline.STEPS.steps]
    print(f"per-picture keys (mb_w, mb_h, deblocked, syntax tensors): "
          f"{step_keys}  [{card}]")
    if sum(k[:2] == (8, 6) for k in step_keys) != 1:
        fail("the flat-list and the scaling-matrix pictures of 8x6 MBs "
             "made other than one per-picture key")

    # ---- phase 8b: entry(), the counterpart of __graft_entry__.entry() -
    # the per-picture step at 4x4 MBs without the in-loop filter (B2 at
    # F = 1) on its example picture, then on random non-flat LevelScale
    # lists: one step made for both, each call equal to the plain run on
    # the CPU, the flat call to native C++
    phase("8b entry")
    made = pipeline.STEPS.made
    reset_counts()
    fn, args = pipeline.entry()
    entry_args = args
    got = fn(*args)
    c = counts()
    print(f"launches, entry()'s first call (warm-up and capture): {c}")
    if c["intra_wavefront"] <= 0 or c["stage_a"] <= 0:
        fail("entry(): B5 and B2 did not launch in the first call")
    rs = np.random.default_rng(11)
    lists = [level_scale_4x4(rs.integers(4, 64, (4, 4))) for _ in range(3)]
    lists = [np.asarray(a, np.int32)
             for a in (*lists, level_scale_8x8(rs.integers(4, 64, (8, 8))))]
    got2 = fn(args[0], *(torch.from_numpy(a).to(dev) for a in lists))
    torch.cuda.synchronize()
    if pipeline.STEPS.made - made != 1:
        fail(f"entry(): {pipeline.STEPS.made - made} steps made for two "
             f"calls on other lists")
    (key,) = [k for k in pipeline.STEPS.steps if k[0].type == "cuda"
              and k[1:3] == (4, 4)]
    entry_step = pipeline.STEPS.steps[key]
    cpu_fn, (cpu_s, *cpu_flat) = pipeline.entry(device="cpu")
    want = cpu_fn(cpu_s, *cpu_flat)
    want2 = cpu_fn(cpu_s, *(torch.from_numpy(a) for a in lists))
    (r,) = decode_annexb_native(parallel._tiny_stream(1))
    for label, g, w in (("flat lists vs plain", got, want),
                        ("flat lists vs native C++", got,
                         [torch.from_numpy(p) for p in (r.y, r.cb, r.cr)]),
                        ("random lists vs plain", got2, want2)):
        if max_err([x.cpu() for x in g], w):
            fail(f"entry(): {label} differ")
    if all(torch.equal(a, b) for a, b in zip(got, got2)):
        fail("entry(): the random lists changed no sample")
    call_ms = cuda_ms(lambda: fn(*args), 50)
    replay_ms = cuda_ms(lambda: entry_step.graphs[0].replay(), 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"entry(): fn(*args) bit-exact (graphed, B2) vs its plain run "
          f"on the CPU and native C++ (flat lists) and vs the plain run "
          f"on random lists, 1 step made for both; CUDA events, mean of "
          f"50, the card held while the calls enqueue: replay "
          f"{replay_ms:.4f} ms, whole call (loads, replay, clones) "
          f"{call_ms:.4f} ms on the card, {host_ms:.4f} ms of host "
          f"a call back to back  [{card}]")
    with spans_around(graphs.Step, "__call__") as spans:
        for _ in range(50):
            fn(*args)
    stall_line("entry() fn(*args), 50 calls back to back", spans, card)

    # ---- phase 9: the sharded paths on one card, eager and graphed -----
    # graph=False enqueues each path op by op on its mesh slots' streams;
    # graphed (the default on a mesh of one card) replays one captured
    # step per key with every slot stream inside (parallel.STEPS)
    phase("9 sharded")
    frames, gsps = frames_from_stream(gop_stream, n_threads=nthreads)
    rev = frames[::-1]
    rev_ref = refs[0][::-1]

    def check_planes(label, planes, ref):
        check_frames(label, [DecodedFrame(*p).crop(gsps) for p in planes],
                     ref, "native C++")

    gop_mesh = parallel.make_mesh({"gop": 2}, ["cuda:0"] * 2)
    run4 = {g: parallel.make_banded_gop_fn(
        parallel.make_mesh({"band": 4}, ["cuda:0"] * 4), MB_W, MB_H, 16,
        Fi=4, graph=g) for g in (False, True)}
    run3 = {g: parallel.make_banded_frame_fn(
        parallel.make_mesh({"band": 3}, ["cuda:0"] * 3), MB_W, MB_H,
        graph=g) for g in (False, True)}
    if not (run4[True].graphed and run3[True].graphed) \
            or run4[False].graphed or run3[False].graphed:
        fail("a mesh of one card did not take the route asked for")
    n_eager = [0]    # eager sharded calls made here

    def gop_sharded(graph, order=frames, ref=refs[0]):
        e0 = parallel.STEPS.eager
        planes = parallel.decode_gop_sharded(order, gop_mesh, graph=graph)
        if parallel.STEPS.eager - e0 != (not graph):
            fail("decode_gop_sharded over ['cuda:0'] * 2 did not take the "
                 "route asked for")
        n_eager[0] += not graph
        check_planes(f"decode_gop_sharded over ['cuda:0'] * 2, "
                     f"{('eager', 'graphed')[graph]}", list(zip(*planes)),
                     ref)
        return planes

    def banded(graph, order=frames, ref=refs[0]):
        """The 4-band pipeline and the 3-band frame; the pipeline's
        planes (on the card)."""
        label = ('eager', 'graphed')[graph]
        planes = run4[graph](order, device_out=True)
        check_planes(f"make_banded_gop_fn, 4 bands of 17 MB rows, Fi=4, "
                     f"{label}", list(zip(*(p.cpu().numpy()
                                            for p in planes))), ref)
        check_planes(f"make_banded_frame_fn, 3 bands (23/23/22 MB rows), "
                     f"{label}", [run3[graph](order[0])], ref[:1])
        n_eager[0] += 2 * (not graph)
        return planes

    # graphed first: each step's warm-up and capture run the wrappers
    reset_counts()
    g_gop = gop_sharded(True)
    g_band = banded(True)
    c = counts()
    need("sharded paths, graphed, first run (warm-ups and captures)", c,
         ("stage_a", "intra_wavefront", "intra_wavefront_banded"))
    reset_counts()
    e_gop = gop_sharded(False)
    c_gop = counts()
    reset_counts()
    e_band = banded(False)
    c_band = counts()
    need("decode_gop_sharded, eager", c_gop, ("stage_a", "intra_wavefront"))
    need("band pipeline and banded frame, eager", c_band,
         ("stage_a", "intra_wavefront_banded"))
    if not all(np.array_equal(a, b) for a, b in zip(g_gop, e_gop)) or \
            not all(torch.equal(a, b) for a, b in zip(g_band, e_band)):
        fail("a sharded path differs graphed and eager")
    # a second graphed call on other inputs (the pictures reversed), the
    # first call's planes held meanwhile: both right, no buffer shared
    g_band2 = banded(True, rev, rev_ref)
    gop_sharded(True, rev, rev_ref)
    check_planes("make_banded_gop_fn graphed, first call's planes held "
                 "through the second", list(zip(*(p.cpu().numpy()
                                                  for p in g_band))),
                 refs[0])
    if {t.data_ptr() for t in g_band} & {t.data_ptr() for t in g_band2}:
        fail("two graphed calls handed out one buffer")
    print("sharded paths: graphed and eager bit-exact to each other and to "
          "native C++, two graphed calls on other inputs each right")
    census.append(("sharded GOP", lambda: gop_sharded(True), c_gop, {}))
    census.append(("band pipeline", lambda: banded(True), c_band,
                   {"intra_wavefront_banded": "intra_wavefront_banded"}))
    if n_cards > 1:
        # slots on several cards: graphed, one graph per card, no eager
        # call counted
        devs = [f"cuda:{i}" for i in range(n_cards)]
        mesh = parallel.make_mesh({"gop": len(devs)}, devs)
        e0 = parallel.STEPS.eager
        planes = parallel.decode_gop_sharded(frames, mesh)
        check_planes(f"decode_gop_sharded over {devs}",
                     list(zip(*planes)), refs[0])
        step = parallel.STEPS.steps[parallel.gop.step_args(frames, mesh)[0]]
        if parallel.STEPS.eager != e0 or len(step.graphs) != len(devs):
            fail("a mesh over several cards did not replay a graph per card")
    parallel.dryrun_multichip(4, ["cuda:0"] * 4, stream=gop_stream,
                              n_threads=nthreads)
    if parallel.STEPS.eager != n_eager[0]:
        fail(f"parallel.STEPS counted {parallel.STEPS.eager} eager calls, "
             f"{n_eager[0]} were made")

    def spans_in_turns(label, fns):
        """fns: {name: fn}; each timed in the order a, b, ..., ..., b, a;
        printed as device span (host enqueue) ms."""
        order = list(fns) + list(fns)[::-1]
        t = {}
        for k in order:
            t.setdefault(k, []).append(span_host_ms(fns[k]))
        print(f"{label}, device span (host ms to return, median / max), "
              f"CUDA events, median of 3, in turns: " + ", ".join(
                  f"{k} " + " / ".join("{:.3f} ({:.3f} / {:.3f})".format(*x)
                                       for x in v)
                  for k, v in t.items()) + f" ms  [{card}]")
        return t

    # device span of stage A + wavefront over the 16 pictures, syntax
    # already on the card: unbanded B2, the 4-band pipeline eager (the
    # step's function op by op) and graphed (its replay and its planes'
    # copy out of the static outputs)
    syn = syntax_tensors(stack_frames(frames), dev)
    tabs = tables_for(dev)
    band_step = run4[True].step_args(frames)
    band_fn = band_step[1]()
    band_syn = [x.to(dev) for x in band_step[2]]
    with parallel.STEPS.hold(*band_step) as step:
        step.load(*band_step[2])
        if not all(torch.equal(a, b) for a, b in zip(step(),
                                                     band_fn(*band_syn))):
            fail("the band pipeline's replay differs from its eager run")
        spans_in_turns("16 pictures of bench1080p_gop16, stage A + wavefront, "
                 "syntax on the card", {
                     "unbanded B2": lambda: recon_syntax(syn, tabs, MB_W,
                                                         MB_H),
                     "4-band pipeline eager": lambda: band_fn(*band_syn),
                     "4-band pipeline graphed": step})
    # whole calls, FrameSyntax in, planes on the card out (syntax built on
    # the host and copied over; eager op by op, graphed load and replay)
    spans_in_turns("16 pictures of bench1080p_gop16, make_banded_gop_fn call "
             "(4 bands, Fi=4, device output)",
             {"eager": lambda: run4[False](frames, device_out=True),
              "graphed": lambda: run4[True](frames, device_out=True)})
    # decode_gop_sharded's device part (syntax copies, stage A and B2 on
    # both slots; the host copy of the planes after it is left out)
    spans = {}
    for graph in (False, True, True, False):
        with spans_around(parallel.gop, ("run_eager", "run_step")[graph]
                          ) as sp:
            gop_sharded(graph)
        spans.setdefault(graph, []).append(span_summary(sp)[1:])
    print("16 pictures of bench1080p_gop16, decode_gop_sharded over "
          "['cuda:0'] * 2, device part (syntax copies in, stage A + B2 "
          "on both slots), device span median (host ms to return, median "
          "/ max), in turns: "
          + ", ".join(f"{('eager', 'graphed')[g]} " + " / ".join(
              "{:.3f} ({:.3f} / {:.3f})".format(*x) for x in v)
              for g, v in spans.items()) + f" ms  [{card}]")
    print(f"captured steps of the sharded paths: "
          f"{json.dumps(parallel.STEPS.stats())}; card memory reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB  [{card}]")

    # ---- phase 10: the packed I/P/B path, eager and graphed ------------
    phase("10 I/P/B")
    gi = np.load("benchdata/bench_ipb_golden.npz")
    ipb_small = open("benchdata/bench_ipb.264", "rb").read()
    small_ref = [(gi[f"f{i}_y"], gi[f"f{i}_b"], gi[f"f{i}_r"])
                 for i in range(9)]
    ipb = open("benchdata/bench1080p_ipb.264", "rb").read()
    ipb_ref = [(r.y, r.cb, r.cr) for r in
               decode_annexb_native(ipb, n_threads=nthreads)]
    real = {}    # stream -> the arguments of its B4 calls, in order
    cur = [None]     # the stream being decoded
    mc_of_path = device_ipb_packed.mc_frame

    def capture_mc(*args):
        real.setdefault(cur[0], []).append(args)
        return mc_of_path(*args)

    def picture_call(graph):
        """The per-picture device call of the I/P/B path and a tag of its
        (picture type, weighted-prediction mode): forward eager, the
        step's replay graphed (its key holds wp_mode and nlists)."""
        if graph:
            return graphs.Step, "__call__", lambda st: ("IPB"[st.key[10]],
                                                        st.key[4])
        return PackedPictureDecoder, "forward", \
            lambda self, blob, W, ecap, ovcap, refs, nlists, wp_mode, *r: (
                "IPB"[nlists], wp_mode)

    def ipb_checks(graph):
        """Both streams, bit-exact; (launch counts, pictures by type and
        weighted-prediction mode)."""
        reset_counts()
        with spans_around(*picture_call(graph)) as spans:
            for cur[0], size, stream, ref, against in (
                    ("bench_ipb.264", "640x368, 9", ipb_small, small_ref,
                     "bench_ipb_golden.npz"),
                    ("bench1080p_ipb.264", "1080p, 10", ipb, ipb_ref,
                     "native C++")):
                check_frames(f"packed I/P/B {cur[0]} ({size} pictures, "
                             f"{('eager', 'graphed')[graph]})",
                             decode_annexb_device_packed(
                                 stream, n_threads=nthreads, device=dev,
                                 graph=graph), ref, against)
        c = counts()
        seen = {}
        for call in spans:
            seen[call.tag] = seen.get(call.tag, 0) + 1
        return c, seen

    # B4's arguments on real pictures are taken on an eager decode: a
    # step's are views into its graph's static buffers
    device_ipb_packed.mc_frame = capture_mc
    try:
        c_eager, seen = ipb_checks(False)
    finally:
        device_ipb_packed.mc_frame = mc_of_path
    c, seen_graphed = ipb_checks(True)
    print(f"pictures by type and weighted-prediction mode on the packed "
          f"I/P/B path: {seen}")
    if seen != seen_graphed:
        fail("packed I/P/B: graphed and eager pictures differ")
    i_keys = ("densify", "stage_a", "intra_wavefront", "deblock_params",
              "deblock", "inter_mc")
    need("packed I/P/B path, graphed, first run (warm-ups and captures)", c,
         i_keys)
    need("packed I/P/B path, eager", c_eager, i_keys)
    if c["ipb_host_calls"] or c_eager["ipb_host_calls"]:
        fail("the packed I/P/B path sent a stream to the host decoder")

    def ipb_graphed():
        check_frames("packed I/P/B bench_ipb.264, graphed",
                     decode_annexb_device_packed(ipb_small,
                                                 n_threads=nthreads,
                                                 device=dev), small_ref,
                     "bench_ipb_golden.npz")
        check_frames("packed I/P/B bench1080p_ipb.264, graphed",
                     decode_annexb_device_packed(ipb, n_threads=nthreads,
                                                 device=dev), ipb_ref,
                     "native C++")

    census.append(("packed I/P/B path", ipb_graphed, c_eager,
                   {"inter_mc": "inter_mc", "densify_f1": "densify",
                    "deblock_params_f1": "deblock_params"}))
    first = {}    # nlists -> the first such B4 call of bench1080p_ipb.264
    for a in real["bench1080p_ipb.264"]:
        first.setdefault(1 if a[4] is None else 2, a)
    for nl, a in sorted(first.items()):
        err = max_err(mc_frame(*a), mc_frame_wire_plain(*a))
        if err:
            fail(f"inter_mc on a {'PB'[nl - 1]} picture of "
                 f"bench1080p_ipb.264 differs from its plain version (max "
                 f"{err})")
        bd = b4_bound(*a)
        print(f"kernel inter_mc on the first {'PB'[nl - 1]} picture of "
              f"bench1080p_ipb.264 (WP {a[7]['mode']}, stack of "
              f"{a[0].shape[0]}), bit-exact, CUDA events, mean of 20: "
              f"{cuda_ms(lambda: mc_frame(*a), 20):.4f} ms, plain "
              f"{cuda_ms(lambda: mc_frame_wire_plain(*a), 3):.4f} ms, "
              f"bound {bd[0]:.4f} ms ({bd[1]}); MBs by groups over both "
              f"lists (0 = intra): {b4_census(a)}  [{card}]")
        if old_b4:
            b4_in_turns(f"on the first {'PB'[nl - 1]} picture", a, bd)
    zero = torch.empty((n, 384), dtype=torch.uint8, device=dev)
    print(f"floor of a kernel that writes a 1080p picture's predictions: "
          f"one zero_ of their {n} x 384 bytes, CUDA events, mean of 20: "
          f"{cuda_ms(lambda: zero.zero_(), 20):.4f} ms  [{card}]")

    # B4 on every P and B picture of the eager decodes above and of the
    # corpus streams the packed path takes (each stream bit-exact to the
    # native C++ decode): bit-exact to its plain version, each picture's
    # motion described (the share of its inter MBs whose vectors are all
    # full-pel, of its used (block, list) pairs that are fractional, its
    # groups per MB), timed beside its bound and, with --compare, in
    # turns with every earlier B4; sums per stream, and over the
    # pictures under 90% full-pel MBs ("fractional")
    phase("10b B4 on real pictures")
    on_device = []
    device_ipb_packed.mc_frame = capture_mc
    try:
        for path in sorted(glob.glob("tests/conformance/*.264")):
            cur[0] = os.path.basename(path)
            stream = open(path, "rb").read()
            before = decode_annexb_device_packed.host_calls
            check_frames(f"packed I/P/B corpus {cur[0]} (eager)",
                         decode_annexb_device_packed(
                             stream, n_threads=nthreads, device=dev,
                             graph=False),
                         [(r.y, r.cb, r.cr) for r in decode_annexb_native(
                             stream, n_threads=nthreads)], "native C++")
            if decode_annexb_device_packed.host_calls == before:
                on_device.append(cur[0])
    finally:
        device_ipb_packed.mc_frame = mc_of_path
    print(f"corpus streams on the packed device path: {len(on_device)} "
          f"({', '.join(on_device)})")
    if not any(name in real for name in on_device):
        fail("no corpus stream reached B4")

    def b4_pictures(stream, calls, each):
        """B4 on each call of one stream; (sums of ms by build over all
        its pictures, over its fractional ones, pictures, fractional
        pictures)."""
        sums, frac_sums, n_frac = {}, {}, 0
        inter = full = 0
        for i, a in enumerate(calls):
            err = max_err(mc_frame(*a), mc_frame_wire_plain(*a))
            if err:
                fail(f"inter_mc on picture {i} of {stream} differs from "
                     f"its plain version (max {err})")
            lists = [(a[3], a[5])] + ([(a[4], a[6])] if a[4] is not None
                                      else [])
            fp = full_pel_census([(r.cpu().numpy(), v.cpu().numpy())
                                  for r, v in lists], a[8], a[9])
            bd = b4_bound(*a)
            t = b4_in_turns(f"{stream} picture {i}", a, bd, quiet=True)
            frac = fp["full_pel"] < 0.9 * fp["inter"]
            n_frac += frac
            inter += fp["inter"]
            full += fp["full_pel"]
            for k, v in t.items():
                sums[k] = sums.get(k, 0.0) + v
                if frac:
                    frac_sums[k] = frac_sums.get(k, 0.0) + v
            if each:
                print(f"B4 {stream} picture {i} ({'PB'[len(lists) - 1]}, "
                      f"WP {a[7]['mode']}, {a[8]}x{a[9]} MBs): full-pel "
                      f"MBs {fp['full_pel']}/{fp['inter']}, fractional "
                      f"(block, list) pairs {fp['frac_blocks']:.1%}, MBs "
                      f"by groups {b4_census(a)}; bound {bd[0]:.4f} ms "
                      f"({bd[1]}); CUDA events, mean of 20, in turns: "
                      + ", ".join(f"{'this B4' if k == 'this' else k} "
                                  f"{v:.4f} ms" for k, v in t.items())
                      + f"  [{card}]")
        print(f"B4 on the {len(calls)} P/B pictures of {stream}: full-pel "
              f"MBs {full}/{inter}; sum of ms " + ", ".join(
                  f"{'this B4' if k == 'this' else k} {v:.4f}"
                  for k, v in sums.items())
              + f"; over its {n_frac} fractional pictures " + ", ".join(
                  f"{'this B4' if k == 'this' else k} {v:.4f}"
                  for k, v in frac_sums.items()) + f"  [{card}]")
        return sums, frac_sums, len(calls), n_frac

    totals = {}
    for stream in ["bench_ipb.264", "bench1080p_ipb.264"] + on_device:
        if stream in real:
            got = b4_pictures(stream, real[stream],
                              each=stream.startswith("bench"))
            group = stream if stream.startswith("bench") else "corpus"
            tot = totals.setdefault(group, [{}, {}, 0, 0])
            for j in (0, 1):
                for k, v in got[j].items():
                    tot[j][k] = tot[j].get(k, 0.0) + v
            tot[2] += got[2]
            tot[3] += got[3]
    def ratios(sums):
        return ", ".join(f"{'this B4' if k == 'this' else k} {v:.4f} ms "
                         f"({v / sums['this']:.3f}x this)"
                         for k, v in sums.items())

    for group, (sums, frac_sums, pics, n_frac) in totals.items():
        print(f"B4 sums on {group}: {pics} pictures {ratios(sums)}; "
              f"{n_frac} fractional pictures "
              f"{ratios(frac_sums) if n_frac else '-'}  [{card}]")
    real.clear()

    # every step of bench_ipb.264 captured anew with a host
    # synchronisation inside the captured function an error
    kept, capture = device_ipb_packed.STEPS, graphs.Step._capture

    def strict_capture(self):
        split = self.split

        def checked(fn):
            def run(*a):
                if not torch.cuda.is_current_stream_capturing():
                    return fn(*a)        # the warm-up run
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return run

        self.split = copy.copy(split)
        self.split.parts = [(d, n, checked(fn)) for d, n, fn in split.parts]
        try:
            capture(self)
        finally:
            self.split = split

    device_ipb_packed.STEPS = graphs.StepCache()
    graphs.Step._capture = strict_capture
    try:
        check_frames("packed I/P/B bench_ipb.264, every step captured anew "
                     "under torch.cuda sync debug mode \"error\"",
                     decode_annexb_device_packed(ipb_small,
                                                 n_threads=nthreads,
                                                 device=dev), small_ref,
                     "bench_ipb_golden.npz")
        print(f"captured steps under sync debug mode \"error\": "
              f"{json.dumps(device_ipb_packed.STEPS.stats())}  [{card}]")
    finally:
        device_ipb_packed.STEPS, graphs.Step._capture = kept, capture

    # end to end, frames to host, in turns with the native C++ decode
    fps = {"native C++": [], "eager I/P/B": [], "graphed I/P/B": []}
    tms = {}
    for label in tuple(fps) * REPS:
        tm = StageTimers()
        t0 = time.perf_counter()
        if label == "native C++":
            got = decode_annexb_native(ipb, n_threads=nthreads)
        else:
            got = decode_annexb_device_packed(
                ipb, n_threads=nthreads, device=dev, timers=tm,
                graph=label.startswith("graphed"))
        wall = time.perf_counter() - t0
        fps[label].append(len(got) / wall)
        tms[label] = (tm, wall)
        check_frames(f"{label} bench1080p_ipb.264 (timed)", got, ipb_ref,
                     "native C++")
    print("e2e bench1080p_ipb.264 (10 pictures, frames to host, "
          f"n_threads={nthreads}), in turns: " + "; ".join(
              f"{k} median {statistics.median(v):.2f} fps (runs "
              f"{', '.join(f'{x:.2f}' for x in v)})" for k, v in fps.items())
          + f"  [{card}]")
    for label in ("eager I/P/B", "graphed I/P/B"):
        tm, wall = tms[label]
        per_pic = {k: round(v / len(ipb_ref) * 1e3, 3)
                   for k, v in tm.t.items()}
        print(f"e2e {label} stage ms/picture (last run): "
              f"{json.dumps(per_pic)}; stage sum / wall "
              f"{sum(tm.t.values()) / wall:.3f}  [{card}]")

    for graph in (False, True):
        # the device span of each picture: CUDA events around its device
        # call, nothing synchronising inside the run; then the host side:
        # launches per picture in a CPU-activity torch.profiler trace, and
        # the calls that synchronise with the card in a decode
        def run():
            decode_annexb_device_packed(ipb, n_threads=nthreads, device=dev,
                                        device_out=True, graph=graph)

        with spans_around(*picture_call(graph)) as spans:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ms, d_med, h_med, h_max = span_summary(spans)
        n_sync = sync_calls(run)
        print(f"packed I/P/B bench1080p_ipb.264 {('eager', 'graphed')[graph]}"
              f" (device output): device span per picture, CUDA events: "
              + ", ".join(f"{c.tag[0]} {v:.3f}" for v, c in zip(ms, spans))
              + f" ms; mean {statistics.mean(ms):.3f}, median {d_med:.3f} "
              f"ms (host median {h_med:.3f}, max {h_max:.3f} ms to enqueue"
              f" it), {sum(ms) / 1e3 / wall:.4f} of the {wall:.3f} s wall; "
              f"{n_sync} synchronizing calls in a decode (torch.cuda sync "
              f"debug mode)  [{card}]")
        if graph:
            stall_line("packed I/P/B bench1080p_ipb.264, device output",
                       spans, card)

    def ipb_host_calls():
        for graph in (False, True):
            c = host_calls_in_profile(lambda: decode_annexb_device_packed(
                ipb, n_threads=nthreads, device=dev, device_out=True,
                graph=graph))
            print(f"packed I/P/B bench1080p_ipb.264 "
                  f"{('eager', 'graphed')[graph]} (device output): CUDA "
                  f"runtime calls per picture " + json.dumps(
                      {k: v / len(ipb_ref) for k, v in c.items()})
                  + f" (CPU-activity torch.profiler trace)  [{card}]")

    host_side.append(ipb_host_calls)
    print(f"captured steps of the packed I/P/B path: "
          f"{json.dumps(device_ipb_packed.STEPS.stats())}; card memory "
          f"reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB  "
          f"[{card}]")

    # ---- phase 11: banded P recon, equal to B4 on the whole plane -------
    # eager and graphed in turns; two graphed calls on two P pictures
    phase("11 banded P recon")
    ref = [p[0] for p in stacks]
    p_cases = [p_case(seed, ref, MB_W, MB_H) for seed in (5, 6)]
    p_mesh = parallel.make_mesh({"band": 4}, ["cuda:0"] * 4)
    prun = {g: parallel.make_banded_p_recon_fn(p_mesh, MB_W, MB_H, apron=64,
                                               graph=g) for g in (False, True)}
    if not prun[True].graphed or prun[False].graphed:
        fail("banded P recon on a mesh of one card did not take the route "
             "asked for")

    def p_recon(graph, case=0):
        args, want = p_cases[case]
        got = prun[graph](*args, device_out=True)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"banded P recon over ['cuda:0'] * 4, "
                 f"{('eager', 'graphed')[graph]}, picture {case}, differs "
                 f"from B4 on the whole plane")
        return got

    reset_counts()
    p_recon(True)
    need("banded P recon, graphed, first run (warm-up and capture)",
         counts(), ("inter_mc",))
    reset_counts()
    e_p = p_recon(False)
    c_p = counts()
    need("banded P recon, eager", c_p, ("inter_mc",))
    g_p = p_recon(True)
    g_p2 = p_recon(True, 1)
    if not all(torch.equal(a, b) for a, b in zip(g_p, e_p)) or \
            not all(torch.equal(g, w) for g, w in zip(g_p, p_cases[0][1])):
        fail("banded P recon: the first graphed planes changed under the "
             "second replay, or differ from eager")
    if {t.data_ptr() for t in g_p} & {t.data_ptr() for t in g_p2}:
        fail("banded P recon: two graphed calls handed out one buffer")
    print(f"banded P recon over ['cuda:0'] * 4 ({MB_H // 4} MB rows a band,"
          f" apron 64): eager and graphed equal to B4 on the whole plane, "
          f"two graphed calls on two pictures each right")
    census.append(("banded P recon", lambda: p_recon(True), c_p, {}))
    if n_cards > 1:
        devs = [f"cuda:{i}" for i in range(min(4, n_cards))]
        run = parallel.make_banded_p_recon_fn(
            parallel.make_mesh({"band": len(devs)}, devs), MB_W, MB_H,
            apron=64)
        e0 = parallel.STEPS.eager
        got = run(*p_cases[0][0], device_out=True)
        step = parallel.STEPS.steps[run.step_args(*p_cases[0][0])[0]]
        if not run.graphed or parallel.STEPS.eager != e0 or len(
                step.graphs) != len(devs) or not all(
                torch.equal(g.to(dev), w) for g, w in zip(got,
                                                          p_cases[0][1])):
            fail(f"banded P recon over {devs} did not replay a graph per "
                 f"card or differs from B4 on the whole plane")
        print(f"banded P recon over {devs} (graphed, a graph per card): "
              f"equal to B4 on the whole plane")
    spans_in_turns("a 1080p P picture, banded P recon call (4 bands of 17 MB "
             "rows, apron 64, host arrays in, device output)",
             {"eager": lambda: p_recon(False),
              "graphed": lambda: p_recon(True)})
    # the device work alone, inputs on the card: the step's function op
    # by op (apron hops, B4, residual add, assembly) eager, its replay and
    # its planes' copy out of the static outputs graphed
    p_step = prun[True].step_args(*p_cases[0][0])
    p_fn = p_step[1]()
    p_in = [x.to(dev) for x in p_step[2]]
    with parallel.STEPS.hold(*p_step) as step:
        step.load(*p_step[2])
        if not all(torch.equal(g, w) for g, w in zip(step(), e_p)) or \
                not all(torch.equal(g, w) for g, w in zip(p_fn(*p_in), e_p)):
            fail("banded P recon: the step's replay or its function run "
                 "op by op differs from the eager call")
        spans = {}
        for graph in (False, True, True, False):
            fn = step if graph else lambda: p_fn(*p_in)
            spans.setdefault(graph, []).append(span_host_ms(fn))
    print("a 1080p P picture, banded P recon device work (inputs on the "
          "card), device span (host ms to return, median / max), median of "
          "3, in turns: "
          + ", ".join(f"{('eager', 'graphed')[g]} " + " / ".join(
              "{:.3f} ({:.3f} / {:.3f})".format(*x) for x in v)
              for g, v in spans.items()) + f" ms  [{card}]")
    print(f"captured steps of the sharded paths and banded P recon: "
          f"{json.dumps(parallel.STEPS.stats())}; card memory reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB  [{card}]")

    # ---- phase 11b: the per-group route (a graph per card) -------------
    # on this card through the seam (its 4 slots in 2 and in 4 groups,
    # each group a graph of its own, halos between groups card to card),
    # and over several cards when there are
    phase("11b slot groups")
    paths = sharded_paths(frames, gsps, p_cases)
    want = one_card_wants(paths, refs[0], p_cases)
    for size in (2, 1):
        sharded_routes(card, f"['cuda:0'] * 4 in groups of {size}",
                       ONE_CARD, paths, want, size)
    label = "make_banded_gop_fn {band: 4} over ['cuda:0'] * 4 in 4 groups"
    card_segments, eager = card_census_segments(
        label, paths["make_banded_gop_fn {band: 4}"][0], ONE_CARD, 1)
    card_entries = [(label, eager)]
    if n_cards > 1:
        segs, entries, multi_host = multi_card_phase(
            card, cards, paths, want, gop_stream, nthreads)
        card_segments += segs
        card_entries += entries
        host_side.append(multi_host)

    # ---- phase 12: the census, the run's one device trace --------------
    # the per-call kernels of phase 3, then each graphed path's streams
    # once more through steps made before (one untraced run first): the
    # device kernels of each path must equal its eager wrapper counts
    phase("12 census")
    caches = (gop_pipeline.STEPS, pipeline.STEPS, device_ipb_packed.STEPS,
              parallel.STEPS)
    for _, fn, _, _ in census:
        fn()
    for _, fn in card_segments:
        fn()
    made = [x.made for x in caches]
    def band_replay():
        with parallel.STEPS.hold(*band_step) as st:
            st()

    # each step's device time by part (kernels.RANGES) and its hand
    # kernels, from eager runs of the steps inside the trace: a replay's
    # kernels link to its one graph launch, and the census above holds
    # the graphed steps' kernels equal to the eager ones
    e_names = tuple(sorted(entry_args[0]))
    e_xs = [entry_args[0][k] for k in e_names] + [
        ls.reshape(6, -1) for ls in entry_args[1:]]
    dblk1 = open("benchdata/bench1080p_dblk.264", "rb").read()
    splits = [
        ("batched step, bench1080p_gop16, F = 16", "batch",
         lambda: batched(False, stream=gop_stream), 1),
        ("batched step, bench1080p_dblk x 16, F = 16", "batch",
         lambda: batched(False, stream=dblk), 1),
        ("per-picture step, bench1080p_gop16", "picture",
         lambda: decode_annexb_fast(gop_stream, n_threads=nthreads,
                                    device=dev, graph=False), 16),
        ("per-picture step, bench1080p_dblk", "picture",
         lambda: decode_annexb_fast(dblk1, n_threads=nthreads, device=dev,
                                    graph=False), 1),
        ("I/P/B step, bench1080p_ipb", "picture",
         lambda: decode_annexb_device_packed(ipb, n_threads=nthreads,
                                             device=dev, graph=False), 10),
        ("entry() step", "call",
         lambda: pipeline._run_step(dev, 4, 4, e_names, e_xs, graph=False),
         1)]

    trace = device_kernels_in_profile(
        [("per call", per_call)] + [(p, fn) for p, fn, _, _ in census]
        + [("band pipeline replay", band_replay),
           ("entry() replay", lambda: entry_step.graphs[0].replay())]
        + [(f"split {label}", fn) for label, _, fn, _ in splits]
        + card_segments, names)
    if trace is None:
        fail("the profiler recorded no device time: the graphed paths' "
             "launches are not measured")
    if [x.made for x in caches] != made:
        fail("a step was made inside the census: its counts would hold "
             "its warm-up")
    n_prof = trace["per call"]
    print(f"device ms of each device kernel in a torch.profiler "
          f"trace of 2 B1 calls (W = 96 at F = {F}, 1), {len(b2_cases)} B2 "
          f"calls ({', '.join(b2_cases)}), {len(b3_cases)} B3 calls "
          f"({', '.join(b3_cases)}) and {len(b4_prof)} B4 calls (P, B): "
          f"{n_prof}  [{card}]")
    if [len(n_prof[k]) for k in names] != [
            2, len(b2_cases), len(b3_cases), len(b4_prof), len(b5_cases),
            len(b6_cases)]:
        fail("a B1, B2, B3, B4, B5 or B6 call launched other than one "
             "kernel")
    # B2 and B2b are one device kernel: its count is theirs summed
    counters = dict(zip(names, (("densify",),
                                ("intra_wavefront", "intra_wavefront_banded"),
                                ("deblock",), ("inter_mc",), ("stage_a",),
                                ("deblock_params",))))
    for path, _, eager, report in census:
        got = {n: len(trace[path][n]) for n in names}
        expect = {n: sum(eager[k] for k in ks) for n, ks in counters.items()}
        print(f"device kernels of the {path}, graphed, in the census trace: "
              f"{got}; eager wrapper counts {expect}  [{card}]")
        if got != expect:
            fail(f"{path}: the graphed decode launched other kernels than "
                 f"the eager one")
        for line, k in report.items():
            n = next(n for n, ks in counters.items() if k in ks)
            if any(eager[o] for o in counters[n] if o != k):
                fail(f"{path}: the census cannot tell {k} from the other "
                     f"counters of {n}")
            kernels[line]["launches"] = got[n]
    check_card_census(card, trace, card_entries)
    # B5 on every path's step that reconstructs intra or residual MBs
    # (banded P recon takes its residuals as inputs), B6 on every
    # deblocked one (the deblocked batch, the main path's deblocked
    # streams, the per-picture path's deblocked pictures, the I/P/B
    # pictures)
    segs = [p for p, _, _, _ in census] + ["band pipeline replay",
                                           "entry() replay"]
    seen = {p: (len(trace[p]["stage_a_kernel"]),
                len(trace[p]["deblock_params_kernel"])) for p in segs}
    print(f"B5 and B6 launches in the census trace by segment: "
          f"{json.dumps(seen)}  [{card}]")
    if min(b5 for p, (b5, _) in seen.items()
           if p != "banded P recon") == 0 or min(
            seen[p][1] for p in ("main path", "deblocked batch x3",
                                 "per-picture path",
                                 "packed I/P/B path")) == 0:
        fail("B5 did not launch on every path or B6 on every deblocked "
             "one in the census")
    n_act, span, summed, busy = trace["band pipeline replay"]["all"]
    print(f"one replay of the 4-band pipeline's step (16 pictures, Fi=4) in "
          f"the census trace: {n_act} device activities, {span:.3f} ms from "
          f"the first start to the last end, {summed:.3f} ms summed, "
          f"{busy:.3f} ms with at least one running: {summed / busy:.2f} "
          f"running at once on average, the card idle {1 - busy / span:.1%}"
          f" of the span; B2b "
          f"{sum(trace['band pipeline replay']['intra_rows_kernel']):.3f} "
          f"ms summed over "
          f"{len(trace['band pipeline replay']['intra_rows_kernel'])} "
          f"launches  [{card}]")
    n_act, span, summed, busy = trace["entry() replay"]["all"]
    print(f"one replay of entry()'s step (4x4 MBs, stage A + B2) in the "
          f"census trace: {n_act} device activities, {span:.4f} ms from "
          f"the first start to the last end, {summed:.4f} ms summed; B2 "
          f"{sum(trace['entry() replay']['intra_rows_kernel']):.4f} ms "
          f"over {len(trace['entry() replay']['intra_rows_kernel'])} "
          f"launches, B5 "
          f"{sum(trace['entry() replay']['stage_a_kernel']):.4f} ms  "
          f"[{card}]")
    if n_act >= 100:
        fail(f"entry()'s replay holds {n_act} device activities")
    for label, unit, _, per in splits:
        t = trace[f"split {label}"]
        n_act, _, summed, _ = t["all"]
        in_ranges = sum(c for _, c in t["ranges"].values())
        print(f"device split of the {label}, eager, per {unit} "
              f"(torch.profiler ranges kernels.RANGES: ms summed, device "
              f"activities): " + ", ".join(
                  f"{k} {ms / per:.4f} ({c / per:.1f})"
                  for k, (ms, c) in t["ranges"].items())
              + "; hand kernels " + ", ".join(
                  f"{k} {sum(t[k]) / per:.4f} ({len(t[k]) / per:.1f})"
                  for k in names if t[k])
              + f"; all device activities {summed / per:.4f} ms summed "
              f"({n_act / per:.1f}), {(n_act - in_ranges) / per:.1f} of "
              f"them outside the ranges  [{card}]")
        for g in GONE_RANGES:
            if t["ranges"].get(g, (0.0, 0))[1]:
                fail(f"the {label} still launches device work in a range "
                     f"named {g}")
    print(f"ranges {', '.join(GONE_RANGES)}: 0 device activities in every "
          f"step (gone from kernels.RANGES; the I/P/B step's coded flags "
          f"come out of B5)  [{card}]")
    for f in host_side:
        f()

    for k, v in kernels.items():
        if not v["launches"]:
            fail(f"kernel {k} launched on no driven path")
    phase("end")
    print(f"seconds from the start at which each phase began: "
          f"{json.dumps(phase_s)}  [{card}]")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
