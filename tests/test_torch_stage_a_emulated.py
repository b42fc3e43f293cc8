"""Kernels B5 (``csrc/stage_a.cu``) and B6 (``csrc/deblock_params.cu``)
run on the CPU from their CUDA sources and held against their plain
versions ``stage_a_plain`` and ``deblock_params_plain`` at tolerance 0.

Each source is compiled by g++ against ``tests/cuda_emu/cuda_runtime.h``
(a launch rewritten from ``<<<>>>`` runs its grid block by block, a
thread per CUDA thread, ``__syncthreads``, named barriers and the warp
collectives as barriers of their threads; the Hopper helpers of
``csrc/common.cuh`` as stand-ins: an mbarrier a phase counter, a TMA bulk
copy or store a memcpy at issue), as ``tests/test_torch_inter_emulated.py``
does for B4, with the card's SM count set to ``SMS``.  Each call runs in
a child process with a time limit, so that a wait on a barrier that no
emulated thread completes fails the test instead of hanging it.

B5 takes its levels both as column slices of padded dense rows (the
batched path's [F, npad, 408] wire: one bulk copy a tile) and as
separate tensors (the per-picture syntax: one a segment); its MB counts
fill a tile of 16 partly (F = 1 with one partial tile, partial tiles at
the end of each picture), span several tiles, more tiles than persistent
CTAs, and more tiles a CTA than its ring holds; its coded flags (nz4) are
held against the I/P/B step's jnp expression.  B6 runs intra and inter,
its warps taking one MB or several (across pictures: 288 MBs of 12 over
2 SMs x 4 CTAs x 8 warps), and on an inter field with bS 1 and 2 under
disable_deblocking_filter_idc 2 with MB edges across slices."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.deblock import PRM_BYTES, deblock_params_plain
from dryv_tpu_torch.kernels.transform import (LEVELS, LS_KEYS, PER_MB,
                                              stage_a_plain)
from dryv_tpu_torch.tables import decoder_tables

from test_torch_stage_a import (_lists, coded_blocks_jax, deblock_inputs,
                                stage_a_inputs)

CSRC = Path(__file__).resolve().parents[1] / "dryv_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"
SMS = 2          # the emulated card's SMs: B5 runs 2 CTAs on each
TIMEOUT = 60     # seconds for one emulated call

# the child: loads the library, rebuilds each pointer from its buffer
# and byte offset, calls the entry, saves the buffers it wrote
CHILD = r"""
import ctypes, json, sys
import numpy as np
lib, entry, spec = sys.argv[1], sys.argv[2], json.load(open(sys.argv[3]))
bufs = dict(np.load(spec["npz"]))
fn = getattr(ctypes.CDLL(lib), entry)
fn.restype = ctypes.c_int
args = [ctypes.c_void_p(None) if a is None else
        ctypes.c_void_p(bufs[a[0]].ctypes.data + a[1]) if isinstance(a, list)
        else ctypes.c_int(a) for a in spec["args"]]
rc = fn(*args, ctypes.c_void_p(None))
np.savez(spec["out"], rc=np.int64(rc), **{k: bufs[k] for k in spec["outs"]})
"""


def _build(tmp, name):
    """csrc/`name`.cu built for the CPU: the library's path."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                 (CSRC / f"{name}.cu").read_text())
    (tmp / f"{name}.cc").write_text(src)
    lib = tmp / f"lib{name}_emu.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", f"-DDT_EMU_SMS={SMS}", f"-I{EMU}",
                        f"-I{CSRC}", str(tmp / f"{name}.cc"), "-o", str(lib)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return lib


def _run(lib, entry, args, outs, tmp):
    """Calls C entry `entry` of `lib` in a child process on `args`
    (tensors as pointers into their storage, None, ints; the stream
    follows) and copies the storage of each tensor of `outs` back from
    it; fails unless the call ends within TIMEOUT and returns 0."""
    bufs, spec = {}, []
    for a in list(args) + list(outs):
        if torch.is_tensor(a) and a.untyped_storage().data_ptr() not in bufs:
            st = a.untyped_storage()
            bufs[st.data_ptr()] = (f"b{len(bufs)}", torch.tensor(
                [], dtype=torch.uint8).set_(st))
    for a in args:
        if torch.is_tensor(a):
            base = a.untyped_storage().data_ptr()
            spec.append([bufs[base][0], a.data_ptr() - base])
        else:
            spec.append(None if a is None else int(a))
    npz, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(npz, **{k: b.numpy() for k, b in bufs.values()})
    names = [bufs[t.untyped_storage().data_ptr()][0] for t in outs]
    (tmp / "spec.json").write_text(json.dumps(
        {"npz": str(npz), "out": str(out), "args": spec, "outs": names}))
    try:
        r = subprocess.run([sys.executable, "-c", CHILD, str(lib), entry,
                            str(tmp / "spec.json")], capture_output=True,
                           text=True, timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"emulated {entry} did not end within {TIMEOUT} s: a "
                    f"barrier no emulated thread completes")
    assert r.returncode == 0, r.stderr
    got = np.load(out)
    assert int(got["rc"]) == 0
    for t, k in zip(outs, names):
        bufs[t.untyped_storage().data_ptr()][1].copy_(
            torch.from_numpy(got[k]))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage_a_emu")
    return {name: _build(d, name) for name in ("stage_a", "deblock_params")}


def _dense_rows(s, F, n, npad):
    """The level segments as column slices of dense rows [F, npad, 408],
    padded past n MBs with junk, as the batched path holds them."""
    dense = torch.full((F, npad, 408), 999, dtype=torch.int16)
    out, col = dict(s), 0
    for k, width in LEVELS:
        dense[:, :n, col:col + width] = s[k]
        out[k] = dense[:, :n, col:col + width]
        col += width
    return out


def _stage_a(lib, s, tabs, F, n, tmp, mb_w=None):
    """B5's outputs (yres, cres, nz4 or None) through the emulated
    kernel; the outputs start as junk."""
    yres = torch.full((F, n, 256), 7, dtype=torch.int16)
    cres = torch.full((F, n, 2, 8, 8), 7, dtype=torch.int16)
    nz4 = None if mb_w is None else torch.full(
        (F, 4 * (n // mb_w), 4 * mb_w), 9, dtype=torch.uint8)
    levels = [s[k] for k, _ in LEVELS]
    outs = [yres, cres] + ([] if nz4 is None else [nz4])
    _run(lib, "dt_stage_a",
         [s[k] for k in PER_MB] + levels + [tabs[k] for k in LS_KEYS]
         + [yres, cres, nz4, F, n, mb_w or 1]
         + [st for t in levels for st in t.stride()[:2]], outs, tmp)
    return yres, cres, nz4


# (mb_w, mb_h), F: tiles of 16 MBs over 2 SMs x 2 CTAs -- 6 tiles of
# which 2 partial; 4 partial tiles; 15 tiles (4 a CTA, past the ring of
# 3); one partial tile at F = 1
STAGE_A_GEOMS = [((8, 6), 2), ((5, 3), 4), ((10, 7), 3), ((1, 1), 1)]


@pytest.mark.parametrize("layout", ["dense rows", "separate"])
@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("geom,F", STAGE_A_GEOMS)
def test_emulated_stage_a_matches_plain(emulated, geom, F, custom, layout,
                                        tmp_path):
    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(7 * n + F + custom)
    s = {k: torch.from_numpy(v)
         for k, v in stage_a_inputs(rng, F, n, amp=600).items()}
    if layout == "dense rows":
        s = _dense_rows(s, F, n, n + 5)
    tabs = decoder_tables("cpu", *_lists(rng, custom))
    yres, cres, _ = _stage_a(emulated["stage_a"], s, tabs, F, n, tmp_path)
    want = stage_a_plain(s, tabs)
    assert (want[0].abs() == 255).any()
    for got, w in zip((yres, cres), want):
        np.testing.assert_array_equal(got.numpy(), w.numpy())


@pytest.mark.parametrize("layout", ["dense rows", "separate"])
@pytest.mark.parametrize("geom,F", STAGE_A_GEOMS)
def test_emulated_stage_a_coded_blocks(emulated, geom, F, layout, tmp_path):
    """B5 asked for nz4: the flags equal the I/P/B step's jnp expression
    on the wire's kinds, and the residual rows stay the plain ones."""
    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(11 * n + F)
    s, native, t8 = stage_a_inputs(rng, F, n, sparse=True)
    s = {k: torch.from_numpy(v) for k, v in s.items()}
    if layout == "dense rows":
        s = _dense_rows(s, F, n, n + 3)
    tabs = decoder_tables("cpu")
    yres, cres, nz4 = _stage_a(emulated["stage_a"], s, tabs, F, n,
                               tmp_path, mb_w)
    for got, w in zip((yres, cres, nz4), stage_a_plain(s, tabs, mb_w)):
        np.testing.assert_array_equal(got.numpy(), w.numpy())
    for f in range(F):
        np.testing.assert_array_equal(
            nz4[f].numpy(), coded_blocks_jax(native[f], t8[f],
                                             s["luma_lv"][f].numpy(), mb_w,
                                             mb_h))


def _deblock_params(lib, args, extra, mb_w, mb_h, F, c0, c1, tmp):
    tabs = decoder_tables("cpu")
    prm = torch.full((F, mb_w * mb_h, PRM_BYTES), 77, dtype=torch.uint8)
    _run(lib, "dt_deblock_params",
         list(args) + [extra.get(k) for k in ("t8", "nz4", "mv", "rs")]
         + [tabs[k] for k in ("alpha", "beta", "tc0", "qpc_tab")]
         + [prm, mb_w, mb_h, F, c0, c1], [prm], tmp)
    return prm, deblock_params_plain(*args, mb_w, mb_h, c0, c1, tabs,
                                     **extra)


@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("geom,F", [((10, 7), 2), ((5, 3), 4), ((4, 3), 24),
                                    ((1, 1), 1)])
def test_emulated_deblock_params_matches_plain(emulated, geom, F, inter,
                                               tmp_path):
    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(3 * n + F + inter)
    _, _, args, extra = deblock_inputs(rng, mb_w, mb_h, F, inter)
    got, want = _deblock_params(emulated["deblock_params"], args, extra,
                                mb_w, mb_h, F, 12, -5, tmp_path)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_emulated_deblock_params_across_slices(emulated, tmp_path):
    """An inter field with bS 1 and 2 on it, every MB under
    disable_deblocking_filter_idc 2: the MB edges across slices drop out
    (bS 0 where the neighbour's slice differs) and the rest is the plain
    version's."""
    mb_w, mb_h, F = 9, 6, 2
    rng = np.random.default_rng(77)
    _, _, args, extra = deblock_inputs(rng, mb_w, mb_h, F, True)
    args[3] = torch.full_like(args[3], 2)
    got, want = _deblock_params(emulated["deblock_params"], args, extra,
                                mb_w, mb_h, F, 3, -3, tmp_path)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    bs = got[..., :16].numpy().reshape(F, mb_h, mb_w, 4, 4)
    assert {1, 2} <= set(np.unique(bs))
    sid = args[2].numpy().reshape(F, mb_h, mb_w)
    across = np.zeros_like(sid, bool)
    across[:, :, 1:] = sid[:, :, 1:] != sid[:, :, :-1]
    assert across.any() and (bs[across][:, 0] == 0).all()
    inside = np.zeros_like(sid, bool)
    inside[:, :, 1:] = sid[:, :, 1:] == sid[:, :, :-1]
    assert (bs[inside][:, 0] > 0).any()
