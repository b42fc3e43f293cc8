"""Kernels B5 (``csrc/stage_a.cu``) and B6 (``csrc/deblock_params.cu``)
run on the CPU from their CUDA sources and held against their plain
versions ``stage_a_plain`` and ``deblock_params_plain`` at tolerance 0.

Each source is compiled by g++ against ``tests/cuda_emu/cuda_runtime.h``
(a launch rewritten from ``<<<>>>`` runs its grid block by block, a
thread per CUDA thread, ``__syncthreads`` and ``__syncwarp`` as
barriers), as ``tests/test_torch_inter_emulated.py`` does for B4.  B5
takes its levels both as column slices of padded dense rows (the batched
path's [F, npad, 408] wire) and as separate tensors (the per-picture
syntax); B6 its intra and inter forms.  MB counts fill a block partly
and more than once (B5: 8 MBs a block, B6: 128)."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.deblock import PRM_BYTES, deblock_params_plain
from dryv_tpu_torch.kernels.transform import (LEVELS, LS_KEYS, PER_MB,
                                              stage_a_plain)
from dryv_tpu_torch.tables import decoder_tables

from test_torch_stage_a import _lists, deblock_inputs, stage_a_inputs

CSRC = Path(__file__).resolve().parents[1] / "dryv_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"


def _build(tmp, name, entry, n_ptr, n_int):
    """The C entry `entry` of csrc/`name`.cu, built for the CPU."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                 (CSRC / f"{name}.cu").read_text())
    (tmp / f"{name}.cc").write_text(src)
    lib = tmp / f"lib{name}_emu.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", f"-I{EMU}", f"-I{CSRC}",
                        str(tmp / f"{name}.cc"), "-o", str(lib)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage_a_emu")
    return {"stage_a": _build(d, "stage_a", "dt_stage_a", 14, 10),
            "deblock_params": _build(d, "deblock_params",
                                     "dt_deblock_params", 15, 5)}


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


@pytest.mark.parametrize("layout", ["dense rows", "separate"])
@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_emulated_stage_a_matches_plain(emulated, geom, F, custom, layout):
    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(7 * n + F + custom)
    s = {k: torch.from_numpy(v)
         for k, v in stage_a_inputs(rng, F, n, amp=600).items()}
    if layout == "dense rows":
        s = _dense_rows(s, F, n, n + 5)
    tabs = decoder_tables("cpu", *_lists(rng, custom))
    yres = torch.full((F, n, 256), 7, dtype=torch.int16)
    cres = torch.full((F, n, 2, 8, 8), 7, dtype=torch.int16)
    levels = [s[k] for k, _ in LEVELS]
    assert emulated["stage_a"](
        *(_ptr(s[k]) for k in PER_MB), *map(_ptr, levels),
        *(_ptr(tabs[k]) for k in LS_KEYS), _ptr(yres), _ptr(cres), F, n,
        *(st for t in levels for st in t.stride()[:2]), None) == 0
    want = stage_a_plain(s, tabs)
    assert (want[0].abs() == 255).any()
    for got, w in zip((yres, cres), want):
        np.testing.assert_array_equal(got.numpy(), w.numpy())


@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("geom,F", [((10, 7), 2), ((5, 3), 4), ((1, 1), 1)])
def test_emulated_deblock_params_matches_plain(emulated, geom, F, inter):
    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(3 * n + F + inter)
    _, _, args, extra = deblock_inputs(rng, mb_w, mb_h, F, inter)
    tabs = decoder_tables("cpu")
    prm = torch.full((F, n, PRM_BYTES), 77, dtype=torch.uint8)
    c0, c1 = 12, -5
    assert emulated["deblock_params"](
        *map(_ptr, args), *(_ptr(extra.get(k))
                            for k in ("t8", "nz4", "mv", "rs")),
        *(_ptr(tabs[k]) for k in ("alpha", "beta", "tc0", "qpc_tab")),
        _ptr(prm), mb_w, mb_h, F, c0, c1, None) == 0
    want = deblock_params_plain(*args, mb_w, mb_h, c0, c1, tabs, **extra)
    np.testing.assert_array_equal(prm.numpy(), want.numpy())
