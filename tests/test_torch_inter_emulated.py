"""Kernel B4's CUDA source (``dryv_tpu_torch/csrc/inter_mc.cu``) run on
the CPU and held against its plain version ``mc_frame_wire_plain`` at
tolerance 0.

The source is compiled by g++ against ``tests/cuda_emu/cuda_runtime.h``,
a stand-in for the CUDA runtime: a launch (rewritten from ``<<<>>>``)
runs its grid one block at a time with a thread per CUDA thread, and
``__syncthreads`` and the warp collectives are barriers.  The kernel's
own launch geometry, lane mapping, warp-uniform paths, shared memory and
stores run as written; what the emulation cannot show is speed, and
faults of the card's memory model.  Fields: random vectors per 4x4
block near the block and past every edge, and H.264 layouts from
``testing.motion.partitioned_field`` (all kinds mixed, no sub-8x8 split,
and that at full-pel vectors, which takes the kernel's copy paths), P
and B, weighted prediction 0/1/2, geometries whose block rows fill a
warp partly and more than once, and a band placed by ``row0``."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.inter import mc_frame_wire_plain
from dryv_tpu_torch.testing.motion import KINDS, partitioned_field

CSRC = Path(__file__).resolve().parents[1] / "dryv_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"
FIELDS = ("random near", "random far", "mixed", "coarse", "full-pel")
GEOMS = ((6, 4), (5, 3), (10, 3))


@pytest.fixture(scope="module")
def emulated_mc(tmp_path_factory):
    """mc_frame's contract on the CPU through the emulated kernel."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    d = tmp_path_factory.mktemp("inter_mc_emu")
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                 (CSRC / "inter_mc.cu").read_text())
    (d / "inter_mc.cc").write_text(src)
    lib = d / "libinter_mc_emu.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", f"-I{EMU}", f"-I{CSRC}",
                        str(d / "inter_mc.cc"), "-o", str(lib)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    fn = ctypes.CDLL(str(lib)).dt_inter_mc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]

    def run(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w, mb_h,
            row0=0):
        n, mode = mb_w * mb_h, wp["mode"]
        py = torch.full((n, 16, 16), 77, dtype=torch.uint8)
        pc = torch.full((n, 2, 8, 8), 77, dtype=torch.uint8)
        tabs = [wp[k] if mode else None
                for k in ("ri0", "ri1", "expl", "imp", "misc")]
        ptr = [None if t is None else t.data_ptr() for t in
               (refs_y, refs_cb, refs_cr, mv0, mv1, rs0, rs1, *tabs, py, pc)]
        assert fn(*ptr, *refs_y.shape, mb_w, mb_h, row0, mv0.stride(0),
                  rs0.stride(0), 1 if rs1 is None else 2, mode, None) == 0
        return py, pc

    return run


def _field(kind, rng, mb_w, mb_h, R, nlists):
    n4 = 16 * mb_w * mb_h
    if kind.startswith("random"):
        reach = 4 * 20 if kind == "random near" else 4 * (16 * mb_w + 40)
        use = rng.integers(0, 4, n4)
        rs0 = np.where(use & 1, rng.integers(0, R, n4), -1)
        rs1 = np.where(use & 2, rng.integers(0, R, n4), -1)
        return {"rs0": rs0, "rs1": rs1,
                "ri0": np.where(rs0 >= 0, rng.integers(0, 4, n4), -1),
                "ri1": np.where(rs1 >= 0, rng.integers(0, 4, n4), -1),
                "mv0": rng.integers(-reach, reach + 1, (n4, 2)),
                "mv1": rng.integers(-reach, reach + 1, (n4, 2))}
    kinds = KINDS if kind == "mixed" else KINDS[:-1]
    f = partitioned_field(rng, mb_w, mb_h, R, nlists, kinds)
    if kind == "full-pel":
        f["mv0"], f["mv1"] = f["mv0"] & ~3, f["mv1"] & ~3
    return f


def _args(rng, f, nlists, wp_mode, mb_w, mb_h, R, H=None):
    """mc_frame's arguments on the packed wire's layout (int16 vectors
    [n4, 2, 2], int8 slots and reference indices [n4, 4], strided views),
    random stacks of H luma rows and WP tables."""
    H = H or 16 * mb_h
    stacks = [torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
              for s in ((R, H, 16 * mb_w), (R, H // 2, 8 * mb_w),
                        (R, H // 2, 8 * mb_w))]
    mv = torch.from_numpy(np.stack([f["mv0"], f["mv1"]], 1)
                          .astype(np.int16))
    rsri = torch.from_numpy(np.stack([f["rs0"], f["rs1"], f["ri0"],
                                      f["ri1"]], 1).astype(np.int8))
    expl = np.zeros((2, 32, 6), np.int16)
    expl[:, :4] = rng.integers(-128, 128, (2, 4, 6))
    imp = np.zeros((256, 2), np.int16)
    imp[:16] = rng.integers(-64, 129, (16, 2))
    wp = {"mode": wp_mode, "ri0": rsri[:, 2], "ri1": rsri[:, 3],
          "expl": torch.from_numpy(expl), "imp": torch.from_numpy(imp),
          "misc": torch.tensor([5, 6, 4, 0], dtype=torch.int32)}
    b = nlists == 2
    return (*stacks, rsri[:, 0], rsri[:, 1] if b else None, mv[:, 0],
            mv[:, 1] if b else None, wp, mb_w, mb_h)


@pytest.mark.parametrize("wp_mode", [0, 1, 2])
@pytest.mark.parametrize("nlists", [1, 2])
@pytest.mark.parametrize("kind", FIELDS)
def test_emulated_kernel_matches_plain(emulated_mc, kind, nlists, wp_mode):
    i = FIELDS.index(kind)
    mb_w, mb_h = GEOMS[(i + nlists + wp_mode) % len(GEOMS)]
    rng = np.random.default_rng(100 * i + 10 * nlists + wp_mode)
    a = _args(rng, _field(kind, rng, mb_w, mb_h, 3, nlists), nlists,
              wp_mode, mb_w, mb_h, 3)
    for got, want in zip(emulated_mc(*a), mc_frame_wire_plain(*a)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("nlists", [1, 2])
def test_emulated_kernel_on_a_band(emulated_mc, nlists):
    """Two MB rows of fields placed by row0 = 8 in planes of 5 MB rows."""
    rng = np.random.default_rng(40 + nlists)
    f = _field("mixed", rng, 6, 2, 2, nlists)
    a = _args(rng, f, nlists, 1, 6, 2, 2, H=16 * 5)
    for got, want in zip(emulated_mc(*a, row0=8),
                         mc_frame_wire_plain(*a, row0=8)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
