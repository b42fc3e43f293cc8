"""Build and bind the hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links them into one
shared library with a plain C interface under ``build/`` (``_libbuild``:
listed in ``.gitignore``, named by a hash of the sources and flags so an
edit rebuilds it).  The library is loaded with ``ctypes``: every pointer
and the stream are ``c_void_p`` (``None`` passes a null pointer), every
size a ``c_int``.  Each C entry returns ``cudaGetLastError()`` after its
launch, and ``call`` raises when that is not 0.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import torch

from ._libbuild import build_library, library_path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# C entry point -> argument kinds: "p" device pointer (or None), "i" int.
# The stream is appended to every call.
ENTRIES = {
    "dt_densify": "pppii",
    "dt_intra_wavefront": "pppppppppppppiii",
    "dt_deblock": "pppppiii",
    "dt_inter_mc": "p" * 14 + "i" * 10,
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/ unless an up-to-date library is
    there; returns its path.  verbose=True rebuilds with -Xptxas -v and
    prints the compiler's report (registers, shared memory, spills)."""
    srcs = sorted(CSRC.glob("*.cu"))
    lib_path = library_path("libdryv_kernels",
                            srcs + sorted(CSRC.glob("*.cuh")),
                            " ".join(NVCC_FLAGS).encode())
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    log = build_library(
        lib_path, srcs,
        lambda s, o: [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
        lambda objs, out: [nvcc, "-shared", *map(str, objs), "-o", str(out)],
        force=verbose)
    if verbose:
        print(log)
    return lib_path


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, kinds in ENTRIES.items():
            fn = getattr(handle, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                           for k in kinds] + [ctypes.c_void_p]
        handle.dt_error_string.restype = ctypes.c_char_p
        handle.dt_error_string.argtypes = [ctypes.c_int]
        _lib = handle
    return _lib


def check_cuda(*tensors):
    """Every tensor on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def call(name: str, *args):
    """Launch C entry `name` on the current stream; raise on any CUDA
    error it reports."""
    h = lib()
    kinds = ENTRIES[name]
    if len(args) != len(kinds):
        raise TypeError(f"{name} takes {len(kinds)} arguments")
    cargs = [int(a) if k == "i" else
             ctypes.c_void_p(None if a is None else a.data_ptr())
             for k, a in zip(kinds, args)]
    dev = next(a.device for k, a in zip(kinds, args)
               if k == "p" and a is not None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(h, name)(*cargs, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{h.dt_error_string(rc).decode()}")
