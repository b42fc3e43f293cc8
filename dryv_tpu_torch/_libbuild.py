"""Build a shared library from C++ or CUDA sources at first use.

Both of the port's native libraries are built this way: the C++ host
library (``native/build.py``: entropy, recon and deblock, with g++) and
the hand-written CUDA kernels (``_build.py``, with nvcc).  Each source
compiles to an object in its own compiler process, all started
together, and one more process links them.  The library goes into
``dryv_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash of
the sources, their headers and the flags, so an edit rebuilds it.  The
build runs under a file lock and ends with ``os.replace`` of a finished
file, so processes that start together (test workers) build once and
never load a half-written library.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD = Path(__file__).resolve().parent / "build"


def library_path(stem: str, deps, key: bytes) -> Path:
    """Where the library of `deps` (sources and headers) and `key` (the
    flags, and whatever else its code depends on) lives."""
    h = hashlib.sha256(key)
    for p in sorted(deps):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"{stem}_{h.hexdigest()[:16]}.so"


def build_library(lib: Path, srcs, compile_cmd, link_cmd,
                  force: bool = False) -> str:
    """Compile `srcs` and link them into `lib` unless it exists (or
    `force`).  compile_cmd(src, obj) and link_cmd(objs, out) give the
    argument vectors.  Returns the compilers' output ("" when the library
    was already there); raises RuntimeError when a step fails."""
    if lib.exists() and not force:
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / f"{lib.name.rsplit('_', 1)[0]}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and not force:
            return ""
        tmp = Path(tempfile.mkdtemp(dir=BUILD))
        try:
            objs = [tmp / f"{s.stem}.o" for s in srcs]
            procs = [subprocess.Popen(compile_cmd(s, o), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(srcs, objs)]
            logs = [p.communicate()[0] for p in procs]
            for s, p, log in zip(srcs, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"compiling {s.name} failed "
                                       f"({p.returncode}):\n{log}")
            out = tmp / lib.name
            r = subprocess.run(link_cmd(objs, out), capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise RuntimeError(f"linking {lib.name} failed "
                                   f"({r.returncode}):\n{r.stdout}{r.stderr}")
            os.replace(out, lib)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return "".join(logs)
