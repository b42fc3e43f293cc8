"""Build the port's native host library (C++ entropy, recon and deblock).

At first use ``build()`` runs g++ with the flags of the JAX package's
build (``dryv_tpu/native/build.py``) on ``entropy.cc``, ``recon.cc`` and
``deblock.cc`` of this directory, one process per source, and links the
library into ``dryv_tpu_torch/build/`` (``_libbuild``).  Its name hashes
the sources, the flags and what ``-march=native`` means on this machine,
so a library built for one CPU is never loaded on another.
"""
from __future__ import annotations

import subprocess
from pathlib import Path

from .._libbuild import build_library, library_path

HERE = Path(__file__).resolve().parent
SRCS = [HERE / "entropy.cc", HERE / "recon.cc", HERE / "deblock.cc"]
HEADERS = [HERE / "tables_data.h", HERE / "cavlc_tables.h"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-march=native"]


def _target() -> bytes:
    """g++'s resolved target options under -march=native."""
    r = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                       capture_output=True, check=True)
    return r.stdout


def build(force: bool = False) -> Path:
    """Path of the host library, built first if it is missing."""
    lib = library_path("libdryv_host", SRCS + HEADERS,
                       " ".join(CXX_FLAGS).encode() + _target())
    build_library(lib, SRCS,
                  lambda s, o: ["g++", *CXX_FLAGS, "-c", str(s), "-o", str(o)],
                  lambda objs, out: ["g++", "-shared", "-pthread",
                                     *map(str, objs), "-o", str(out)],
                  force=force)
    return lib


if __name__ == "__main__":
    print(build(force=True))
