"""Stored digests of the libavcodec oracle's pictures for the bench's
streams that have no ``.npz`` golden: ``benchdata/bench1080p_gop16.264``
(16 pictures) and ``benchdata/bench1080p_ipb.264`` (10 pictures).

``goldens.json`` beside this file holds, for each stream, one entry per
picture in output order: the SHA-256 of each cropped plane (``digest``).
The entries were made from the oracle's own decode
(``tools/torch_goldens.py``, which needs the JAX package's
``testing.oracle`` and cv2); a machine without cv2 holds the port's
output against them with ``check``.
"""
from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("goldens.json")
PLANES = ("y", "cb", "cr")


def _host(plane):
    """A plane as a C-contiguous uint8 numpy array (a torch tensor is
    copied to the host first)."""
    if hasattr(plane, "detach"):
        plane = plane.detach().cpu().numpy()
    a = np.ascontiguousarray(plane)
    if a.dtype != np.uint8 or a.ndim != 2:
        raise ValueError(f"a plane is a 2-D uint8 array, got {a.dtype} "
                         f"{a.shape}")
    return a


def digest(y, cb, cr) -> dict:
    """{plane: SHA-256 hex} of one picture's planes; each hash covers the
    plane's height and width and then its bytes, row by row."""
    out = {}
    for name, p in zip(PLANES, (y, cb, cr)):
        a = _host(p)
        h = hashlib.sha256(f"{a.shape[0]}x{a.shape[1]}:".encode())
        h.update(a.tobytes())
        out[name] = h.hexdigest()
    return out


@functools.lru_cache(maxsize=None)
def _stored() -> dict:
    return json.loads(PATH.read_text())


def stored(name) -> list:
    """The stored digests of stream `name` (a file name in
    ``benchdata/``), one dict per picture in output order."""
    return _stored()[name]


def check(name, frames, digests=None) -> None:
    """Raise AssertionError at the first picture of `frames` (each a
    (y, cb, cr) of cropped planes, numpy or torch) whose planes differ
    from the digests (default: the stored ones of `name`), naming its
    index and plane; also when the picture counts differ."""
    want = stored(name) if digests is None else digests
    frames = list(frames)
    if len(frames) != len(want):
        raise AssertionError(f"{name}: {len(frames)} pictures, the oracle "
                             f"gave {len(want)}")
    for i, (planes, w) in enumerate(zip(frames, want)):
        got = digest(*planes)
        for p in PLANES:
            if got[p] != w[p]:
                raise AssertionError(f"{name}: picture {i} plane {p} "
                                     f"differs from the oracle")
