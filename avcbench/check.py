"""The comparison that decides ``correct``.

The reference is the H.264 decoding process as libavcodec carries it out:
each pool picture's cropped Y, Cb and Cr planes, as SHA-256 digests in the
configuration's ``golden.json`` (made by ``tools/goldens.py``; never from
the program's output).  A request's planes, copied to the host once its
timing has been taken, are compared picture by picture in display order;
a picture that differs in one sample, is missing or is extra counts as
wrong.  The comparison is exact: its limit is 0.
"""
from __future__ import annotations

import hashlib

import numpy as np

PLANES = ("y", "cb", "cr")

# each number compared, with its limit: a run is correct when none is over
LIMITS = {"pictures_wrong": 0, "requests_failed": 0}


def digest(y, cb, cr) -> dict:
    """{plane: SHA-256 hex} of one picture's cropped planes (2-D uint8);
    each hash covers "HxW:" and then the plane's bytes row by row."""
    out = {}
    for name, p in zip(PLANES, (y, cb, cr)):
        a = np.ascontiguousarray(p)
        if a.dtype != np.uint8 or a.ndim != 2:
            raise ValueError(f"a plane is a 2-D uint8 array, got {a.dtype} "
                             f"{a.shape}")
        h = hashlib.sha256(f"{a.shape[0]}x{a.shape[1]}:".encode())
        h.update(a.data)
        out[name] = h.hexdigest()
    return out


def pictures_wrong(got, want) -> int:
    """Pictures of `got` (cropped (y, cb, cr) tuples, display order) whose
    digest differs from `want`'s at the same place, plus the pictures one
    list has beyond the other."""
    wrong = abs(len(got) - len(want))
    for planes, w in zip(got, want):
        wrong += digest(*planes) != w
    return wrong


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def lines(numbers: dict) -> list:
    """Each number compared beside its limit, one line each."""
    return [f"check {k} = {numbers[k]} (limit {lim})"
            for k, lim in LIMITS.items()]
