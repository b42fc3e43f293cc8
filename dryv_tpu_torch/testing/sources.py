# Copy of make_source and POLICIES from dryv_tpu/testing/fixtures.py.
"""Synthetic source pictures and MB-kind policies for the repo's own
intra encoder (``dryv_tpu_torch.encoder``)."""
from __future__ import annotations

import numpy as np


def make_source(mb_w: int, mb_h: int, seed: int = 42):
    rng = np.random.RandomState(seed)
    W, H = mb_w * 16, mb_h * 16
    yy = np.clip(rng.randint(0, 256, (H, W)).astype(np.float64) * 0.3 +
                 np.linspace(0, 200, W)[None, :] +
                 np.linspace(0, 40, H)[:, None], 0, 255).astype(np.int64)
    cb = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 100,
                 0, 255).astype(np.int64)
    cr = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 80,
                 0, 255).astype(np.int64)
    return yy, cb, cr


POLICIES = {
    "mix48": lambda a: ["i4", "i8"][a % 2],
    "i16": lambda a: "i16",
    "i4": lambda a: "i4",
    "i8": lambda a: "i8",
    "pcm": lambda a: "pcm",
    "mix": lambda a: ["i16", "i4", "pcm"][a % 3],
    "mix8": lambda a: ["i8", "i4", "i16", "pcm"][a % 4],
    "mix420": lambda a: ["i16", "i4"][a % 2],  # no PCM (4:2:2 fixture)
}
