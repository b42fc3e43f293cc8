"""The decoder's constant tables as device tensors.

This decoder has no weights; its parameters are the normative tables.
``decoder_tables`` turns the numpy tables of the port's copies of the JAX
package's host layers into one dict of tensors on the target device, so
the port and the reference compute from the same numbers.  LevelScale arrays other than the flat defaults can be
passed in (custom scaling matrices).
"""
from __future__ import annotations

import numpy as np
import torch

from functools import lru_cache

from .avc.neighbors import ZSCAN_4X4_POS
from .kernels.geometry import (BLK4_A, BLK4_B, BLK4_C, BLK8_A, BLK8_B,
                               BLK8_C, BLK8_D, LS4_FLAT, LS8_FLAT, SP2Q,
                               SP2Z, Z2SP)
from .kernels.pred_tables import tables_4x4, tables_8x8
from .refimpl.deblock import ALPHA, BETA, TC0
from .refimpl.transform import QPC_TAB


# permutations the device paths index with: z-scan 4x4 block -> raster
# position 4*by + bx ("z2p"; its inverse "p2z"), and the luma residual
# row orders of kernels.geometry
_INDEX = {"z2p": np.asarray([4 * y + x for (x, y) in ZSCAN_4X4_POS]),
          "z2sp": Z2SP, "sp2z": SP2Z, "sp2q": SP2Q}
_INDEX["p2z"] = np.argsort(_INDEX["z2p"])


@lru_cache(maxsize=None)
def index_on(name: str, device) -> torch.Tensor:
    """The permutation `name` of ``_INDEX`` as a long tensor on `device`,
    made once per device: a fresh copy from host memory would wait for
    the work already queued on the device."""
    return torch.as_tensor(_INDEX[name], dtype=torch.long, device=device)


def chroma_qp(qp, off, qpc_tab):
    """QP'c from QP'y and a chroma offset (Table 8-15), on tensors."""
    qpi = (qp + off).clamp(0, 51)
    return torch.where(qpi < 30, qpi, qpc_tab[(qpi - 30).clamp(0, 21)])


def _taps(tables):
    """(IDX, W, R, S) -> uint8 [modes, positions, 8] rows of
    (idx0, idx1, idx2, w0, w1, w2, round, shift)."""
    idx, w, r, s = tables
    out = np.concatenate([idx, w, r[..., None], s[..., None]], axis=-1)
    assert out.min() >= 0 and out.max() < 256
    return out.astype(np.uint8)


def decoder_tables(device, ls4y=LS4_FLAT, ls4cb=LS4_FLAT, ls4cr=LS4_FLAT,
                   ls8y=LS8_FLAT) -> dict:
    """Returns the dict of constant tensors on `device`:

    ls4y/ls4cb/ls4cr [6,16], ls8y [6,64] int32 LevelScale rows;
    qpc_tab [22], alpha [52], beta [52], tc0 [52,3] int32;
    tap4 [9,16,8] / tap8 [9,64,8] uint8 intra tap rows (pred_tables);
    avail4 [3,16] (A, B, C sources per z-scan 4x4 block) and avail8 [4,4]
    (A, B, C, D sources per 8x8 block) uint8 availability codes."""
    def i32(a, shape=None):
        a = np.ascontiguousarray(np.asarray(a, np.int32))
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(a).to(device)

    def u8(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.uint8))).to(device)

    return {
        "ls4y": i32(ls4y, (6, 16)),
        "ls4cb": i32(ls4cb, (6, 16)),
        "ls4cr": i32(ls4cr, (6, 16)),
        "ls8y": i32(ls8y, (6, 64)),
        "qpc_tab": i32(QPC_TAB),
        "alpha": i32(ALPHA),
        "beta": i32(BETA),
        "tc0": i32(TC0),
        "tap4": u8(_taps(tables_4x4())),
        "tap8": u8(_taps(tables_8x8())),
        "avail4": u8(np.stack([BLK4_A, BLK4_B, BLK4_C])),
        "avail8": u8(np.stack([BLK8_A, BLK8_B, BLK8_C, BLK8_D])),
    }
