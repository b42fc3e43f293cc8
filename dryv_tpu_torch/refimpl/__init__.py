# Copy of dryv_tpu/refimpl/__init__.py.
"""Scalar (numpy) reference implementation of AVC intra reconstruction.

This is the correctness anchor of the framework: a direct, per-macroblock
implementation of spec 8.3 (intra prediction) and 8.5 (inverse transforms)
mirroring the reference's frame layer (src/video/frame/).  It is used by
the fixture encoder as its reconstruction feedback loop and by the tests as
the golden producer that the TPU (JAX/Pallas) pipeline must match
bit-exactly.  It is NOT the production decode path.
"""
from .transform import (
    level_scale_4x4,
    level_scale_8x8,
    dequant_idct_4x4,
    idct_dc_16x16,
    idct_chroma_dc,
    dequant_idct_8x8,
    qpc_from_qpy,
)
from .recon import FrameRecon

__all__ = [
    "level_scale_4x4", "level_scale_8x8", "dequant_idct_4x4",
    "idct_dc_16x16", "idct_chroma_dc", "dequant_idct_8x8",
    "qpc_from_qpy", "FrameRecon",
]
