# Copy of dryv_tpu/cabac/__init__.py.
"""CABAC entropy layer (ITU-T H.264 §9.3).

The reference implements this as src/video/cabac/ (~3.1k LoC Rust) fused with
reconstruction; here the entropy stage is a standalone host-side component
that emits dense per-frame coefficient/mode tensors for the TPU kernels.
"""
from .engine import CabacDecoder
from .encoder import CabacEncoder
from . import tables

__all__ = ["CabacDecoder", "CabacEncoder", "tables"]
