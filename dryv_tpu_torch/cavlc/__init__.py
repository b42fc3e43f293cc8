# Copy of dryv_tpu/cavlc/__init__.py.
"""CAVLC entropy layer (spec 9.2) — the reference left this as
`todo!()` (slice/mod.rs:299); implemented here symmetric decode/encode."""
from .syntax import CavlcSliceCoder  # noqa: F401
