# Copy of dryv_tpu/bitio/__init__.py.
"""Bitstream substrate: MSB-first readers/writers with RBSP emulation handling.

Mirrors the capability of the reference's src/byte/bit.rs (BitStream with
inline emulation-prevention-byte removal, exp-Golomb, alignment helpers) but
is designed for the TPU-native pipeline: EPB stripping is done once up-front
per NAL (``strip_emulation_prevention``) so the hot entropy loop reads from a
clean RBSP buffer.
"""
from .bitreader import BitReader, strip_emulation_prevention
from .bitwriter import BitWriter, insert_emulation_prevention

__all__ = [
    "BitReader",
    "BitWriter",
    "strip_emulation_prevention",
    "insert_emulation_prevention",
]
