# Copy of dryv_tpu/avc/__init__.py.
"""AVC syntax layer: NAL units, parameter sets, slice headers, DPB.

Capability parity with the reference's src/video/atom/avcc/ (SPS/PPS/VUI)
and src/video/slice/header.rs — but bidirectional: every structure can be
parsed from and written to a bitstream, because the framework generates its
own conformance fixtures (no external encoder exists in the image).
"""
from .nal import NalUnit, NalUnitType, split_annexb, split_avcc, to_annexb
from .sps import SPS, ScalingLists
from .pps import PPS
from .slice_header import SliceHeader, SliceType

__all__ = [
    "NalUnit", "NalUnitType", "split_annexb", "split_avcc", "to_annexb",
    "SPS", "PPS", "ScalingLists", "SliceHeader", "SliceType",
]
