# Copy of dryv_tpu/encoder/__init__.py.
"""Conformance-fixture H.264 intra encoder.

No external encoder (x264/ffmpeg) exists in this image, so the framework
generates its own test bitstreams: I-slices with I_PCM, I_16x16, I_4x4 and
I_8x8 macroblocks, CABAC-coded.  Streams are validated against the bundled
libavcodec decoder (dryv_tpu.testing.oracle), whose YUV output is the golden
reference for the TPU decode pipeline.
"""
from .slices import encode_islice_nal, encode_frame_annexb, default_sps_pps

__all__ = ["encode_islice_nal", "encode_frame_annexb", "default_sps_pps"]
