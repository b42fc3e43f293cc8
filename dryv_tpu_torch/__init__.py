"""dryv_tpu_torch: the batched all-intra H.264 decode of ``dryv_tpu`` on
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The host layers (demux, headers, the C++ CABAC entropy stage) are
imported from ``dryv_tpu``; this package never imports jax.  Importing it
builds nothing and imports no triton: the kernels compile with nvcc at
first use (``_build.py``).  Entry point:
``gop_pipeline.decode_annexb_gop_pipelined(stream, device="cuda")``.
"""
