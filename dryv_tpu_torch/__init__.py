"""dryv_tpu_torch: the batched all-intra H.264 decode of ``dryv_tpu`` on
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The host layers (demux, headers, the C++ CABAC entropy stage, the scalar
decoder, the encoder) are the port's own copies of ``dryv_tpu``'s, at
the same relative paths: this package imports nothing of ``dryv_tpu``
and never imports jax, so it runs where ``dryv_tpu/`` is absent.
Importing it builds nothing and imports no triton: the C++ host library
compiles with g++ (``native/build.py``) and the kernels with nvcc
(``_build.py``) at first use.  Entry point:
``gop_pipeline.decode_annexb_gop_pipelined(stream, device="cuda")``.
"""
