"""dryv_tpu_torch: the H.264 decode of ``dryv_tpu`` on PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

The host layers (demux, headers, the C++ CABAC entropy stage, the scalar
decoder, the encoder) are the port's own copies of ``dryv_tpu``'s, at
the same relative paths: this package imports nothing of ``dryv_tpu``
and never imports jax, so it runs where ``dryv_tpu/`` is absent.
Importing it builds nothing and imports no triton: the C++ host library
compiles with g++ (``native/build.py``) and the kernels with nvcc
(``_build.py``) at first use.  Its paths, each with ``device="cuda"``
by default (``device="cpu"`` runs the plain versions):

- ``gop_pipeline.decode_annexb_gop_pipelined``: the batched all-intra
  decode;
- ``pipeline.decode_annexb_fast`` / ``decode_annexb_tpu``: the
  per-picture intra path (CAVLC, custom scaling matrices);
- ``device_ipb_packed.decode_annexb_device_packed``: the I/P/B path;
- ``wire``: the packed wire of the batched and I/P/B paths (layout,
  host staging, device decode);
- ``parallel``: the sharded decode over a mesh of devices;
- ``video`` and ``cli``: MP4 in, YUV out.

The benchmark is ``python3 -m avcbench`` at the root of the repository.

The counterparts of the root ``__graft_entry__.py``'s two functions are
``pipeline.entry`` (the per-picture step at 4x4 MBs and its example
arguments) and ``parallel.dryrun_multichip``.
"""
