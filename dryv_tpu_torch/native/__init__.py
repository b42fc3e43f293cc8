"""The port's native (C++) host components: the CABAC/CAVLC entropy hot
path, scalar recon and deblock, copies of ``dryv_tpu/native``.

Built with g++ at first use into ``dryv_tpu_torch/build/``
(``python -m dryv_tpu_torch.native.build``, or implicitly on the first
call into ``dryv_tpu_torch.native.entropy``).
"""
