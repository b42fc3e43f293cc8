"""Dense per-picture syntax (``coeffs.FrameSyntax``) as the
port's syntax tensors.

``FrameSyntax`` is what the JAX package's per-picture and sharded paths
reconstruct from (``dryv_tpu/pipeline.py``, ``dryv_tpu/parallel/``);
``syntax_tensors`` turns a stack of them into the dict that
``kernels.transform.stage_a`` and ``kernels.wavefront.recon_inputs``
take, the same dict the batched pipeline builds from its wire
(``gop_pipeline.PackedGopDecoder``).

``SYNTAX_KEYS`` is a copy of ``dryv_tpu/pipeline.py``'s (that module
imports jax); ``tests/test_torch_helpers.py`` holds it equal.
"""
from __future__ import annotations

import numpy as np
import torch

from .coeffs import KIND_I8, KIND_PCM

SYNTAX_KEYS = ["kind", "qp_y", "qp_cb", "qp_cr", "i16_mode", "chroma_mode",
               "modes4", "modes8", "luma4", "luma8", "luma_dc", "chroma_dc",
               "chroma_ac", "pcm_y", "pcm_c",
               "avail_a", "avail_b", "avail_c", "avail_d"]

_AS_IS = ("kind", "qp_y", "qp_cb", "qp_cr", "i16_mode", "chroma_mode",
          "modes4", "modes8", "avail_a", "avail_b", "avail_c", "avail_d")


def stack_frames(fs_list):
    """FrameSyntax list -> dict of [F, n, ...] numpy arrays; the
    counterpart of ``dryv_tpu/parallel/gop.py`` ``stack_frames``."""
    return {k: np.stack([np.asarray(getattr(f, k)) for f in fs_list])
            for k in SYNTAX_KEYS}


def syntax_tensors(stacked, device):
    """[F, n, ...] numpy syntax (``stack_frames``) -> dict of [F, n, ...]
    tensors on `device`: the FrameSyntax fields as they are (qp_cb/qp_cr
    included), the int16 levels luma_lv [., 256] (the luma8 rows for I8
    MBs, luma4 rows otherwise, as the batched wire carries them),
    luma_dc [., 16], chroma_dc [., 8], chroma_ac [., 128], and pcm_y
    [., 256] / pcm_c [., 2, 8, 8] only when some MB is PCM."""
    kind = np.asarray(stacked["kind"])
    F, n = kind.shape

    def t(a, *shape, dtype=None):
        a = np.ascontiguousarray(a, dtype)
        return torch.from_numpy(a.reshape(F, n, *shape) if shape else a) \
            .to(device)

    s = {k: t(stacked[k]) for k in _AS_IS}
    s["luma_lv"] = t(np.where((kind == KIND_I8)[..., None],
                              stacked["luma8"].reshape(F, n, 256),
                              stacked["luma4"].reshape(F, n, 256)),
                     dtype=np.int16)
    for k, width in (("luma_dc", 16), ("chroma_dc", 8), ("chroma_ac", 128)):
        s[k] = t(stacked[k], width, dtype=np.int16)
    if (kind == KIND_PCM).any():
        s["pcm_y"] = t(stacked["pcm_y"], 256)
        s["pcm_c"] = t(stacked["pcm_c"], 2, 8, 8)
    return s
