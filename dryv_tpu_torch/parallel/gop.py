"""Frame-parallel GOP decode: intra pictures are independent, so a GOP
shards over the mesh "gop" axis and each slot reconstructs its pictures
on its device.  Counterpart of ``dryv_tpu/parallel/gop.py``."""
from __future__ import annotations

import numpy as np

from ..pipeline import recon_syntax, tables_for
from ..syntax import stack_frames, syntax_tensors
from .mesh import fork_streams, join_streams, on_stream, slot_streams


def decode_gop_sharded(fs_list, mesh, axis: str = "gop",
                       use_pallas: bool = True):
    """Decode a list of FrameSyntax (one geometry) sharded over the mesh
    `axis`; returns (y [F, H, W], cb, cr) uint8 numpy planes, uncropped.

    Counterpart of ``decode_gop_sharded`` (``dryv_tpu/parallel/gop.py``
    :104-120), which folds ``make_gop_recon_fn`` and
    ``make_gop_recon_pallas_sharded`` in.  The GOP is padded with its
    last picture to a multiple of the axis size; slot i reconstructs
    pictures [i*F_local, (i+1)*F_local) with stage A and kernel B2 at
    F = F_local, on its own CUDA stream.  Flat scaling lists, no in-loop
    filter, as there.  `use_pallas` is kept for the same signature: both
    values take one route, the kernel on CUDA devices and its plain
    version on the CPU."""
    del use_pallas
    if not fs_list:
        raise ValueError("empty GOP")
    mb_w, mb_h = fs_list[0].mb_w, fs_list[0].mb_h
    devs = mesh.axis_devices(axis)
    pad = (-len(fs_list)) % len(devs)
    stacked = stack_frames(list(fs_list) + [fs_list[-1]] * pad)
    Fl = (len(fs_list) + pad) // len(devs)
    streams = slot_streams(devs)
    fork_streams(devs, streams)
    outs = []
    for i, (dev, st) in enumerate(zip(devs, streams)):
        with on_stream(st):
            s = syntax_tensors({k: v[i * Fl:(i + 1) * Fl]
                                for k, v in stacked.items()}, dev)
            outs.append(recon_syntax(s, tables_for(dev), mb_w, mb_h))
    join_streams(devs, streams)
    F = len(fs_list)
    return tuple(np.concatenate([o[p].cpu().numpy() for o in outs])[:F]
                 for p in range(3))
