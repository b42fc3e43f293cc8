"""Frame-parallel GOP decode: intra pictures are independent, so a GOP
shards over the mesh "gop" axis and each slot reconstructs its pictures
on its device.  Counterpart of ``dryv_tpu/parallel/gop.py``."""
from __future__ import annotations

import torch

from ..graphs import Split
from ..pipeline import recon_syntax, tables_for
from ..syntax import stack_frames, syntax_tensors
from .mesh import (cat, enable_peers, fork_streams, join_streams, on_stream,
                   run_eager, run_step, slot_groups, slot_streams, step_key)


def decode_gop_sharded(fs_list, mesh, axis: str = "gop",
                       use_pallas: bool = True, graph: bool = True):
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
    version on the CPU.  With `graph` (the default) each group of slots
    on one device (``mesh.slot_groups``) replays as a CUDA graph of its
    own, one step per key (slot devices, axis, mb_w, mb_h, F_local, the
    syntax tensors' names, and the groups when there are several;
    ``mesh.STEPS``), the counterpart of the JAX version's
    ``jax.jit(shard_map(...))``; each group's graph copies its pictures
    into the step's planes on the first slot's device.  ``graph=False``
    runs the same parts op by op, counted in ``STEPS.eager``."""
    del use_pallas
    key, make, xs = step_args(fs_list, mesh, axis)
    planes = run_step(key, make, xs) if graph else run_eager(make(), xs)
    return tuple(p.cpu().numpy()[:len(fs_list)] for p in planes)


def step_args(fs_list, mesh, axis: str = "gop"):
    """(key, maker, inputs) of ``decode_gop_sharded``'s step: the inputs
    are each slot's syntax tensors on the host, the GOP padded with its
    last picture; the maker's ``Split`` has one part per slot group, each
    writing its pictures into the step's planes (``graphs.peer_copy``)."""
    if not fs_list:
        raise ValueError("empty GOP")
    mb_w, mb_h = fs_list[0].mb_w, fs_list[0].mb_h
    devs = mesh.axis_devices(axis)
    pad = (-len(fs_list)) % len(devs)
    Fl = (len(fs_list) + pad) // len(devs)
    s = syntax_tensors(stack_frames(list(fs_list) + [fs_list[-1]] * pad),
                       "cpu")
    names = tuple(sorted(s))
    xs = [s[k][i * Fl:(i + 1) * Fl] for i in range(len(devs))
          for k in names]
    groups = slot_groups(devs)

    def make():
        k = len(names)
        streams = slot_streams(devs)
        enable_peers(devs)
        parts = [(devs[g[0]], k * len(g),
                  _gop_fn([devs[i] for i in g], [streams[i] for i in g],
                          mb_w, mb_h, names)) for g in groups]
        return Split(parts)

    return (step_key((tuple(devs), axis, mb_w, mb_h, Fl, names), groups),
            make, xs)


def _gop_fn(devs, streams, mb_w, mb_h, names):
    """A part's function, captured or run op by op: fn(*each slot's
    syntax tensors in `names` order) -> (y, cb, cr) [F_local * slots, ...]
    on its device (every slot of a group is on one), each slot's stage A
    and B2 on its stream of `streams`, forked from the current stream and
    joined to it again."""
    tabs = [tables_for(d) for d in devs]
    k = len(names)

    def fn(*xs):
        fork_streams(devs, streams)
        outs = []
        for i, (st, tab) in enumerate(zip(streams, tabs)):
            with on_stream(st):
                outs.append(recon_syntax(dict(zip(names, xs[i * k:
                                                        (i + 1) * k])),
                                         tab, mb_w, mb_h))
        join_streams(devs, streams)
        for o, dev, st in zip(outs, devs, streams):
            if st is not None:
                for t in o:
                    t.record_stream(torch.cuda.current_stream(dev))
        return tuple(cat([o[p] for o in outs]) for p in range(3))
    return fn
