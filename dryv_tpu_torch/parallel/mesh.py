"""Device mesh of the port: a named grid of ``torch.device``s.

Counterpart of ``dryv_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one process drives a ``jax.sharding.Mesh`` through
``shard_map``.  The port keeps that design: one process holds the grid,
puts each shard's tensors on its slot's device and runs the slot's work
on a CUDA stream of its own, so slots overlap on one card and on several
the copies between them go peer to peer.  A device may fill several
slots (``["cuda:0"] * 4``, or ``["cpu"] * 8`` in the tests), as JAX's
virtual CPU devices do.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


class Mesh:
    """``devices``: object array of torch.device, one axis per name in
    ``axis_names``; ``shape`` maps each name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The slots along `axis`, every other axis at index 0.  A JAX
        ``PartitionSpec(axis)`` shards over `axis` and replicates over the
        others; the port computes each shard once, on these slots."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return list(self.devices[tuple(idx)])


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """Mesh over `devices` (default: every visible CUDA device; raises
    without CUDA).  axis_sizes: e.g. {"gop": 2, "band": 4}; defaults to
    1-D ("gop", N).  Takes the first prod(sizes) devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 8) to build a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = {"gop": len(devs)}
    shape = tuple(axis_sizes.values())
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [_indexed(d) for d in devs[:n]]
    return Mesh(arr.reshape(shape), tuple(axis_sizes.keys()))


def _indexed(dev: torch.device) -> torch.device:
    """cuda -> cuda:<current>, so slots on one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def slot_streams(devices) -> list:
    """One CUDA stream per slot (None for a CPU slot)."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in devices]


def fork_streams(devices, streams) -> None:
    """Each slot stream waits for the work already on its device's
    current stream."""
    for d, st in zip(devices, streams):
        if st is not None:
            st.wait_stream(torch.cuda.current_stream(d))


def join_streams(devices, streams) -> None:
    """Each device's current stream waits for the slot streams on it, so
    that the caller's later work and events follow all slots' work."""
    for d, st in zip(devices, streams):
        if st is not None:
            torch.cuda.current_stream(d).wait_stream(st)


def on_stream(stream):
    """Context that makes `stream` current (nothing for a CPU slot)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())
