"""Device mesh of the port: a named grid of ``torch.device``s.

Counterpart of ``dryv_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one process drives a ``jax.sharding.Mesh`` through
``shard_map``.  The port keeps that design: one process holds the grid,
puts each shard's tensors on its slot's device and runs the slot's work
on a CUDA stream of its own, so slots overlap on one card and on several
the copies between them go peer to peer.  A device may fill several
slots (``["cuda:0"] * 4``, or ``["cpu"] * 8`` in the tests), as JAX's
virtual CPU devices do.

The JAX package compiles each sharded path once per static shape, a
``jax.jit`` of a ``shard_map``.  The port's counterpart is ``STEPS``: a
sharded path's device work, every slot's stream with its forks, joins
and halo copies, captured as one CUDA graph per static key and replayed
(``graphs.Step``).  A graph captures one device's work, so a mesh whose
slots span several devices runs op by op; ``STEPS.eager`` counts those
calls, and the calls made with ``graph=False``.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..graphs import StepCache


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

    def one_device(self, axis: str):
        """The device of every slot along `axis`, or None when the slots
        span several devices (their work cannot be one CUDA graph)."""
        devs = set(self.axis_devices(axis))
        return devs.pop() if len(devs) == 1 else None


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


_LOCAL = threading.local()    # .streams: (device, slot index) -> stream


def slot_streams(devices) -> list:
    """One CUDA stream per slot (None for a CPU slot), the same stream
    for slot i on a device in every call of a thread: the caching
    allocator keeps freed blocks per stream, so an op-by-op call on fresh
    streams would allocate its intermediates anew from the driver.  Per
    thread, so that no other thread's work lands on a stream that is
    being captured."""
    memo = getattr(_LOCAL, "streams", None)
    if memo is None:
        memo = _LOCAL.streams = {}
    out = []
    for i, d in enumerate(devices):
        if d.type == "cuda" and (d, i) not in memo:
            memo[d, i] = torch.cuda.Stream(device=d)
        out.append(memo.get((d, i)))
    return out


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


class MeshSteps(StepCache):
    """The sharded paths' steps, keyed by (slot devices, axis, geometry,
    ...); ``eager`` counts the calls that ran op by op instead."""

    def __init__(self, max_keys):
        super().__init__(max_keys)
        self.eager = 0

    def stats(self) -> dict:
        return {**super().stats(), "eager": self.eager}


STEPS = MeshSteps(max_keys=8)


def run_step(key, make_fn, xs, device):
    """Replay the step of `key` in ``STEPS`` (made by ``make_fn()`` at
    its first use) on inputs `xs` (host or device tensors); returns the
    clones of its outputs."""
    with STEPS.hold(key, make_fn, xs, device) as step:
        step.load(*xs)
        return step()


def run_eager(fn, xs, devices):
    """The op-by-op route of a step's function: counts the call in
    ``STEPS.eager``, copies each slot's equal share of the host inputs
    `xs` (slot order, as ``run_step`` takes them) to its device, on that
    device's current stream, from which ``fn``'s slot streams fork, and
    returns fn(*copies)."""
    with STEPS.lock:
        STEPS.eager += 1
    k = len(xs) // len(devices)
    return fn(*(x.to(devices[i // k]) for i, x in enumerate(xs)))
