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
and halo copies, captured per static key and replayed (``graphs.Step``).
A graph captures one device's work, so a path cuts a mesh axis's slots
into groups (``slot_groups``: runs of consecutive slots on one device)
and its step into one part per group (``graphs.Split``), each captured
as a graph of its own on its device.  Every copy between groups runs
inside a group's graph, card to card (``graphs.peer_copy``): a halo
pushed by the sending group, a ghost band pulled by the receiving one, a
group's planes into the step's planes on the first card; a call enqueues
the replays, one a card in part order, and the event waits that order
them.  One device
gives one group and one graph.  ``graph=False`` runs the same parts op by
op (``run_eager``), counted in ``STEPS.eager``.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import _build
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


def _slot_group(i: int, dev: torch.device):
    """The group of slot i on `dev`; neighbouring slots of one group
    share a part of a step and its graph.  By device: the private seam
    through which the tests and chip_smoke.py cut one device's slots into
    several groups."""
    return dev


def slot_groups(devices) -> list:
    """The slots of a mesh axis as ranges of consecutive slots in one
    group (``_slot_group``) and so on one device; a device that comes back
    after another starts a new group, so an edge between neighbouring
    slots runs from a group to the next."""
    keys = [_slot_group(i, d) for i, d in enumerate(devices)]
    starts = [i for i in range(len(keys)) if i == 0 or keys[i] != keys[i - 1]]
    return [range(a, b) for a, b in zip(starts, starts[1:] + [len(keys)])]


def step_key(key, groups) -> tuple:
    """`key` of a path's step, with its slot groups when it has several
    (the grouping decides the step's parts)."""
    if len(groups) == 1:
        return key
    return key + (tuple((g.start, g.stop) for g in groups),)


_PEERS = set()    # (device, peer) pairs whose direct access is on


def enable_peers(devices) -> None:
    """Direct access between every ordered pair of the CUDA `devices`
    that supports it (once a pair per process), before a capture copies
    between them; a pair without it copies through the host, which a
    capture may refuse (it then raises)."""
    idx = sorted({d.index for d in devices if d.type == "cuda"})
    for a in idx:
        for b in idx:
            if a != b and (a, b) not in _PEERS and \
                    torch.cuda.can_device_access_peer(a, b):
                _build.enable_peer_access(a, b)
                _PEERS.add((a, b))


def cat(ts, dim=0):
    """``torch.cat`` of a group's slot tensors `ts`, or the one tensor
    itself."""
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim)


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


def run_step(key, make, xs):
    """Replay the step of `key` in ``STEPS`` (``make()``, a ``Split``, at
    its first use) on inputs `xs` (host or device tensors, in the parts'
    order); returns its results."""
    with STEPS.hold(key, make, xs) as step:
        step.load(*xs)
        return step()


def run_eager(split, xs):
    """The op-by-op route of a step (``graph=False``): counts the call in
    ``STEPS.eager``, copies the host inputs `xs` to their parts' devices
    (on each device's current stream, from which the parts' slot streams
    fork) and runs the split there."""
    with STEPS.lock:
        STEPS.eager += 1
    devs = [d for d, n, _ in split.parts for _ in range(n)]
    return split(*(x.to(d) for x, d in zip(xs, devs)))
