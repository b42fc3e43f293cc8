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
as a graph of its own on its device; the copies between groups go card
to card (``peer_copy``), inside the sending group's graph or between the
replays.  One device gives one group and one graph.  ``graph=False``
runs the same parts op by op (``run_eager``), counted in
``STEPS.eager``.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import _build
from ..graphs import Split, StepCache


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


def peer_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[...] = src, card to card on the current stream of src's card
    (raw ``cudaMemcpyAsync``, C entry ``dt_peer_copy``: it waits for no
    stream of dst's card, so a capture on src's card can hold it; the
    caller orders dst's readers by an event); on the CPU a plain copy."""
    if src.device.type != "cuda":
        dst.copy_(src)
        return
    if dst.dtype != src.dtype or dst.shape != src.shape:
        raise ValueError(f"peer_copy: {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("peer_copy: tensors must be contiguous")
    _build.call("dt_peer_copy", src, dst, src.numel() * src.element_size())


def order_after(src_devices, dst_devices) -> None:
    """The current stream of each of `dst_devices` waits for the work
    already enqueued on the current stream of each of `src_devices`
    (CUDA; nothing on the CPU)."""
    for s in src_devices:
        if s.type != "cuda":
            continue
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(s))
        for d in dst_devices:
            if d != s:
                torch.cuda.current_stream(d).wait_event(ev)


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
