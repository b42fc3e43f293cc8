"""Device steps captured once per static key and replayed: the port's
counterpart of the JAX package's per-key ``jax.jit`` caches
(``_FN_CACHE`` / ``_make_pic_fn`` in ``dryv_tpu/device_ipb_packed.py``,
``_PACKED_FN_CACHE`` / ``make_packed_gop_fn`` in
``dryv_tpu/gop_pipeline.py``, the jitted ``_build`` recon of
``dryv_tpu/pipeline.py``).

Eager PyTorch enqueues every op of a device step from the host, several
hundred small launches for one picture; a ``torch.cuda.CUDAGraph``
enqueues the whole step as one launch.  A ``Step`` is one static key's
function with its static input tensors, its captured graph and its
static outputs.  A caller holds the step (``StepCache.hold``), fills its
static inputs (``load``), then calls it, which replays the graph and
returns clones of the static outputs, or copies them into tensors the
caller gives (the batched pipeline's slices of one allocation for a
whole decode, so that a call takes no memory from the allocator): the
next replay overwrites those buffers, so a result that must live on (a
reference picture, a frame handed to the caller) is never one of them.

On CUDA the first call of a step runs the function once eagerly on the
static inputs on a side stream (warm-up: lazy host-to-device copies of
index tables, the kernels' build at first use, the allocator's caches),
then captures it.  The steps of one cache capture into one memory pool:
their replays never overlap, because a cache lets one holder at a time
load, replay and copy out, and orders each holder's stream after the
last holder's copies.  On the CPU the same object keeps the same static
buffers, and a call runs the function eagerly on them and copies the
results into the static outputs, so that the tests reach the key
choice, the input copies and the output clones without a card.

A step's function may fork other streams of its device, as the sharded
paths do (``parallel.mesh.STEPS``: one stream per mesh slot).  Each
slot stream first waits on the current stream (``fork_streams``), which
inside ``torch.cuda.graph`` is the capture stream, so its work joins the
capture; halo and apron copies between slots are ordered by events
recorded on one slot stream and waited on by another, which become the
graph's edges; and before the function returns, the current stream waits
on every slot stream (``join_streams``), so no stream is left outside
the capture when it ends (an unjoined stream fails the capture with
``cudaErrorStreamCaptureUnjoined``).  The warm-up runs the same function
on the side stream, so it makes the same forks and joins from there.
Blocks freed during the capture on the stream that allocated them are
reused by later allocations on that stream inside the graph; a block
read on another stream is marked with ``record_stream`` first, and the
allocator keeps it until the capture ends.

A graph captures one device's work and draws on that device's pool, so a
step over several devices is a ``Split``: one part per group of slots,
each with its own static inputs, captured as a graph of its own on its
device (that device's pool and capture stream) and replayed under
``torch.cuda.device`` of it.  Every exchange between parts runs inside
their graphs, as the JAX package's ``ppermute``s run inside its one
jitted ``shard_map`` program, by raw peer copies (``peer_copy``): an
edge from a part to a later one (a band's halo) is a copy captured on
the sending device into a static buffer of the receiving one, then an
external event (``torch.cuda.Event(external=True)``) recorded in the
sender's graph and waited on in the receiver's; what a part reads of
other parts' static inputs (``Split.reads``: banded P recon's ghost
bands) it pulls on its own capture stream; and each part copies its
outputs into its slices of the step's planes on the first device, which
the step allocates once, and then records an external event.  A call
replays the parts in their order; outside the graphs the host adds only
the loads, event records and the waits no graph can hold: a part's
replay after the loads of the inputs it reads, those inputs' next loads
after that replay, and the first device's copy of the results after the
parts on the other devices (``Step``).

The kernels' launch counters move only where a wrapper launches its
kernel: in eager runs, a step's warm-up, and the capture, which records
the launch into the graph.  A replay runs the recorded kernels on the
card without calling a wrapper, so it moves no counter; a graphed path's
kernel launches are read from a device trace.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

import torch

from . import _build


def _static_like(x, device):
    """A static input for `x`: a tensor, or a sequence of equal tensors,
    which its static input holds stacked along a new leading axis."""
    if isinstance(x, (list, tuple)):
        return torch.empty((len(x), *x[0].shape), dtype=x[0].dtype,
                           device=device)
    return torch.empty(x.shape, dtype=x.dtype, device=device)


class Split:
    """A step's function cut into parts, and callable as that function.

    ``parts`` is a list of (device, n, fn): fn takes the step's next n
    inputs (on `device`), then the step's inputs that ``reads[i]`` names
    by index (other parts' inputs, on their devices: the part copies
    what it needs of them itself), and returns a tuple of tensors on
    `device`.  One part's outputs are the step's planes; several parts
    each write theirs into their slices of the step's planes on the first
    part's device, stacked along `dim` in part order, by ``peer_copy``,
    which a capture on the part's device can hold.  The step's results
    are ``view(planes)``: views of them (default: the planes)."""

    def __init__(self, parts, dim=0, view=None, reads=None):
        self.parts, self.dim = parts, dim
        self.view = view or tuple
        self.reads = reads or [()] * len(parts)

    def run(self, i, ins):
        """Part i's outputs on the step's inputs `ins` (every part's)."""
        lo = sum(n for _, n, _ in self.parts[:i])
        _, n, fn = self.parts[i]
        return tuple(fn(*ins[lo:lo + n], *(ins[j] for j in self.reads[i])))

    def planes_for(self, outs):
        """The step's planes for the parts' outputs `outs`, new on the
        first part's device, and each part's slices of them."""
        planes, slices = [], [[] for _ in outs]
        for p, o in enumerate(outs[0]):
            sizes = [out[p].shape[self.dim] for out in outs]
            shape = list(o.shape)
            shape[self.dim] = sum(sizes)
            plane = torch.empty(shape, dtype=o.dtype,
                                device=self.parts[0][0])
            off = 0
            for sl, n in zip(slices, sizes):
                sl.append(plane.narrow(self.dim, off, n))
                off += n
            planes.append(plane)
        return tuple(planes), slices

    def put(self, outs, slices):
        """A part's outputs into its `slices` of the planes."""
        for dst, src in zip(slices, outs):
            peer_copy(dst, src)

    def gather(self, outs, slices):
        """Every part's outputs `outs` into its `slices` of the planes,
        op by op: the first part's device waits for each part's copy."""
        for (d, _, _), out, sl in zip(self.parts, outs, slices):
            self.put(out, sl)
            _wait_for(self.parts[0][0], {d})

    def __call__(self, *ins):
        """The split function run op by op on inputs `ins` already on the
        parts' devices: each part after the devices whose inputs it reads,
        then their outputs gathered into new planes on the first part's
        device."""
        for i, (d, _, _) in enumerate(self.parts):
            _wait_for(d, {ins[j].device for j in self.reads[i]})
        outs = [self.run(i, ins) for i in range(len(self.parts))]
        if len(outs) == 1:
            return self.view(outs[0])
        planes, slices = self.planes_for(outs)
        self.gather(outs, slices)
        return self.view(planes)


def peer_copy(dst: torch.Tensor, src: torch.Tensor, pull=False) -> None:
    """dst[...] = src, card to card on the current stream of src's card,
    or with `pull` of dst's (raw ``cudaMemcpy2DAsync``, C entry
    ``dt_peer_copy``: it waits for no stream of the other card, so a
    capture on the stream's card can hold it; the caller orders the other
    card by an event); on the CPU a plain copy.  Each tensor must be
    contiguous, or contiguous past its leading axis (its rows lie apart:
    a band's rows of every frame of a plane stack)."""
    if src.device.type != "cuda":
        dst.copy_(src)
        return
    if dst.dtype != src.dtype or dst.shape != src.shape:
        raise ValueError(f"peer_copy: {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    es = src.element_size()
    if src.is_contiguous() and dst.is_contiguous():
        width = src.numel() * es
        height, sp, dp = 1, width, width
    elif src.dim() > 1 and src[0].is_contiguous() and dst[0].is_contiguous():
        width, height = src[0].numel() * es, src.shape[0]
        sp, dp = src.stride(0) * es, dst.stride(0) * es
    else:
        raise ValueError("peer_copy: rows past the leading axis must be "
                         "contiguous")
    _build.call("dt_peer_copy", src, dst, width, height, sp, dp,
                device=dst.device if pull else src.device)


def _wait_for(device, sources):
    """The current stream of `device` waits for the work already enqueued
    on the current stream of each CUDA device in `sources`."""
    for s in sources:
        if s != device and s.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(s))
            torch.cuda.current_stream(device).wait_event(ev)


class Step:
    """One static key's device step: ``fn(*inputs) -> tuple of tensors``
    over static inputs shaped like `like` (see ``_static_like``) on
    `device`, or a ``Split`` whose parts each hold their own share of
    them; on CUDA each part is captured into the graph pool of its device
    (``pool_of(device)``).  ``outputs`` are its static planes (a split's:
    allocated once on its first device, outside the pools).

    Over several devices each part's graph ends by recording an external
    event (``done``), and the order between cards is kept by event waits:
    a part on another device waits in its graph for the first device's
    copy of the last call's results (``taken``) before it writes the
    planes again; the first device's stream waits for the parts on the
    other devices (``others``) before the results' copy; a load waits
    for the replays that read its inputs, and a part that reads them
    waits for the load."""

    def __init__(self, key, fn, like, device=None, pool_of=None):
        self.key = key
        self.split = fn if isinstance(fn, Split) else Split(
            [(device, len(like), fn)])
        parts = self.split.parts
        devs = [d for d, n, _ in parts for _ in range(n)]
        if len(devs) != len(like):
            raise TypeError(f"step takes {len(devs)} inputs, "
                            f"{len(like)} given")
        self.devices = list(dict.fromkeys(d for d, _, _ in parts))
        self.pool_of = pool_of or (lambda d: None)
        self.inputs = [_static_like(x, d) for x, d in zip(like, devs)]
        first = self.devices[0]
        self.others = [i for i, (d, _, _) in enumerate(parts) if d != first]
        # the devices each part reads (besides its own), and each
        # device's readers
        self.reads = [{devs[j] for j in r} - {d} for (d, _, _), r in
                      zip(parts, self.split.reads)]
        self.readers = {s: [i for i, r in enumerate(self.reads) if s in r]
                        for s in set().union(*self.reads)}
        self.outputs = None        # the static planes (None before a call)
        self.slices = None         # each part's slices of them
        self.graphs = None         # one per part
        self.done = None           # per part: the event its graph ends on
        self.loaded = self.taken = None
        if first.type == "cuda" and len(self.devices) > 1:
            self.loaded = {s: torch.cuda.Event() for s in self.readers}
            self.taken = torch.cuda.Event(external=True)
        self.replays = 0
        self.capture_ms = 0.0

    def load(self, *xs):
        """Copy this call's inputs into the static inputs (enqueued on
        the current stream of each one's device; a pinned host source
        copies asynchronously), each device's after the last replays
        that read them; a part that reads another device's inputs then
        waits for their copies."""
        if len(xs) != len(self.inputs):
            raise TypeError(f"step takes {len(self.inputs)} inputs")
        cur = torch.cuda.current_stream
        if self.loaded is not None and self.done is not None:
            for s, parts in self.readers.items():
                for i in parts:
                    cur(s).wait_event(self.done[i])
        for s, x in zip(self.inputs, xs):
            if isinstance(x, (list, tuple)):
                for i, t in enumerate(x):
                    s[i].copy_(t, non_blocking=True)
            else:
                s.copy_(x, non_blocking=True)
        if self.loaded:
            for s, ev in self.loaded.items():
                ev.record(cur(s))
            for (d, _, _), r in zip(self.split.parts, self.reads):
                for s in r:
                    cur(d).wait_event(self.loaded[s])

    def __call__(self, out=None):
        """Run the step on the loaded inputs; returns copies of its
        results (``view`` of its planes): in `out` (a tensor for each,
        enqueued on the current stream) when given, else in clones.  On
        CUDA: the replays, in part order, and the waits for ``others``."""
        split, first = self.split, self.devices[0]
        if first.type != "cuda":
            outs = [split.run(i, self.inputs)
                    for i in range(len(split.parts))]
            if self.outputs is None:
                self.outputs, self.slices = split.planes_for(outs)
            split.gather(outs, self.slices)
        else:
            if self.graphs is None:
                self._capture()
            for (d, _, _), graph in zip(split.parts, self.graphs):
                with torch.cuda.device(d):
                    graph.replay()
            for i in self.others:
                torch.cuda.current_stream(first).wait_event(self.done[i])
        self.replays += 1
        res = split.view(self.outputs)
        if out is None:
            res = tuple(o.clone() for o in res)
        else:
            for d, o in zip(out, res):
                d.copy_(o, non_blocking=True)
            res = tuple(out)
        if self.taken is not None:
            self.taken.record(torch.cuda.current_stream(first))
        return res

    def _capture(self):
        """Warm every part up on a side stream of its device, in order
        (the cross-part edges see the same order as in a replay), then,
        for several parts, allocate the planes on the first device, and
        capture each part on its device's capture stream into its pool:
        its function, then (several parts) the wait for the last call's
        results' copy, the copy of its outputs into its slices, and its
        external event."""
        t0 = time.perf_counter()
        split, first = self.split, self.devices[0]
        n = len(split.parts)
        warm = []
        for d, _, _ in split.parts:
            with torch.cuda.device(d):
                cur = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    warm.append(split.run(len(warm), self.inputs))
                cur.wait_stream(side)
        if n > 1:
            with torch.cuda.device(first):
                self.outputs, self.slices = split.planes_for(warm)
        del warm
        if self.taken is not None:
            # a wait captured on an event never recorded is no wait
            self.taken.record(torch.cuda.current_stream(first))
        graphs, done = [], []
        for i, (d, _, _) in enumerate(split.parts):
            with torch.cuda.device(d):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool_of(d),
                                      stream=_capture_stream(d)):
                    cur = torch.cuda.current_stream()
                    outs = split.run(i, self.inputs)
                    if n > 1:
                        if d != first and self.taken is not None:
                            cur.wait_event(self.taken)
                        split.put(outs, self.slices[i])
                        done.append(torch.cuda.Event(external=True))
                        done[i].record(cur)
            graphs.append(graph)
        if n == 1:
            self.outputs = outs
        self.graphs, self.done = graphs, done
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def release(self):
        """Drop the graphs and the buffers: their memory goes back to the
        pools and the allocator."""
        for g in self.graphs or ():
            g.reset()
        self.graphs = self.outputs = self.slices = self.done = None
        self.inputs = []


_CAPTURE_STREAMS = {}    # device -> the stream every capture there uses


def _capture_stream(device):
    """One capture stream per device: ``torch.cuda.graph``'s own default
    is one stream for the process, on the device current when it was
    made, and captures that share a pool should share a stream."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _CAPTURE_STREAMS[device]


class StepCache:
    """Steps by key, as ``_FN_CACHE`` holds jitted functions by key, at
    most `max_keys` of them: a new key past that releases the least
    recently used step.

    A key names everything the captured work depends on besides its
    inputs' values: geometry, the devices, the Python constants the
    function branches on, the shapes of its inputs."""

    def __init__(self, max_keys=16):
        self.max_keys = max_keys
        self.steps: OrderedDict = OrderedDict()
        self.made = 0
        self.lock = threading.Lock()
        self.pools = {}          # device -> the graph pool of its steps
        self._done = []          # events after the last holder's work

    def _pool(self, device):
        if device not in self.pools:
            with torch.cuda.device(device):
                self.pools[device] = torch.cuda.graph_pool_handle()
        return self.pools[device]

    @contextlib.contextmanager
    def hold(self, key, make_fn, like, device=None):
        """The step of `key`, made by ``make_fn()`` (a function on
        `device`, or a ``Split``) at its first use, held by this thread
        for a ``load`` and a call: other threads wait, and on CUDA the
        current stream of each of the step's devices first waits for the
        last holder's work on every device it used, so no two replays or
        loads of the cache's steps overlap.  One hold covers every part
        of a step; a thread must not hold two steps of one cache at
        once (the lock is not reentrant)."""
        with self.lock:
            s = self.steps.pop(key, None)
            if s is None:
                s = Step(key, make_fn(), like, device, self._pool)
                self.made += 1
            self.steps[key] = s
            while len(self.steps) > self.max_keys:
                self.steps.popitem(last=False)[1].release()
            cuda = [d for d in s.devices if d.type == "cuda"]
            if not cuda:
                yield s
                return
            for d in cuda:
                for ev in self._done:
                    torch.cuda.current_stream(d).wait_event(ev)
            try:
                yield s
            finally:
                self._done = []
                for d in cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(d))
                    self._done.append(ev)

    def pool_mib(self) -> dict:
        """MiB of card memory in each device's graph pool (the segments
        of ``torch.cuda.memory_snapshot`` in it), by device name."""
        if not self.pools:
            return {}
        dev_of = {tuple(p): str(d) for d, p in self.pools.items()}
        out = dict.fromkeys(dev_of.values(), 0.0)
        for sg in torch.cuda.memory_snapshot():
            d = dev_of.get(tuple(sg.get("segment_pool_id", ())))
            if d is not None:
                out[d] += sg["total_size"] / 2**20
        return out

    def stats(self) -> dict:
        """Keys held, steps made, steps captured and the graphs they hold
        (one per part), capture ms summed over the steps held, their
        replays, and the MiB of each device's graph pool."""
        s = self.steps.values()
        return {"keys": len(s), "made": self.made,
                "captured": sum(x.graphs is not None for x in s),
                "graphs": sum(len(x.graphs or ()) for x in s),
                "capture_ms": round(sum(x.capture_ms for x in s), 3),
                "replays": sum(x.replays for x in s),
                "pool_mib": self.pool_mib()}
