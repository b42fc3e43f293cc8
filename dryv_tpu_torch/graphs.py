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
``torch.cuda.device`` of it.  An edge between two parts' graphs is a raw
peer copy captured on the sending device into a static buffer of the
receiving one, then an external event (``torch.cuda.Event(external=
True)``) recorded in the sender's graph and waited on in the receiver's;
the parts warm up, capture and replay in order, so such an edge runs
from a part to a later one.  What a part needs from an earlier or a later
part's static inputs is copied outside the graphs before the replays
(``Split.before``); the parts' outputs meet on one device after them
(``Split.after``).

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


def _static_like(x, device):
    """A static input for `x`: a tensor, or a sequence of equal tensors,
    which its static input holds stacked along a new leading axis."""
    if isinstance(x, (list, tuple)):
        return torch.empty((len(x), *x[0].shape), dtype=x[0].dtype,
                           device=device)
    return torch.empty(x.shape, dtype=x.dtype, device=device)


class Split:
    """A step's function cut into parts, and callable as that function:
    ``parts`` is a list of (device, n, fn), fn taking the step's next n
    inputs (on `device`) and returning a tuple of tensors there.  ``after(outs)``, given each
    part's outputs in order, returns the step's results as new tensors
    (None: the one part's outputs, cloned on a replay); ``before(inputs)``
    runs after the static inputs are loaded and before the parts, outside
    any graph."""

    def __init__(self, parts, after=None, before=None):
        self.parts, self.after, self.before = parts, after, before

    def __call__(self, *ins):
        """The split function run op by op on inputs `ins` already on the
        parts' devices: ``before``, each part in order, ``after``."""
        if self.before is not None:
            self.before(ins)
        outs, i = [], 0
        for _, n, fn in self.parts:
            outs.append(tuple(fn(*ins[i:i + n])))
            i += n
        return outs[0] if self.after is None else self.after(outs)


class Step:
    """One static key's device step: ``fn(*inputs) -> tuple of tensors``
    over static inputs shaped like `like` (see ``_static_like``) on
    `device`, or a ``Split`` whose parts each hold their own share of
    them; on CUDA each part is captured into the graph pool of its device
    (``pool_of(device)``)."""

    def __init__(self, key, fn, like, device=None, pool_of=None):
        self.key = key
        self.split = fn if isinstance(fn, Split) else Split(
            [(device, len(like), fn)])
        devs = [d for d, n, _ in self.split.parts for _ in range(n)]
        if len(devs) != len(like):
            raise TypeError(f"step parts take {len(devs)} inputs, "
                            f"{len(like)} given")
        self.devices = list(dict.fromkeys(d for d, _, _ in
                                          self.split.parts))
        self.pool_of = pool_of or (lambda d: None)
        self.inputs = [_static_like(x, d) for x, d in zip(like, devs)]
        self.part_outputs = None   # each part's static outputs
        self.graphs = None         # one per part
        self.replays = 0
        self.capture_ms = 0.0

    def load(self, *xs):
        """Copy this call's inputs into the static inputs (enqueued on
        the current stream of each one's device; a pinned host source
        copies asynchronously)."""
        if len(xs) != len(self.inputs):
            raise TypeError(f"step takes {len(self.inputs)} inputs")
        for s, x in zip(self.inputs, xs):
            if isinstance(x, (list, tuple)):
                for i, t in enumerate(x):
                    s[i].copy_(t, non_blocking=True)
            else:
                s.copy_(x, non_blocking=True)

    def _parts(self):
        """(device, fn, its static inputs) of each part, in order."""
        i = 0
        for d, n, fn in self.split.parts:
            yield d, fn, self.inputs[i:i + n]
            i += n

    @property
    def outputs(self):
        """Every part's static outputs, in order (None before the first
        call)."""
        if self.part_outputs is None:
            return None
        return tuple(o for out in self.part_outputs for o in out)

    def __call__(self, out=None):
        """Run the step on the loaded inputs; returns ``after`` of the
        parts' outputs, or copies of the one part's outputs: in `out` (a
        tensor for each, enqueued on the current stream) when given, else
        in clones."""
        if self.split.before is not None:
            self.split.before(self.inputs)
        if self.devices[0].type != "cuda":
            outs = [tuple(fn(*xs)) for _, fn, xs in self._parts()]
            if self.part_outputs is None:
                self.part_outputs = [tuple(torch.empty_like(o) for o in out)
                                     for out in outs]
            for s, o in zip(self.outputs, (o for out in outs for o in out)):
                s.copy_(o)
        else:
            if self.graphs is None:
                self._capture()
            for (d, _, _), g in zip(self.split.parts, self.graphs):
                with torch.cuda.device(d):
                    g.replay()
        self.replays += 1
        if self.split.after is not None:
            return self.split.after(self.part_outputs)
        if out is None:
            return tuple(o.clone() for o in self.outputs)
        for d, o in zip(out, self.outputs):
            d.copy_(o, non_blocking=True)
        return tuple(out)

    def _capture(self):
        """Warm every part up on a side stream of its device, in order
        (the cross-part edges see the same order as in a replay), then
        capture each on its device's capture stream into its pool."""
        t0 = time.perf_counter()
        parts = list(self._parts())
        for d, fn, xs in parts:
            with torch.cuda.device(d):
                cur = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    fn(*xs)
                cur.wait_stream(side)
        graphs, outs = [], []
        for d, fn, xs in parts:
            with torch.cuda.device(d):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool_of(d),
                                      stream=_capture_stream(d)):
                    outs.append(tuple(fn(*xs)))
            graphs.append(graph)
        self.graphs, self.part_outputs = graphs, outs
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def release(self):
        """Drop the graphs and the buffers: their memory goes back to the
        pools and the allocator."""
        for g in self.graphs or ():
            g.reset()
        self.graphs = self.part_outputs = None
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
