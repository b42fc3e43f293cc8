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
returns clones of the static outputs: the next replay overwrites those
buffers, so a result that must live on (a reference picture, a frame
handed to the caller) is never one of them.

On CUDA the first call of a step runs the function once eagerly on the
static inputs on a side stream (warm-up: lazy host-to-device copies of
index tables, the kernels' build at first use, the allocator's caches),
then captures it.  The steps of one cache capture into one memory pool:
their replays never overlap, because a cache lets one holder at a time
load, replay and clone, and orders each holder's stream after the last
holder's clones.  On the CPU the same object keeps the same static
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
allocator keeps it until the capture ends.  Such a step needs all its
slots on one device: its graph captures one device's work, and draws on
that device's pool.

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


class Step:
    """One static key's device step: ``fn(*inputs) -> tuple of tensors``
    over static inputs shaped like `like` (see ``_static_like``), captured
    into the memory pool `pool` on CUDA."""

    def __init__(self, key, fn, like, device, pool=None):
        self.key = key
        self.fn = fn
        self.device = device
        self.pool = pool
        self.inputs = [_static_like(x, device) for x in like]
        self.outputs = None
        self.graph = None
        self.replays = 0
        self.capture_ms = 0.0

    def load(self, *xs):
        """Copy this call's inputs into the static inputs (enqueued on
        the current stream; a pinned host source copies asynchronously)."""
        if len(xs) != len(self.inputs):
            raise TypeError(f"step takes {len(self.inputs)} inputs")
        for s, x in zip(self.inputs, xs):
            if isinstance(x, (list, tuple)):
                for i, t in enumerate(x):
                    s[i].copy_(t, non_blocking=True)
            else:
                s.copy_(x, non_blocking=True)

    def __call__(self):
        """Run the step on the loaded inputs; returns clones of its
        outputs."""
        if self.device.type != "cuda":
            out = self.fn(*self.inputs)
            if self.outputs is None:
                self.outputs = tuple(torch.empty_like(o) for o in out)
            for s, o in zip(self.outputs, out):
                s.copy_(o)
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in self.outputs)

    def _capture(self):
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = tuple(self.fn(*self.inputs))
        self.graph, self.outputs = graph, outputs
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def release(self):
        """Drop the graph and the buffers: their memory goes back to the
        pool and the allocator."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = None
        self.inputs = []


class StepCache:
    """Steps by key, as ``_FN_CACHE`` holds jitted functions by key, at
    most `max_keys` of them: a new key past that releases the least
    recently used step.

    A key names everything the captured work depends on besides its
    inputs' values: geometry, the device, the Python constants the
    function branches on, the shapes of its inputs."""

    def __init__(self, max_keys=16):
        self.max_keys = max_keys
        self.steps: OrderedDict = OrderedDict()
        self.made = 0
        self.lock = threading.Lock()
        self.pools = {}          # device -> the graph pool of its steps
        self._done = {}          # device -> event after the last clones

    @contextlib.contextmanager
    def hold(self, key, make_fn, like, device):
        """The step of `key`, made by ``make_fn()`` at its first use, held
        by this thread for a ``load`` and a call: other threads wait, and
        on CUDA the current stream first waits for the last holder's
        clones, so no two replays or loads of the cache's steps
        overlap."""
        with self.lock:
            s = self.steps.pop(key, None)
            if s is None:
                pool = None
                if device.type == "cuda":
                    if device not in self.pools:
                        self.pools[device] = torch.cuda.graph_pool_handle()
                    pool = self.pools[device]
                s = Step(key, make_fn(), like, device, pool)
                self.made += 1
            self.steps[key] = s
            while len(self.steps) > self.max_keys:
                self.steps.popitem(last=False)[1].release()
            if device.type != "cuda":
                yield s
                return
            stream = torch.cuda.current_stream(device)
            done = self._done.get(device)
            if done is not None:
                stream.wait_event(done)
            try:
                yield s
            finally:
                if done is None:
                    done = self._done[device] = torch.cuda.Event()
                done.record(stream)

    def stats(self) -> dict:
        """Keys held, steps made, captured graphs, capture ms summed over
        the steps held, and their replays."""
        s = self.steps.values()
        return {"keys": len(s), "made": self.made,
                "captured": sum(x.graph is not None for x in s),
                "capture_ms": round(sum(x.capture_ms for x in s), 3),
                "replays": sum(x.replays for x in s)}
