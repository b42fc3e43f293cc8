"""The sharded paths' per-group route on the CPU: a mesh axis's slots cut
into groups, each a part of the step with its own static inputs (on CUDA
a graph of its own per card), through the private seam
``parallel.mesh._slot_group``, which the tests set so that every `size`
neighbouring slots of one CPU device form a group, as the slots of one
card do on a mesh of several.  Every exchange runs inside the parts: the
halos between groups go through the receiving group's static buffers
(``peer_copy``), banded P recon's groups pull their ghost bands from the
other groups' static inputs, and each group writes its planes into the
step's planes on the first slot's device; a call copies nothing between
devices outside them.  Each path's per-group route equals its one-group
route, ``graph=False``, the JAX function (8 virtual CPU devices, Pallas
in interpret mode) and the golden, or for P recon B4's plain version on
the whole plane, with tolerance 0 (the paths are integer)."""
import collections
import contextlib
import threading
from functools import lru_cache

import numpy as np
import pytest
import torch

from dryv_tpu_torch import graphs
from dryv_tpu_torch import parallel as tpar
from dryv_tpu_torch.native.full import decode_annexb_native
from dryv_tpu_torch.parallel import bands as tbands
from dryv_tpu_torch.parallel import mesh as tmesh
from dryv_tpu_torch.pipeline import frames_from_stream

from test_torch_parallel import (CPU8, _assert_planes, _fixture,
                                 _p_picture, _unbanded_p)


@pytest.fixture
def steps(monkeypatch):
    """A fresh step cache for the sharded paths."""
    s = tmesh.MeshSteps(max_keys=8)
    monkeypatch.setattr(tmesh, "STEPS", s)
    return s


def _cut(monkeypatch, size):
    """Every `size` neighbouring slots form a group from now on."""
    monkeypatch.setattr(tmesh, "_slot_group", lambda i, d: (d, i // size))


def _routes(monkeypatch, size, call):
    """call(graph) on the one-group route (graphed), then with the slots
    cut in groups of `size`: (one group, per group graphed, per group
    with graph=False)."""
    one = call(True)
    _cut(monkeypatch, size)
    return one, call(True), call(False)


def _split_step(steps):
    """The one step of the cache made with several parts."""
    (step,) = [s for s in steps.steps.values() if len(s.split.parts) > 1]
    return step


@lru_cache(maxsize=None)
def _jax_gop(gop, n):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.gop import decode_gop_sharded

    fs, _ = _fixture("mix_qp26")
    return decode_gop_sharded([fs] * n, make_mesh({"gop": gop}))


@lru_cache(maxsize=None)
def _jax_banded(name, n_bands, F, Fi):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_gop_pallas_fn

    fs, _ = _fixture(name)
    return make_banded_gop_pallas_fn(make_mesh({"band": n_bands}), fs.mb_w,
                                     fs.mb_h, F, Fi=Fi,
                                     interpret=True)([fs] * F)


@pytest.mark.parametrize("gop,size", [(2, 1), (4, 2), (4, 1)])
def test_gop_sharded_per_group(steps, monkeypatch, gop, size):
    """gop + 1 pictures padded to 2 a slot; the groups' planes meet on
    the first slot's device."""
    fs, golden = _fixture("mix_qp26")
    fl = [fs] * (gop + 1)
    mesh = tpar.make_mesh({"gop": gop}, CPU8)
    one, got, eager = _routes(monkeypatch, size, lambda g:
                              tpar.decode_gop_sharded(fl, mesh, graph=g))
    assert got[0].shape[0] == gop + 1 and got[0].dtype == np.uint8
    _assert_planes(got, one, eager, _jax_gop(gop, gop + 1), golden)
    step = _split_step(steps)
    assert len(step.split.parts) == gop // size
    assert step.key[-1] == tuple((i, i + size) for i in range(0, gop, size))
    assert steps.made == 2 and steps.stats()["eager"] == 1


@pytest.mark.parametrize("name,n_bands,Fi,size", [
    ("mix_qp26", 2, 2, 1), ("mix_qp26", 4, 1, 2), ("big_qp30", 4, 1, 1),
    ("big_qp30", 3, 1, 2)])
def test_banded_gop_per_group(steps, monkeypatch, name, n_bands, Fi, size):
    """Halos cross from group to group through the receiving group's
    static buffers, one per frame group; 3 bands in groups of 2 give
    groups of 2 and 1 bands."""
    fs, golden = _fixture(name)
    F = 2 * Fi
    mesh = tpar.make_mesh({"band": n_bands}, CPU8)
    runs = {}

    def call(graph):
        runs[graph] = tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, F,
                                              Fi=Fi, graph=graph)
        return runs[graph]([fs] * F)

    one, got, eager = _routes(monkeypatch, size, call)
    assert runs[True].graphed and not runs[False].graphed
    _assert_planes(got, one, eager, _jax_banded(name, n_bands, F, Fi),
                   golden)
    step = _split_step(steps)
    assert len(step.split.parts) == -(-n_bands // size)
    assert steps.stats()["eager"] == 1


@pytest.mark.parametrize("axes,size", [({"band": 2}, 1), ({"band": 4}, 1),
                                       ({"gop": 2, "band": 2}, 1)])
def test_banded_frame_per_group(steps, monkeypatch, axes, size):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_frame_fn

    fs, golden = _fixture("mix_qp26")
    mesh = tpar.make_mesh(axes, CPU8)
    one, got, eager = _routes(monkeypatch, size, lambda g:
                              tpar.make_banded_frame_fn(
                                  mesh, fs.mb_w, fs.mb_h, graph=g)(fs))
    ref = make_banded_frame_fn(make_mesh(axes), fs.mb_w, fs.mb_h)(fs)
    _assert_planes(got, one, eager, ref, golden)
    assert len(_split_step(steps).split.parts) == axes["band"]


@pytest.mark.parametrize("n_bands,size", [(2, 1), (4, 2), (4, 1)])
def test_banded_p_recon_per_group(steps, monkeypatch, n_bands, size):
    """Groups pull the bands their 64-row aprons reach as ghost bands
    inside their parts: with 4 bands of 32 rows, two on each side, so a
    group of one band reads a band two groups away."""
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_p_recon_fn

    mb_w, mb_h = 6, 8
    pic = _p_picture(mb_w, mb_h, 3)
    mesh = tpar.make_mesh({"band": n_bands}, CPU8)
    one, got, eager = _routes(monkeypatch, size, lambda g:
                              tpar.make_banded_p_recon_fn(
                                  mesh, mb_w, mb_h, apron=64,
                                  graph=g)(*pic))
    ref = make_banded_p_recon_fn(make_mesh({"band": n_bands}), mb_w, mb_h,
                                 apron=64)(*pic)
    _assert_planes(got, one, eager, ref, _unbanded_p(*pic, mb_w, mb_h))
    step = _split_step(steps)
    assert len(step.split.parts) == n_bands // size
    assert len(step.inputs) == 7 * n_bands
    m = -(-64 // (16 * (mb_h // n_bands)))   # ghost bands a side
    assert step.split.reads[0] == tuple(7 * b + p for b in range(
        size, min(n_bands, size + m)) for p in range(3))


def test_2d_mesh_per_group(steps, monkeypatch):
    """The JAX package's dry-run mesh, gop x band = 2 x 2: the GOP over
    the gop axis, the band pipeline and the banded frame over the band
    axis, each slot a group."""
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_frame_fn

    fs, golden = _fixture("mix_qp26")
    mesh = tpar.make_mesh({"gop": 2, "band": 2}, CPU8)

    def call(graph):
        return (tpar.decode_gop_sharded([fs] * 3, mesh, graph=graph),
                tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, 2, Fi=1,
                                        graph=graph)([fs] * 2),
                tpar.make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h,
                                          graph=graph)(fs))

    one, got, eager = _routes(monkeypatch, 1, call)
    jm = make_mesh({"gop": 2, "band": 2})
    refs = (_jax_gop(2, 3), _jax_banded("mix_qp26", 2, 2, 1),
            make_banded_frame_fn(jm, fs.mb_w, fs.mb_h)(fs))
    for i, ref in enumerate(refs):
        _assert_planes(got[i], one[i], eager[i], ref, golden)
    assert sum(len(s.split.parts) > 1 for s in steps.steps.values()) == 3
    assert steps.stats()["eager"] == 3


def test_one_key_several_groups_one_step_one_hold(steps, monkeypatch):
    """One key with four groups makes one step, held once a call (the
    cache's lock is not reentrant: a hold inside a hold would deadlock);
    two calls from a thread finish well inside a timeout and replay the
    step twice."""
    fs, golden = _fixture("mix_qp26")
    _cut(monkeypatch, 1)
    run = tpar.make_banded_gop_fn(tpar.make_mesh({"band": 4}, CPU8),
                                  fs.mb_w, fs.mb_h, 4, Fi=1)
    depth, most = [0], [0]
    hold = steps.hold

    def counted(*a, **k):
        depth[0] += 1
        most[0] = max(most[0], depth[0])
        try:
            with hold(*a, **k) as s:
                yield s
        finally:
            depth[0] -= 1

    monkeypatch.setattr(steps, "hold", contextlib.contextmanager(counted))
    out = []
    t = threading.Thread(target=lambda: out.extend(run([fs] * 4)
                                                   for _ in range(2)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "a call over several groups did not finish"
    for planes in out:
        _assert_planes(planes, golden)
    assert most[0] == 1 and steps.made == 1
    (step,) = steps.steps.values()
    assert len(step.split.parts) == 4 and step.replays == 2
    assert not steps.lock.locked()


@pytest.mark.parametrize("path,slots,size,Fi", [
    ("gop", 2, 1, 0), ("gop", 4, 1, 0), ("band", 2, 1, 2),
    ("band", 4, 1, 1), ("band", 4, 2, 1), ("p_recon", 4, 1, 0),
    ("p_recon", 4, 2, 0)])
def test_distinct_pictures_in_order_per_group(steps, monkeypatch, path,
                                              slots, size, Fi):
    """Five distinct pictures through each path's per-group route, graphed
    and eager, each frame held against the native decode of its own
    picture: a part that mixed up pictures, slots, frame groups or the
    halo buffers of frame groups would show here.  Banded P recon runs
    two distinct P pictures back to back through one step, A B A, every
    result held until the last call, each against B4's plain version on
    its whole plane: a ghost band pulled from the other picture's
    reference would show here."""
    _cut(monkeypatch, size)
    mesh = tpar.make_mesh({"gop" if path == "gop" else "band": slots}, CPU8)
    if path == "p_recon":
        pics = [_p_picture(6, 8, seed) for seed in (5, 6)]
        want = [_unbanded_p(*pic, 6, 8) for pic in pics]
        for g in (True, False):
            run = tpar.make_banded_p_recon_fn(mesh, 6, 8, apron=64, graph=g)
            got = [run(*pics[i], device_out=True) for i in (0, 1, 0)]
            for planes, i in zip(got, (0, 1, 0)):
                _assert_planes([p.numpy() for p in planes], want[i])
        assert not np.array_equal(want[0][0], want[1][0])
        step = _split_step(steps)
        assert len(step.split.parts) == slots // size and step.replays == 3
        return
    stream = tpar._tiny_stream(5)
    frames, _ = frames_from_stream(stream)
    want = decode_annexb_native(stream)
    if path == "gop":
        outs = [tpar.decode_gop_sharded(frames, mesh, graph=g)
                for g in (True, False)]
    else:
        frames, want = frames[:4], want[:4]
        outs = [tpar.make_banded_gop_fn(mesh, 4, 4, 4, Fi=Fi, graph=g)(
            frames) for g in (True, False)]
    for planes in outs:
        assert planes[0].shape[0] == len(want)
        for i, w in enumerate(want):
            _assert_planes([p[i] for p in planes], (w.y, w.cb, w.cr))
    assert len({w.y.tobytes() for w in want}) == len(want)
    assert len(_split_step(steps).split.parts) == slots // size


@pytest.mark.parametrize("path,axes,size", [
    ("gop", {"gop": 4}, 1), ("gop", {"gop": 4}, 2),
    ("band", {"band": 4}, 1), ("band", {"band": 3}, 2),
    ("frame", {"band": 4}, 1), ("frame", {"gop": 2, "band": 2}, 1),
    ("p_recon", {"band": 4}, 1), ("p_recon", {"band": 4}, 2)])
def test_no_exchange_outside_the_parts(steps, monkeypatch, path, axes,
                                       size):
    """With the slots cut in groups, a call of each path's step moves
    data between groups only inside the parts' functions and their copy
    into the step's planes (``Split.run``, ``Split.put``): outside them
    ``Step.__call__`` makes no ``peer_copy`` and no ``torch.cat``, the
    split has no ``before`` or ``after``, the step's planes stay one
    allocation across calls, and every result is a copy of them."""
    fs, golden = _fixture("mix_qp26")
    pic = _p_picture(6, 8, 3)
    depth = collections.Counter()      # "part", "call": calls open now
    seen = collections.Counter()       # (where, what) -> count

    def within(key, fn):
        def wrapper(*a, **k):
            depth[key] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[key] -= 1
        return wrapper

    def counted(name, fn):
        def wrapper(*a, **k):
            if depth["part"]:
                seen["inside", name] += 1
            elif depth["call"]:
                seen["outside", name] += 1
            return fn(*a, **k)
        return wrapper

    peer = counted("peer_copy", graphs.peer_copy)
    for mod in (graphs, tbands):
        monkeypatch.setattr(mod, "peer_copy", peer)
    monkeypatch.setattr(torch, "cat", counted("cat", torch.cat))
    for name in ("run", "put"):
        monkeypatch.setattr(graphs.Split, name,
                            within("part", getattr(graphs.Split, name)))
    monkeypatch.setattr(graphs.Step, "__call__",
                        within("call", graphs.Step.__call__))
    _cut(monkeypatch, size)
    mesh = tpar.make_mesh(axes, CPU8)
    calls = {
        "gop": lambda: tpar.decode_gop_sharded([fs] * 4, mesh),
        "band": lambda: tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, 2,
                                                Fi=1)([fs] * 2),
        "frame": lambda: tpar.make_banded_frame_fn(mesh, fs.mb_w,
                                                   fs.mb_h)(fs),
        "p_recon": lambda: tpar.make_banded_p_recon_fn(mesh, 6, 8,
                                                       apron=64)(*pic)}
    ptrs = []
    for _ in range(2):
        got = calls[path]()
        _assert_planes(got, _unbanded_p(*pic, 6, 8) if path == "p_recon"
                       else golden)
        step = _split_step(steps)
        ptrs.append([t.data_ptr() for t in step.outputs])
    assert not [k for k in seen if k[0] == "outside"], dict(seen)
    assert seen["inside", "peer_copy"] > 0 and ptrs[0] == ptrs[1]
    assert getattr(step.split, "before", None) is None
    assert getattr(step.split, "after", None) is None
    assert len(step.split.parts) == len(tmesh.slot_groups(
        mesh.axis_devices("gop" if path == "gop" else "band"))) > 1
    assert step.replays == 2 and steps.stats()["eager"] == 0


def test_eager_counts_only_graph_false(steps, monkeypatch):
    """``STEPS.eager`` moves on each graph=False call of every path over
    several groups, and on no graphed call."""
    fs, golden = _fixture("mix_qp26")
    _cut(monkeypatch, 1)
    mesh = tpar.make_mesh({"gop": 2, "band": 2}, CPU8)
    pic = _p_picture(6, 8, 3)
    calls = [lambda g: tpar.decode_gop_sharded([fs] * 2, mesh, graph=g),
             lambda g: tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, 2,
                                               Fi=1, graph=g)([fs] * 2),
             lambda g: tpar.make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h,
                                                 graph=g)(fs),
             lambda g: tpar.make_banded_p_recon_fn(mesh, 6, 8, apron=64,
                                                   graph=g)(*pic)]
    n = 0
    for graph in (True, False, True, False):
        for i, call in enumerate(calls):
            got = call(graph)
            _assert_planes(got, _unbanded_p(*pic, 6, 8) if i == 3
                           else golden)
            n += not graph
            assert steps.stats()["eager"] == n
    assert steps.made == 4 and steps.stats()["replays"] == 8


def test_slot_groups_follow_devices():
    """Runs of consecutive slots on one device; a device that comes back
    starts a new group; a key gains the groups only when there are
    several."""
    a, b = torch.device("meta"), torch.device("cpu")
    assert tmesh.slot_groups([a, a, b, b]) == [range(0, 2), range(2, 4)]
    assert tmesh.slot_groups([a, b, a, b]) == [range(i, i + 1)
                                              for i in range(4)]
    assert tmesh.slot_groups([b] * 3) == [range(0, 3)]
    assert tmesh.step_key(("k",), [range(0, 3)]) == ("k",)
    assert tmesh.step_key(("k",), [range(0, 1), range(1, 3)]) == (
        "k", ((0, 1), (1, 3)))


@pytest.mark.parametrize("layout,reads", [
    ("alternating", [(1,), (), (), (2,)]),
    ("runs", [(2,), (), (), (1,)])])
def test_replay_order_and_host_waits(layout, reads):
    """A step over several devices replays its parts in their order, and
    the first device's stream waits on the host for the parts on the
    other devices (``others``) before the results' copy, wherever they
    lie in the order.  A part that reads another device's inputs makes
    that device's loads wait for it, and it for them."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    like = [torch.zeros(2)] * 4
    devs = {"alternating": [cpu, meta, cpu, meta],
            "runs": [cpu, cpu, meta, meta]}[layout]

    def fn(*xs):
        return xs[:1]

    split = graphs.Split([(d, 1, fn) for d in devs], reads=reads)
    step = graphs.Step("k", split, like)
    assert step.devices == [cpu, meta]
    assert step.others == [i for i, d in enumerate(devs) if d == meta]
    assert step.reads == [{meta}, set(), set(), {cpu}]
    assert step.readers == {meta: [0], cpu: [3]}
