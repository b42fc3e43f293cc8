"""The port's sharded paths through their captured steps
(``dryv_tpu_torch.parallel.STEPS``) on the CPU, where a step keeps its
static inputs and outputs and runs its function eagerly on them: each
graphed route equals the eager route (``graph=False``), the JAX function
(8 virtual CPU devices, Pallas in interpret mode) and the oracle's
golden, with tolerance 0 (the paths are integer).  A key names the
mesh's slot devices and axis, a key seen again replays the one step
made, two calls of one key hand out distinct, correct tensors, and a
mesh whose slots span several devices runs op by op, counted in
``STEPS.eager``."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch import parallel as tpar
from dryv_tpu_torch.native.full import decode_annexb_native
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


@pytest.mark.parametrize("gop", [2, 4])
def test_gop_sharded_graphed(steps, gop):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.gop import decode_gop_sharded

    fs, golden = _fixture("mix_qp26")
    fl = [fs] * (gop + 1)
    mesh = tpar.make_mesh({"gop": gop}, CPU8)
    got = tpar.decode_gop_sharded(fl, mesh)
    assert steps.stats()["eager"] == 0 and steps.made == 1
    eager = tpar.decode_gop_sharded(fl, mesh, graph=False)
    assert got[0].shape[0] == gop + 1 and got[0].dtype == np.uint8
    ref = decode_gop_sharded(fl, make_mesh({"gop": gop}))
    _assert_planes(got, eager, ref, golden)
    (key, step), = steps.steps.items()
    # F_local: gop + 1 pictures padded to 2 a slot
    assert key[:5] == (tuple(mesh.axis_devices("gop")), "gop", fs.mb_w,
                       fs.mb_h, 2)
    assert steps.stats()["eager"] == 1 and step.replays == 1


@pytest.mark.parametrize("name", ["mix_qp26", "big_qp30"])
@pytest.mark.parametrize("n_bands,Fi", [(2, 2), (4, 1), (3, 1)])
def test_banded_gop_graphed(steps, name, n_bands, Fi):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_gop_pallas_fn

    fs, golden = _fixture(name)
    F = 2 * Fi
    mesh = tpar.make_mesh({"band": n_bands}, CPU8)
    run = tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, F, Fi=Fi)
    assert run.graphed
    got = run([fs] * F)
    eager_run = tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, F, Fi=Fi,
                                        graph=False)
    assert not eager_run.graphed
    eager = eager_run([fs] * F)
    ref = make_banded_gop_pallas_fn(make_mesh({"band": n_bands}), fs.mb_w,
                                    fs.mb_h, F, Fi=Fi,
                                    interpret=True)([fs] * F)
    _assert_planes(got, eager, ref, golden)
    assert steps.stats() == {"keys": 1, "made": 1, "captured": 0,
                             "graphs": 0, "capture_ms": 0.0, "replays": 1,
                             "pool_mib": {}, "eager": 1}


@pytest.mark.parametrize("axes", [{"band": 2}, {"band": 3},
                                  {"gop": 2, "band": 2}])
def test_banded_frame_graphed(steps, axes):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_frame_fn

    fs, golden = _fixture("mix_qp26")
    mesh = tpar.make_mesh(axes, CPU8)
    run = tpar.make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h)
    assert run.graphed
    got = run(fs)
    eager = tpar.make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h,
                                      graph=False)(fs)
    ref = make_banded_frame_fn(make_mesh(axes), fs.mb_w, fs.mb_h)(fs)
    _assert_planes(got, eager, ref, golden)
    (key, step), = steps.steps.items()
    assert key[:2] == (tuple(mesh.axis_devices("band")), "band")
    assert key[4:6] == (1, 1) and step.replays == 1


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_p_recon_graphed(steps, n_bands):
    """The 4-band case chains its 64-row aprons over two bands of 32
    rows inside the captured step."""
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_p_recon_fn

    mb_w, mb_h = 6, 8
    pic = _p_picture(mb_w, mb_h, 3)
    mesh = tpar.make_mesh({"band": n_bands}, CPU8)
    run = tpar.make_banded_p_recon_fn(mesh, mb_w, mb_h, apron=64)
    assert run.graphed
    got = run(*pic)
    eager_run = tpar.make_banded_p_recon_fn(mesh, mb_w, mb_h, apron=64,
                                            graph=False)
    assert not eager_run.graphed
    eager = eager_run(*pic)
    ref = make_banded_p_recon_fn(make_mesh({"band": n_bands}), mb_w, mb_h,
                                 apron=64)(*pic)
    _assert_planes(got, eager, ref, _unbanded_p(*pic, mb_w, mb_h))
    (key, step), = steps.steps.items()
    assert key == (tuple(mesh.axis_devices("band")), "band", mb_w, mb_h, 64)
    assert len(step.inputs) == 7 * n_bands
    with pytest.raises(AssertionError, match="exceeds apron"):
        tpar.make_banded_p_recon_fn(mesh, mb_w, mb_h, apron=16)(*pic)
    assert steps.made == 1


def test_a_key_seen_again_replays_the_step_made_once(steps):
    """A second run object of the same geometry and mesh finds the step
    the first one made; another mesh size or axis makes its own."""
    fs, golden = _fixture("mix_qp26")
    args = (fs.mb_w, fs.mb_h, 2)
    mesh = tpar.make_mesh({"band": 2}, CPU8)
    for run in [tpar.make_banded_gop_fn(mesh, *args, Fi=1)] * 2 \
            + [tpar.make_banded_gop_fn(mesh, *args, Fi=1)]:
        _assert_planes(run([fs] * 2), golden)
    assert steps.made == 1
    (step,) = steps.steps.values()
    assert step.replays == 3
    tpar.make_banded_gop_fn(tpar.make_mesh({"band": 3}, CPU8), *args,
                            Fi=1)([fs] * 2)
    tpar.make_banded_gop_fn(tpar.make_mesh({"gop": 2, "band": 2}, CPU8),
                            *args, Fi=1, axis="gop")([fs] * 2)
    assert steps.made == 3
    assert {k[:2] for k in steps.steps} == {
        ((torch.device("cpu"),) * 2, "band"),
        ((torch.device("cpu"),) * 3, "band"),
        ((torch.device("cpu"),) * 2, "gop")}


def test_keys_hold_the_slot_devices(steps):
    """Each path's key starts with its axis's slot devices, as
    torch.device objects, and the axis name."""
    fs, _ = _fixture("mix_qp26")
    mesh = tpar.make_mesh({"gop": 2, "band": 2}, CPU8)
    tpar.decode_gop_sharded([fs] * 2, mesh)
    tpar.make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h)(fs)
    tpar.make_banded_p_recon_fn(mesh, 6, 8, apron=64)(*_p_picture(6, 8, 1))
    slots = (torch.device("cpu"),) * 2
    assert sorted(k[:2] for k in steps.steps) == [
        (slots, "band"), (slots, "band"), (slots, "gop")]
    assert all(isinstance(d, torch.device) for k in steps.steps
               for d in k[0])


def test_two_calls_of_one_key_return_distinct_correct_tensors(steps):
    """Two distinct pictures through one banded step, and two P pictures
    through one banded P recon step, the first result held while the
    second replays: each equals its own reference, and no result is a
    static output of the step."""
    stream = tpar._tiny_stream()
    frames, _ = frames_from_stream(stream)
    want = decode_annexb_native(stream)
    mesh = tpar.make_mesh({"band": 2}, CPU8)
    run = tpar.make_banded_gop_fn(mesh, 4, 4, 1, Fi=1)
    r1 = run([frames[0]], device_out=True)
    r2 = run([frames[1]], device_out=True)
    for r, w in ((r1, want[0]), (r2, want[1])):
        _assert_planes([p[0].numpy() for p in r], (w.y, w.cb, w.cr))
    assert not np.array_equal(r1[0].numpy(), r2[0].numpy())
    pr = tpar.make_banded_p_recon_fn(mesh, 6, 8, apron=64)
    pics = [_p_picture(6, 8, seed) for seed in (5, 6)]
    p1, p2 = (pr(*pic, device_out=True) for pic in pics)
    for got, pic in ((p1, pics[0]), (p2, pics[1])):
        _assert_planes([p.numpy() for p in got], _unbanded_p(*pic, 6, 8))
    outs = [t.data_ptr() for s in steps.steps.values() for t in s.outputs]
    ptrs = [t.data_ptr() for r in (r1, r2, p1, p2) for t in r]
    assert len(set(ptrs)) == 12 and not set(ptrs) & set(outs)
    assert [s.replays for s in steps.steps.values()] == [2, 2]


def test_a_mesh_over_several_devices_runs_eager_and_counts(steps,
                                                           monkeypatch):
    """Slots on several devices (here each slot a group of its own,
    through the seam ``mesh._slot_group``, as each card of a mesh is):
    with graph=False every path runs op by op, says so in ``graphed`` and
    counts each call in ``STEPS.eager``; graphed, each path makes one
    step of one part per group, counts nothing in ``STEPS.eager``, and
    the planes stay right both ways."""
    monkeypatch.setattr(tmesh, "_slot_group", lambda i, d: i)
    fs, golden = _fixture("mix_qp26")
    mesh = tpar.make_mesh({"gop": 2, "band": 2}, CPU8)
    pic = _p_picture(6, 8, 3)
    for graph in (False, True):
        _assert_planes(tpar.decode_gop_sharded([fs] * 2, mesh, graph=graph),
                       golden)
        run = tpar.make_banded_gop_fn(mesh, fs.mb_w, fs.mb_h, 2, Fi=1,
                                      graph=graph)
        frame = tpar.make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h,
                                          graph=graph)
        pr = tpar.make_banded_p_recon_fn(mesh, 6, 8, apron=64, graph=graph)
        assert run.graphed == frame.graphed == pr.graphed == graph
        _assert_planes(run([fs] * 2), golden)
        _assert_planes(frame(fs), golden)
        _assert_planes(pr(*pic), _unbanded_p(*pic, 6, 8))
    assert steps.stats() == {"keys": 4, "made": 4, "captured": 0,
                             "graphs": 0, "capture_ms": 0.0, "replays": 4,
                             "pool_mib": {}, "eager": 4}
    assert [len(s.split.parts) for s in steps.steps.values()] == [2] * 4


@pytest.mark.parametrize("path,slots,Fi", [("gop", 2, 0), ("gop", 4, 0),
                                           ("band", 2, 2), ("band", 4, 1)])
def test_distinct_pictures_in_order(steps, path, slots, Fi):
    """Five distinct pictures through each graphed path and its eager
    route, each frame held against the native decode of its own picture:
    a step that mixed up the order of pictures, slots or frame groups in
    its static inputs would show here (the GOP pads to 6 or 8 pictures;
    the band pipeline takes the first 4 in groups of Fi)."""
    stream = tpar._tiny_stream(5)
    frames, _ = frames_from_stream(stream)
    want = decode_annexb_native(stream)
    mesh = tpar.make_mesh({path: slots}, CPU8)
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
    assert steps.made == 1 and steps.stats()["eager"] == 1
