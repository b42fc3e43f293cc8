"""The port's counterpart of ``__graft_entry__.entry()``
(``dryv_tpu_torch.pipeline.entry``) and its per-picture step with the
LevelScale lists as inputs, on the CPU, tolerance 0 (integer planes):
the example picture is the stream the JAX ``entry()`` decodes; the
planes equal the JAX function's, the native C++ decode's and, under
non-flat lists, the JAX ``_build(4, 4)`` recon's on the same lists; a
step is made once per geometry whatever the lists, on ``entry()``'s
function and on a stream whose pictures switch between flat and custom
scaling matrices."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch import graphs, pipeline
from dryv_tpu_torch.avc.sps import ScalingLists
from dryv_tpu_torch.encoder import default_sps_pps, encode_frame_annexb
from dryv_tpu_torch.encoder.intra_encoder import IntraEncoder
from dryv_tpu_torch.kernels.geometry import LS4_FLAT, LS8_FLAT
from dryv_tpu_torch.native.full import decode_annexb_native
from dryv_tpu_torch.parallel import _tiny_stream
from dryv_tpu_torch import wire


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): a staging kept from an earlier test would start
    a decode at the caps that test grew to, not at the entry's start
    caps, and so change its steps' keys."""
    wire.release()
    yield
    wire.release()


def _scaling_lists():
    """The weight lists of the scal_* fixtures
    (``dryv_tpu/testing/fixtures.py`` :152-156)."""
    rng = np.random.RandomState(7)
    l4 = np.stack([np.sort(np.clip(10 + rng.randint(-6, 26, 16), 1, 255))
                   for _ in range(6)]).astype(np.int32)
    l8 = np.stack([np.sort(np.clip(10 + rng.randint(-6, 38, 64), 1, 255))
                   for _ in range(6)]).astype(np.int32)
    return ScalingLists(l4, l8)


def _with_scaling(sps, pps):
    """sps with an SPS scaling matrix (``_scaling_lists``), High profile."""
    sps.profile_idc = 100
    sps.seq_scaling_matrix_present_flag = 1
    sps.seq_scaling_lists = _scaling_lists()
    return sps, pps


def _custom_level_scales():
    """LevelScale lists of ``_scaling_lists`` as a stream's parameter
    sets give them (``pipeline._level_scales``): 3 x [6,4,4], [6,8,8]."""
    ls4, ls8 = pipeline._level_scales(*_with_scaling(
        *default_sps_pps(4, 4, qp=28, transform_8x8=True)))
    assert not any(np.array_equal(a, LS4_FLAT) for a in ls4)
    assert not np.array_equal(ls8, LS8_FLAT)
    return ls4, ls8


@pytest.fixture
def steps(monkeypatch):
    s = graphs.StepCache()
    monkeypatch.setattr(pipeline, "STEPS", s)
    return s


def _equal(got, want):
    assert len(got) == len(want) == 3
    for p, g, w in zip(("y", "cb", "cr"), got, want):
        g = np.asarray(g)
        assert g.shape == np.asarray(w).shape, p
        np.testing.assert_array_equal(g, w, err_msg=p)


def test_tiny_stream_is_the_slices_qp28_fixture():
    from dryv_tpu.testing.fixtures import get_fixture

    stream = _tiny_stream(1)
    assert len(stream) == 3682
    assert stream == get_fixture("slices_qp28")[0]


def test_entry_equals_the_jax_entry_and_native(steps):
    import __graft_entry__ as ge

    fn, args = pipeline.entry(device="cpu")
    s, ls4y, ls4cb, ls4cr, ls8y = args
    assert all(t.device.type == "cpu" for t in (*s.values(), *args[1:]))
    assert ls4y.shape == (6, 4, 4) and ls8y.shape == (6, 8, 8)
    got = fn(*args)
    assert [tuple(p.shape) for p in got] == [(64, 64), (32, 32), (32, 32)]
    assert all(p.dtype == torch.uint8 for p in got)
    jfn, jargs = ge.entry()
    _equal([p.numpy() for p in got], [np.asarray(p) for p in jfn(*jargs)])
    (ref,) = decode_annexb_native(_tiny_stream(1))
    _equal([p.numpy() for p in got], (ref.y, ref.cb, ref.cr))
    assert steps.made == 1


def test_entry_under_other_lists_equals_jax_build(steps):
    """Custom lists through the same step: the JAX ``_build(4, 4)`` recon
    on the same syntax and lists; rows [6,16] / [6,64] as well as the
    lists' own shapes; one step made, replayed three times."""
    import jax.numpy as jnp
    from dryv_tpu.pipeline import SYNTAX_KEYS, _build

    import __graft_entry__ as ge

    fn, (s, *flat) = pipeline.entry(device="cpu")
    ls4, ls8 = _custom_level_scales()
    lists = [*ls4, ls8]
    fs = ge._tiny_syntax()
    ref = _build(fs.mb_w, fs.mb_h)(
        {k: jnp.asarray(getattr(fs, k)) for k in SYNTAX_KEYS},
        *(jnp.asarray(a) for a in lists))
    flat_planes = [p.clone() for p in fn(s, *flat)]
    got = fn(s, *(torch.from_numpy(a) for a in lists))
    _equal([p.numpy() for p in got], [np.asarray(p) for p in ref])
    assert any(not torch.equal(a, b) for a, b in zip(got, flat_planes))
    rows = fn(s, *(torch.from_numpy(a.reshape(6, -1)) for a in lists))
    _equal([p.numpy() for p in rows], [np.asarray(p) for p in ref])
    (step,) = steps.steps.values()
    assert steps.made == 1 and step.replays == 3


def _switching_stream(mb_w, mb_h, n_pics):
    """Pictures with the recipe of chip_smoke.py's ``encoder_stream``
    (every MB kind including PCM, 8x8 transform, two MB rows per slice,
    in-loop filter on, chroma QP offset 2), each with its own SPS and
    PPS: even pictures CAVLC with flat lists (parameter set ids 0), odd
    ones CABAC with an SPS scaling matrix (ids 1), so that the stream
    switches lists from picture to picture at one geometry."""
    kinds = ["i8", "i4", "i16", "pcm"]
    out = b""
    for t in range(n_pics):
        rng = np.random.RandomState(t)
        W, H = 16 * mb_w, 16 * mb_h
        y = np.clip(rng.randint(0, 256, (H, W)) * 0.3
                    + np.linspace(0, 200, W)[None]
                    + np.linspace(0, 40, H)[:, None], 0, 255)
        cb = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 100,
                     0, 255)
        cr = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 80,
                     0, 255)
        sps, pps = default_sps_pps(mb_w, mb_h, qp=30, transform_8x8=True,
                                   chroma_qp_offset=2, cabac=bool(t % 2))
        if t % 2:
            _with_scaling(sps, pps)
            sps.seq_parameter_set_id = 1
            pps.pic_parameter_set_id = pps.seq_parameter_set_id = 1
        enc = IntraEncoder(sps, pps, 30,
                           mb_kind_policy=lambda a, t=t: kinds[(a + t) % 4])
        mbs = enc.encode_frame(y.astype(np.int64), cb.astype(np.int64),
                               cr.astype(np.int64),
                               slice_bounds=list(range(0, mb_w * mb_h,
                                                       2 * mb_w)))
        out += encode_frame_annexb(sps, pps, 2, mbs, deblock_disable=0)
    return out


@pytest.mark.parametrize("graph", [True, False])
def test_lists_switching_pictures_share_a_step(steps, graph):
    """Flat-list and scaling-matrix pictures of one geometry (PCM in
    each, in-loop filter on) through ``decode_annexb_fast``: every
    picture equal to native C++ and the libavcodec oracle, one step made
    and replayed for each picture (none with ``graph=False``)."""
    from dryv_tpu.testing.oracle import decode_annexb

    stream = _switching_stream(4, 4, 4)
    before = pipeline.decode_annexb_fast.host_calls
    got = pipeline.decode_annexb_fast(stream, device="cpu", graph=graph)
    assert pipeline.decode_annexb_fast.host_calls == before
    native = decode_annexb_native(stream)
    oracle = decode_annexb(stream)
    assert len(got) == len(native) == len(oracle) == 4
    for g, n, o in zip(got, native, oracle):
        _equal((g.y, g.cb, g.cr), (n.y, n.cb, n.cr))
        _equal((g.y, g.cb, g.cr), o)
    if graph:
        (step,) = steps.steps.values()
        assert steps.made == 1 and step.replays == 4
    else:
        assert steps.made == 0


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.entry()
