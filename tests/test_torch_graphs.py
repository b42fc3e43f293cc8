"""The port's captured device steps (``dryv_tpu_torch.graphs``) on the
CPU, where a step keeps its static inputs and outputs and runs its
function eagerly on them: the I/P/B, batched and per-picture paths give
the same bytes with and without steps (tolerance 0: the pipelines are
integer), the same as the JAX package and the libavcodec oracle, on a
P chain that would show an output handed out while a later replay of
its step still writes it; the I/P/B keys are the JAX path's
``_FN_CACHE`` keys; a key seen again replays the step made once; a
cache holds a bounded number of steps, and threads take turns at
them."""
import threading
import time

import numpy as np
import pytest
import torch

import dryv_tpu.device_ipb_packed as jax_ipb
from dryv_tpu.encoder import default_sps_pps
from dryv_tpu.encoder.intra_encoder import IntraEncoder
from dryv_tpu.encoder.p_frame import SequenceEncoder
from dryv_tpu.encoder.slices import (encode_frame_annexb,
                                     encode_sequence_annexb)
from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu_torch import device_ipb_packed, gop_pipeline, graphs, pipeline
from dryv_tpu_torch import wire

from test_device_ipb import _sources


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): a staging kept from an earlier test would start
    a decode at the caps that test grew to, not at the entry's start
    caps, and so change its steps' keys."""
    wire.release()
    yield
    wire.release()


def _planes(frames):
    return [(f.y, f.cb, f.cr) for f in sorted(frames, key=lambda f: f.poc)]


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for p, a, b in zip(("y", "cb", "cr"), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i} {p}")


@pytest.fixture(scope="module")
def p_chain():
    """I then four P pictures (6x4 MBs, in-loop filter on, two
    references): each P predicts from the pictures before it, the last
    three with the same key.  Decoded by the oracle, by the JAX packed
    path (with its key cache emptied first) and by the port with and
    without steps (with a fresh step cache whose step makers are
    counted)."""
    frame_at = _sources(31, 6, 4)
    sps, pps = default_sps_pps(6, 4, qp=28, poc_type=0, max_refs=2)
    se = SequenceEncoder(sps, pps, 28, deblock=True)
    frames = [(se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3)]
    frames += [(se.encode_p(*frame_at(2 * k), poc=4 * k), 5, False, k,
                4 * k, 3) for k in range(1, 5)]
    stream = encode_sequence_annexb(sps, pps, frames, deblock_disable=0)
    made = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_ipb, "_FN_CACHE", {})
        jax_frames = jax_ipb.decode_annexb_device_packed(stream)
        jax_keys = set(jax_ipb._FN_CACHE)
        steps = graphs.StepCache()
        m.setattr(device_ipb_packed, "STEPS", steps)
        fn = device_ipb_packed._picture_fn
        m.setattr(device_ipb_packed, "_picture_fn",
                  lambda *a: made.append(a[1:]) or fn(*a))
        d = device_ipb_packed.decode_annexb_device_packed
        graphed = d(stream, device="cpu")
        eager = d(stream, device="cpu", graph=False)
    return {"oracle": decode_annexb(stream), "jax": _planes(jax_frames),
            "jax_keys": jax_keys, "graphed": _planes(graphed),
            "eager": _planes(eager), "steps": steps, "made": made}


def test_p_chain_graphed_equals_eager_jax_and_oracle(p_chain):
    _equal(p_chain["graphed"], p_chain["oracle"])
    _equal(p_chain["eager"], p_chain["graphed"])
    _equal(p_chain["jax"], p_chain["graphed"])


def test_ipb_keys_are_the_jax_paths(p_chain):
    """Port key (device, mb_w, mb_h, deblocked, wp_mode, c0, c1, W, ecap,
    ovcap, nlists, R) without R; JAX key (mb_w, mb_h, deblocked,
    wp_mode, c0, c1, W, ecap, ovcap, interpret, nlists) without
    interpret, mb_w and mb_h."""
    ours = {k[3:-1] for k in p_chain["steps"].steps}
    theirs = {k[2:9] + k[10:] for k in p_chain["jax_keys"]}
    assert ours == theirs
    assert {k[-2] for k in p_chain["steps"].steps} == {0, 1}


def test_a_key_seen_again_replays_the_step_made_once(p_chain):
    steps = p_chain["steps"].steps
    # R is 0 for the I picture, 1 for the first P and 2 for the others
    assert sorted((k[-2], k[-1], s.replays) for k, s in steps.items()) == \
        [(0, 0, 1), (1, 1, 1), (1, 2, 3)]
    assert len(p_chain["made"]) == len(steps) == 3
    assert p_chain["steps"].stats() == {
        "keys": 3, "made": 3, "captured": 0, "graphs": 0, "capture_ms": 0.0,
        "replays": 5, "pool_mib": {}}


def _intra_stream(n_pics, kinds=("i8", "i4", "i16")):
    """Distinct intra pictures of 4x3 MBs, one parameter set, in-loop
    filter on; MB kinds cycle through `kinds`."""
    out = b""
    for t in range(n_pics):
        rng = np.random.RandomState(t)
        y = np.clip(rng.randint(0, 256, (48, 64)) * 0.4
                    + np.linspace(0, 150, 64)[None], 0, 255)
        cb = np.clip(rng.randint(0, 256, (24, 32)) * 0.3 + 90, 0, 255)
        cr = np.clip(rng.randint(0, 256, (24, 32)) * 0.3 + 70, 0, 255)
        sps, pps = default_sps_pps(4, 3, qp=30, transform_8x8=True,
                                   chroma_qp_offset=2)
        enc = IntraEncoder(sps, pps, 30, mb_kind_policy=lambda a, t=t:
                           kinds[(a + t) % len(kinds)])
        mbs = enc.encode_frame(y.astype(np.int64), cb.astype(np.int64),
                               cr.astype(np.int64))
        out += encode_frame_annexb(sps, pps, None, mbs, deblock_disable=0)
    return out


def test_two_batches_of_one_key_return_distinct_correct_tensors(
        monkeypatch):
    stream = _intra_stream(4)
    want = decode_annexb(stream)
    steps = graphs.StepCache()
    monkeypatch.setattr(gop_pipeline, "STEPS", steps)
    out = gop_pipeline.decode_annexb_gop_pipelined(
        stream, gop=2, device="cpu", stacked_out=True)
    assert [nf for *_, nf in out] == [2, 2]
    (key, step), = steps.steps.items()
    assert step.replays == 2 and key[3] == 2
    got = [tuple(p[i].numpy() for p in r[:3]) for r in out for i in range(2)]
    _equal([tuple(a[:w.shape[0], :w.shape[1]] for a, w in zip(g, ref))
            for g, ref in zip(got, want)], want)
    ptrs = {t.data_ptr() for r in out for t in r[:3]}
    ptrs |= {t.data_ptr() for t in step.outputs}
    assert len(ptrs) == 9
    eager = gop_pipeline.decode_annexb_gop_pipelined(stream, gop=2,
                                                     device="cpu",
                                                     graph=False)
    _equal(_planes(eager), want)


def test_per_picture_steps_keyed_by_pcm_presence(monkeypatch):
    """PCM pictures bring pcm_y/pcm_c into the syntax tensors, so they
    take a step of their own; graphed and eager equal the oracle."""
    stream = _intra_stream(2) + _intra_stream(1, ("pcm", "i4")) \
        + _intra_stream(1)
    want = decode_annexb(stream)
    steps = graphs.StepCache()
    monkeypatch.setattr(pipeline, "STEPS", steps)
    host_calls = pipeline.decode_annexb_fast.host_calls
    _equal(_planes(pipeline.decode_annexb_fast(stream, device="cpu")), want)
    _equal(_planes(pipeline.decode_annexb_fast(stream, device="cpu",
                                               graph=False)), want)
    assert pipeline.decode_annexb_fast.host_calls == host_calls
    by_pcm = {"pcm_y" in k[4]: s.replays for k, s in steps.steps.items()}
    assert by_pcm == {False: 3, True: 1}
    assert all(k[3] for k in steps.steps)     # deblocked


def test_step_loads_stacks_and_hands_out_clones():
    """A sequence input fills a stacked static input; every call returns
    new tensors, never the static outputs."""
    calls = []

    def fn(a, stack):
        calls.append(1)
        return a + stack.sum(0), stack[0] * 2

    s = graphs.StepCache()
    x = [torch.arange(4), [torch.ones(4, dtype=torch.long),
                           torch.full((4,), 3)]]
    cpu = torch.device("cpu")
    with s.hold("k", lambda: fn, x, cpu) as step:
        step.load(*x)
        r1 = step()
    with s.hold("k", lambda: None, x, cpu) as again:
        assert again is step
        step.load(torch.zeros(4, dtype=torch.long),
                  [torch.full((4,), 5), torch.zeros(4, dtype=torch.long)])
        r2 = step()
    assert r1[0].tolist() == [4, 5, 6, 7] and r1[1].tolist() == [2] * 4
    assert r2[0].tolist() == [5] * 4 and r2[1].tolist() == [10] * 4
    assert len(calls) == 2 and step.replays == 2
    assert step.inputs[1].shape == (2, 4)
    assert not {t.data_ptr() for t in r1 + r2} & \
        {t.data_ptr() for t in step.outputs}
    with pytest.raises(TypeError):
        step.load(torch.zeros(4))


def test_cache_releases_the_least_recently_used_step():
    s = graphs.StepCache(max_keys=2)
    cpu = torch.device("cpu")
    x = [torch.zeros(2)]
    held = {}
    for k in ("a", "b", "a", "c"):
        with s.hold(k, lambda: lambda v: (v + 1,), x, cpu) as step:
            step.load(*x)
            step()
            held[k] = step
    assert list(s.steps) == ["a", "c"]
    assert held["b"].inputs == [] and held["b"].outputs is None
    assert s.stats() == {"keys": 2, "made": 3, "captured": 0,
                         "graphs": 0, "capture_ms": 0.0, "replays": 3,
                         "pool_mib": {}}


def test_threads_take_turns_at_a_step():
    """Each thread loads its own input, waits, then runs the step: while
    one holds the step the other cannot load over its input."""
    s = graphs.StepCache()
    cpu = torch.device("cpu")
    got = {}

    def decode(v):
        x = torch.full((3,), v)
        with s.hold("k", lambda: lambda a: (a * 2,), [x], cpu) as step:
            step.load(x)
            time.sleep(0.2)
            got[v] = step()[0].tolist()

    threads = [threading.Thread(target=decode, args=(v,)) for v in (1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == {1: [2] * 3, 5: [10] * 3}


def test_per_picture_steps_keyed_by_the_lists_content(monkeypatch):
    """Tables built again for the same LevelScale lists (after the
    tables' cache let them go) replay the same step."""
    stream = _intra_stream(2)
    steps = graphs.StepCache()
    monkeypatch.setattr(pipeline, "STEPS", steps)
    for _ in range(2):
        pipeline._cached_tables.cache_clear()
        _equal(_planes(pipeline.decode_annexb_fast(stream, device="cpu")),
               decode_annexb(stream))
    (step,) = steps.steps.values()
    assert step.replays == 4 and steps.made == 1


@pytest.mark.parametrize("mode", ["stacked_out", "device_out"])
def test_a_decode_allocates_each_plane_once(monkeypatch, mode):
    """A graphed decode whose planes stay on the device copies each
    batch's planes out of the step's static outputs into one tensor per
    plane allocated for the whole decode: 3 storages for 3 batches, where
    a clone per batch and plane would make 9."""
    monkeypatch.setattr(gop_pipeline, "STEPS", graphs.StepCache())
    out = gop_pipeline.decode_annexb_gop_pipelined(
        _intra_stream(5), gop=2, device="cpu", **{mode: True})
    planes = [t for r in out for t in r[:3]]
    assert len(planes) == (9 if mode == "stacked_out" else 15)
    assert len({t.untyped_storage().data_ptr() for t in planes}) == 3


@pytest.fixture(scope="module")
def jax_intra():
    """Two streams of distinct intra pictures (4x3 MBs, one key of the
    batched step at gop=2) and the JAX pipeline's decode of each (Pallas
    in interpret mode)."""
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined as jax_dec

    streams = (_intra_stream(5), _intra_stream(3, ("i16", "i4")))
    return [(s, [(f.y, f.cb, f.cr) for f in jax_dec(s, gop=2, n_threads=1,
                                                     interpret=True)])
            for s in streams]


@pytest.mark.parametrize("decodes", [1, 2])
def test_held_planes_stay_bit_exact_after_later_calls(monkeypatch, jax_intra,
                                                      decodes):
    """Every batch's planes of one decode, and of two decodes in a row,
    held while later batches and another decode replay the same step,
    stay equal to the JAX pipeline's decode of their stream."""
    steps = graphs.StepCache()
    monkeypatch.setattr(gop_pipeline, "STEPS", steps)

    def decode(stream):
        return gop_pipeline.decode_annexb_gop_pipelined(
            stream, gop=2, device="cpu", stacked_out=True)

    held = [(decode(s), want) for s, want in jax_intra[:decodes]]
    decode(jax_intra[-1][0])
    assert steps.made == 1
    # 3 batches of the first stream, 2 of the second
    assert next(iter(steps.steps.values())).replays == {1: 5, 2: 7}[decodes]
    for out, want in held:
        got = [tuple(p[i].numpy() for p in r[:3]) for r in out
               for i in range(r[3])]
        _equal(got, want)
