"""The batched intra entropy stage: ``native.entropy.decode_pack_batch``
(every slice of every picture of a batch a native task, at most
`n_threads` at once) as ``gop_pipeline.pack_batch`` drives it on a
``wire.Staging``, on
the CPU with the benchmark's tiny all-intra stream (16 one-slice IDR
pictures of 20x12 MBs, ``avcbench/tests/configs/tiny-intra``).  The blob
a batch ships is the same bytes at every `n_threads` and the same as
each picture packed alone by the per-picture entry at the batch's final
caps; a cap growth decodes again just the pictures its rule names; the
output arenas carry nothing from one batch to the next; a PCM picture
sends the batch to the PCM route; no more tasks than `n_threads` run at
once."""
import contextlib
import os
from pathlib import Path

import numpy as np
import pytest

from dryv_tpu_torch import gop_pipeline as gp
from dryv_tpu_torch import wire
from dryv_tpu_torch.kernels.geometry import BLK, round_up
from dryv_tpu_torch.native import entropy
from dryv_tpu_torch.utils.obs import StageTimers

INTRA = (Path(__file__).resolve().parent.parent / "avcbench" / "tests"
         / "configs" / "tiny-intra" / "idr16_s3.264").read_bytes()
PICS, SPS, PPS = gp._parse_pictures(INTRA)
N = SPS.pic_width_in_mbs * SPS.frame_height_in_mbs
NPAD = round_up(N, BLK)
START = gp.START_CAPS


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): the growth and re-decodes pinned here are a
    first call's, which a kept staging skips."""
    wire.release()
    yield
    wire.release()


class Quiet:
    """The ``timers=`` protocol, keeping nothing."""

    def stage(self, name):
        return contextlib.nullcontext()

    def count(self, name, v):
        pass


def _pack(batch, n_threads, caps=START, tm=None, sps=SPS, pps=PPS):
    """A fresh one-slot staging for `batch`, started at `caps`; returns
    it and its packed blob (a numpy copy, None for PCM)."""
    n = sps.pic_width_in_mbs * sps.frame_height_in_mbs
    st = wire.Staging(len(batch), round_up(n, BLK), n, START, slots=1)
    if caps != START:
        st.grow(caps, Quiet())
    blob = gp.pack_batch(st, 0, batch, sps, pps, n_threads, tm or Quiet())
    return st, None if blob is None else blob.numpy().copy()


@pytest.fixture(scope="module")
def serial():
    return _pack(PICS, 1)


@pytest.mark.parametrize("n_threads", [2, 4, 8])
def test_blob_is_the_same_at_every_thread_count(serial, n_threads):
    st1, blob1 = serial
    st, blob = _pack(PICS, n_threads)
    assert st.caps == st1.caps != START
    assert np.array_equal(blob, blob1)


def test_blob_is_each_picture_packed_alone_at_the_final_caps(serial):
    """Each picture's slot of the batch's blob equals the per-picture
    entry's pack of that picture alone into fresh buffers at the caps
    the batch ended at (picture 0 grew W to 256 and then ovcap)."""
    st, blob = serial
    W, ecap, ovcap = st.caps
    assert st.caps == (256, 256, 256)
    offs = wire.layout(len(PICS), NPAD, N, W, ecap, ovcap)[0]
    views = {name: np.ndarray(shape, dt, buffer=blob, offset=off)
             for name, (off, shape, dt) in offs.items()}
    for i, (slice_datas, headers) in enumerate(PICS):
        alone = wire.alloc(1, NPAD, N, W, ecap, ovcap)[1]
        cnt = np.zeros(NPAD, np.int32)
        entropy.decode_pack_picture_islices(
            slice_datas, SPS, PPS, W, wire.dbctl_of(headers),
            alone["bmp"][0], alone["vals"][0], cnt, alone["u8"][0],
            alone["exc_idx"][0], alone["exc_delta"][0],
            alone["ovf_idx"][0], alone["ovf_rows"][0], n_threads=1)
        for name in offs:
            assert np.array_equal(views[name][i], alone[name][0]), (i, name)


# max nonzeros a MB, exceptions and overflow MBs of pictures 0-3 at W
# 224 (and 256): (339, 0, 219 (218)), (218, 0, 0), (226, 0, 1 (0)),
# (218, 0, 0).  Picture 0 is dense (219 x 816 bytes of overflow rows >
# 256 MBs x 32): W grows to min(352, 256); only the pictures whose max
# exceeded the old W are decoded again, and at W 256 picture 0's 218
# overflow rows grow ovcap to 256.
@pytest.mark.parametrize("caps,idx,calls", [
    (START, [0, 1, 2, 3],
     [(START, [0, 1, 2, 3]), ((256, 256, 64), [0, 1, 2, 3]),
      ((256, 256, 256), [0])]),
    ((224, 256, 64), [0, 1, 3],
     [((224, 256, 64), [0, 1, 3]), ((256, 256, 64), [0]),
      ((256, 256, 256), [0])]),
    ((224, 256, 64), [1, 2, 3], [((224, 256, 64), [1, 2, 3])]),
])
def test_growth_decodes_again_only_the_pictures_the_rule_names(
        caps, idx, calls, monkeypatch):
    seen = []
    batch_entry = entropy.decode_pack_batch

    def recorded(pics, sps, pps, W, views, n_threads=0):
        keys = [id(p[0]) for p in PICS]
        seen.append(((W, len(views[0][4]), len(views[0][6])),
                     [keys.index(id(sd)) for sd, _ in pics]))
        return batch_entry(pics, sps, pps, W, views, n_threads)

    monkeypatch.setattr(entropy, "decode_pack_batch", recorded)
    tm = StageTimers()
    st, blob = _pack([PICS[i] for i in idx], 4, caps, tm)
    assert seen == calls
    assert tm.counters["retries"] == len({i for _, r in calls[1:]
                                          for i in r})
    assert tm.n.get("redecode", 0) == len(calls) - 1
    assert tm.counters["frames"] == len(idx)
    # the same bytes as a batch started at the final caps, which decodes
    # every picture once
    tm2 = StageTimers()
    st2, blob2 = _pack([PICS[i] for i in idx], 4, st.caps, tm2)
    assert np.array_equal(blob, blob2) and st2.caps == st.caps
    assert tm2.counters["retries"] == 0 and "redecode" not in tm2.n
    assert tm2.counters["bins"] == tm.counters["bins"]


def test_no_arena_state_survives_between_batches(monkeypatch):
    """Batch B's bytes are the same on fresh arenas and after batch A
    went through them, on other thread counts."""
    monkeypatch.setattr(entropy, "_SLOTS", {})
    fresh = _pack(PICS[8:], 2)[1]
    first = list(entropy._SLOTS[(N, 1)])
    assert len(first) == 2
    _pack(PICS[:8], 8)
    assert all(a is b for a, b in zip(entropy._SLOTS[(N, 1)], first))
    again = _pack(PICS[8:], 4)[1]
    assert np.array_equal(again, fresh)
    assert len(entropy._SLOTS) == 1 and len(entropy._SLOTS[(N, 1)]) == 8


def _fixture_pictures(name):
    from dryv_tpu.testing.fixtures import get_fixture

    return gp._parse_pictures(get_fixture(name)[0])


def test_a_pcm_picture_returns_none():
    pics, sps, pps = _fixture_pictures("pcm")
    st, blob = _pack(pics * 3, 4, sps=sps, pps=pps)
    assert blob is None
    res, _ = entropy.decode_pack_batch(
        [(sd, wire.dbctl_of(h)) for sd, h in pics * 3], sps, pps, 32,
        [st.views(0, i) for i in range(3)])
    assert (res[:, 0] == -1).all()


def test_multi_slice_pictures_match_the_per_picture_entry():
    """Four copies of a 4-slice picture (16 tasks): each slot holds the
    per-picture entry's bytes; the overflow and exception rows, which
    slices append in the order they finish, as the same sets."""
    pics, sps, pps = _fixture_pictures("slices_qp28")
    n = sps.pic_width_in_mbs * sps.frame_height_in_mbs
    npad = round_up(n, BLK)
    batch = pics * 4
    for n_threads in (1, 4):
        st = wire.Staging(4, npad, n, START, slots=1)
        st.grow((256, 1024, 256), Quiet())
        b = st.bufs[0]
        ctl = wire.dbctl_of(pics[0][1])
        res, (_, peak) = entropy.decode_pack_batch(
            [(sd, ctl) for sd, _ in batch], sps, pps, 256,
            [st.views(0, i) for i in range(4)],
            n_threads=n_threads)
        assert peak <= n_threads
        alone = wire.alloc(1, npad, n, 256, 1024, 256)[1]
        cnt = np.zeros(npad, np.int32)
        _, maxnz, nexc, novf = entropy.decode_pack_picture_islices(
            pics[0][0], sps, pps, 256, ctl, alone["bmp"][0],
            alone["vals"][0], cnt, alone["u8"][0], alone["exc_idx"][0],
            alone["exc_delta"][0], alone["ovf_idx"][0], alone["ovf_rows"][0],
            n_threads=1)
        assert (res[:, :3] == [maxnz, nexc, novf]).all()
        for i in range(4):
            for name in ("bmp", "vals", "u8"):
                assert np.array_equal(b[name][i], alone[name][0]), name
            assert np.array_equal(b["cnt"][i], cnt)

            def rows(view, idx, k):
                return sorted((int(j), view[q].tobytes())
                              for q, j in enumerate(idx[:k]))
            assert rows(b["ovf_rows"][i], b["ovf_idx"][i], novf) == \
                rows(alone["ovf_rows"][0], alone["ovf_idx"][0], novf)
            assert rows(b["exc_delta"][i], b["exc_idx"][i], nexc) == \
                rows(alone["exc_delta"][0], alone["exc_idx"][0], nexc)
            if n_threads == 1:
                for name in ("exc_idx", "exc_delta", "ovf_idx", "ovf_rows"):
                    assert np.array_equal(b[name][i], alone[name][0]), name


@pytest.mark.parametrize("n_threads", [1, 2, 3, 16, 2 * (os.cpu_count() or 1)])
def test_no_more_tasks_than_threads_run_at_once(serial, n_threads):
    """The entry's count of the most tasks in flight never passes
    `n_threads`, also when more threads are asked for than there are
    cores (three batches in a row); the bytes stay the same."""
    st1, blob1 = serial
    st = wire.Staging(len(PICS), NPAD, N, START, slots=1)
    st.grow(st1.caps, Quiet())
    b = st.bufs[0]
    ctls = [wire.dbctl_of(h) for _, h in PICS]
    for _ in range(3):
        res, (task_us, peak) = entropy.decode_pack_batch(
            [(sd, c) for (sd, _), c in zip(PICS, ctls)], SPS, PPS,
            st.caps[0],
            [st.views(0, i) for i in range(len(PICS))],
            n_threads=n_threads)
        assert 1 <= peak <= n_threads and task_us > 0
        assert (res[:, 3] > 0).all()
        assert np.array_equal(b["_blob"], blob1)
    if n_threads == 1:
        assert peak == 1


@pytest.mark.parametrize("n_threads", [1, 4])
def test_counters_of_the_batched_decode(n_threads):
    """Through the entry: par_pictures counts the pictures of batches
    whose first call ran tasks at once (none on one thread), and the
    report's entropy_parallelism is the tasks' time over the entropy and
    redecode stages' wall time."""
    tm = StageTimers()
    gp.decode_annexb_gop_pipelined(INTRA, gop=8, n_threads=n_threads,
                                   device="cpu", stacked_out=True,
                                   timers=tm)
    c = tm.counters
    assert c["frames"] == 16 and c["entropy_task_us"] > 0
    assert c["par_pictures"] in ((0,) if n_threads == 1 else (0, 8, 16))
    r = tm.report()
    wall = tm.t["entropy"] + tm.t["redecode"]
    assert r["entropy_parallelism"] == pytest.approx(
        c["entropy_task_us"] / wall / 1e6, abs=1e-3)
    assert r["entropy_parallelism"] <= n_threads * 1.05
    if n_threads == 1:
        assert r["entropy_parallelism"] <= 1.0


def test_the_wire_views_are_checked():
    st = wire.Staging(1, NPAD, N, START, slots=1)
    views = [st.views(0, 0)]
    with pytest.raises(ValueError):
        entropy.decode_pack_batch([(PICS[0][0], wire.dbctl_of(PICS[0][1]))],
                                  SPS, PPS, 64, views)
