"""The staging keep (``wire.StagingKeep``, the process's ``wire.KEEP``)
that both decode entries take their host staging from and give it back
to, on the CPU with the benchmark's tiny streams
(``avcbench/tests/configs``): a second call of a key starts at the caps
the first grew to, so it decodes and packs every picture once, with the
first call's step keys, wire bytes and planes; a light stream after a
heavy one of its geometry packs at the heavy caps and decodes exactly,
and one that fits the start caps leaves its key empty, so the next
call starts at them; ``wire.fits`` is each entry's growth rule at the
start caps; callers at once hold stagings of their own; other keys get
their own staging, the least recently used past the bound released;
``release`` empties the keep."""
import contextlib
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from avcbench.check import digest
from dryv_tpu_torch import device_ipb_packed, gop_pipeline, graphs, wire
from dryv_tpu_torch.avc import NalUnitType, split_annexb, to_annexb
from dryv_tpu_torch.utils.obs import StageTimers

CONFIGS = Path(__file__).resolve().parent.parent / "avcbench" / "tests" \
    / "configs"
SLICES = (NalUnitType.IDR_SLICE, NalUnitType.NON_IDR_SLICE)
# seconds the threaded tests wait on each other before they call it a
# hang: far above a tiny decode on a host loaded by parallel test runs
HANG = 600


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): each test counts the stagings the keep holds and
    the calls that took a kept one."""
    wire.release()
    yield
    wire.release()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny decodes here gain nothing from torch's thread pool, which
    would take the cores of the tests that run beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batched(stream, tm):
    return gop_pipeline.decode_annexb_gop_pipelined(
        stream, gop=4, n_threads=2, device="cpu", timers=tm)


def _ipb(stream, tm):
    return device_ipb_packed.decode_annexb_device_packed(
        stream, n_threads=2, device="cpu", timers=tm)


# stream: (the entry that takes it, the pictures of it decoded, whether
# they are its first in display order too); the first picture of each
# grows a staging from its entry's start caps; the intra stream's four
# are one batch
STREAMS = {"tiny-intra/idr16_s3.264": (_batched, 4, True),
           "tiny-ipb/gop_s1.264": (_ipb, 2, False),
           "tiny-live/live_s2.264": (_ipb, 3, True)}


def _stream(path):
    """The stream's bytes, cut to its first pictures as ``STREAMS``
    says (a picture starts at a slice with first_mb_in_slice 0: its
    RBSP's first bit set)."""
    stream = (CONFIGS / path).read_bytes()
    k = STREAMS[path][1]
    out, pic = [], 0
    for nal in split_annexb(stream):
        if nal.type in SLICES and nal.rbsp[0] & 0x80:
            pic += 1
            if pic > k:
                break
        out.append(nal)
    return to_annexb(out)


def _golden(path):
    """The digests of the pictures ``_stream`` keeps, or None where they
    are not the stream's first in display order."""
    folder, name = path.split("/")
    _, k, first = STREAMS[path]
    if not first:
        return None
    return json.loads((CONFIGS / folder / "golden.json").read_text())[
        name][:k]


def _digests(frames):
    return [digest(*(np.asarray(p) for p in (f.y, f.cb, f.cr)))
            for f in frames]


def _call(decode, stream, monkeypatch):
    """decode(stream, tm) with a StageTimers; returns the timers, the
    frames' digests and each step load's key and blob bytes."""
    keys = []
    load = graphs.Step.load

    def recorded(self, *xs):
        keys.append((self.key, xs[0].numel()))
        return load(self, *xs)

    monkeypatch.setattr(graphs.Step, "load", recorded)
    tm = StageTimers()
    frames = decode(stream, tm)
    monkeypatch.setattr(graphs.Step, "load", load)
    return tm, _digests(frames), keys


def _idr_pictures(stream, keep):
    """The IDR pictures `keep` of an all-intra stream, each after its own
    parameter sets."""
    out, params, pic = [], [], -1
    for nal in split_annexb(stream):
        if nal.type in SLICES:
            pic += 1
            if pic in keep:
                out += params + [nal]
            params = []
        else:
            params.append(nal)
    return to_annexb(out)


@pytest.mark.parametrize("path", sorted(STREAMS))
def test_second_call_starts_from_the_grown_staging(path, monkeypatch):
    """From an emptied keep the first call grows its staging; the second
    takes it back: no retry, no redecode, the first call's step keys and
    wire bytes, and the same planes, equal to the digests."""
    stream = _stream(path)
    decode = STREAMS[path][0]
    tm1, planes1, keys1 = _call(decode, stream, monkeypatch)
    assert tm1.counters["retries"] >= 1 and tm1.counters["staging_kept"] == 0
    assert len(wire.KEEP.idle) == 1
    tm2, planes2, keys2 = _call(decode, stream, monkeypatch)
    assert tm2.counters["retries"] == 0 and "redecode" not in tm2.n
    assert tm2.counters["staging_kept"] == 1
    assert keys2 == keys1
    assert tm2.counters["wire_bytes"] == tm1.counters["wire_bytes"]
    assert planes2 == planes1 == (_golden(path) or planes1)
    assert len(wire.KEEP.idle) == 1


@pytest.mark.parametrize("heavy,light,keep,decode", [
    ("tiny-ipb/gop_s1.264", "tiny-live/live_s2.264", None, _ipb),
    ("tiny-intra/idr16_s3.264", "tiny-intra/idr16_s3.264", [1, 3],
     _batched),
], ids=["ipb-then-live", "intra-then-two-pictures"])
def test_light_stream_after_a_heavy_one_decodes_at_the_kept_caps(
        heavy, light, keep, decode, monkeypatch):
    """A stream that alone grows past the start caps, but less, after
    one of its geometry that grew more: it packs at the kept (larger)
    caps with no retry and its planes are exact; alone, from an emptied
    keep, it reaches smaller caps."""
    light_stream, want = _stream(light), _golden(light)
    if keep is not None:
        light_stream = _idr_pictures(light_stream, keep)
        want = [want[i] for i in keep]
    _, _, alone = _call(decode, light_stream, monkeypatch)
    wire.release()
    _, _, heavy_keys = _call(decode, _stream(heavy), monkeypatch)
    tm, planes, keys = _call(decode, light_stream, monkeypatch)
    caps = {key[7:10] for key, _ in keys}
    assert caps == {key[7:10] for key, _ in heavy_keys}
    assert caps != {key[7:10] for key, _ in alone}
    assert tm.counters["retries"] == 0 and tm.counters["staging_kept"] == 1
    assert planes == want


def test_a_stream_that_fits_the_start_caps_leaves_its_key_empty(
        monkeypatch):
    """The tiny streams' pictures all outgrow the I/P/B entry's start
    caps; started at W 128, the live stream's first pictures fit them
    and the ipb stream's do not.  After the ipb stream the live one
    packs at the kept caps, exactly, and leaves its key empty, so the
    next call starts at the start caps with the step keys and wire
    bytes of the live stream's call alone."""
    start = (128, 1024, 256)
    monkeypatch.setattr(device_ipb_packed, "START_CAPS", start)
    light, want = _stream("tiny-live/live_s2.264"), \
        _golden("tiny-live/live_s2.264")
    tm, planes, alone = _call(_ipb, light, monkeypatch)
    assert tm.counters["retries"] == 0 and planes == want
    assert {key[7:10] for key, _ in alone} == {start}
    assert len(wire.KEEP.idle) == 1
    tm, _, heavy = _call(_ipb, _stream("tiny-ipb/gop_s1.264"), monkeypatch)
    grown = heavy[-1][0][7:10]
    assert tm.counters["retries"] >= 1 and grown != start
    tm, planes, keys = _call(_ipb, light, monkeypatch)
    assert tm.counters["staging_kept"] == 1 and planes == want
    assert {key[7:10] for key, _ in keys} == {grown}
    assert not wire.KEEP.idle
    tm, planes, keys = _call(_ipb, light, monkeypatch)
    assert tm.counters["staging_kept"] == 0 and tm.counters["retries"] == 0
    assert keys == alone and planes == want
    assert len(wire.KEEP.idle) == 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("entry", ["batched", "ipb"])
def test_fits_is_each_entrys_rule_at_its_start_caps(entry, seed):
    """Pictures of random per-MB value counts, packed at a grown W:
    ``wire.fits`` at the entry's start caps, from the counts there, says
    whether the entry's rule (``_needs``) would grow a staging at the
    start caps for them, from the counts at the start W."""
    rng = np.random.default_rng(seed)
    npad, n = 256, 240
    start = (gop_pipeline if entry == "batched" else
             device_ipb_packed).START_CAPS
    seen = set()
    for _ in range(300):
        nnz = rng.integers(0, start[0] + 1, n)
        over = rng.choice(n, rng.integers(0, 24), replace=False)
        nnz[over] = rng.integers(start[0] + 1, 409, len(over))
        maxnz, novf0 = int(nnz.max()), int((nnz > start[0]).sum())
        if entry == "batched":
            caps, redo = gop_pipeline._needs(
                start, npad, [0], np.array([[maxnz, 0, novf0, 0]]))
            want = caps == start and not redo
        else:
            want = device_ipb_packed._needs(start, maxnz, 0, novf0,
                                            npad) is None
        W = int(rng.choice([64, 128, 256]))
        cnt = np.where(nnz <= W, nnz, 0).astype(np.int32)
        got = wire.fits(start, npad, cnt, maxnz, 0, int((nnz > W).sum()))
        assert got == want, (maxnz, novf0, W)
        seen.add(got)
        # exceptions past the start's ecap never fit
        assert not wire.fits(start, npad, cnt, maxnz, start[1] + 1,
                             int((nnz > W).sum()))
    assert seen == {True, False}


def test_a_call_that_fit_the_start_caps_leaves_its_key_empty():
    """A call on a grown staging whose every picture fits the start caps
    (``Staging.note``) gives it back to no key; one with a picture that
    does not, or one that never left the start caps, is kept."""
    keep = wire.StagingKeep()
    start, npad, n = gop_pipeline.START_CAPS, 256, 240
    st = keep.take("cpu", 1, npad, n, start, Quiet())
    st.grow((256, 256, 64), Quiet())
    assert not st.light
    keep.give_back("cpu", st)
    assert list(keep.idle.values()) == [st]

    def call(counts):
        """A call of one picture on the key's staging, its MBs holding
        `counts` values (all fit the kept W)."""
        got = keep.take("cpu", 1, npad, n, start, Quiet())
        assert got.light
        got.bufs[0]["cnt"][0, :n] = counts
        got.note(0, 0, int(np.max(counts)), 0, 0)
        keep.give_back("cpu", got)
        return got

    dense = np.full(n, 100)
    assert call(dense) is st and not st.light
    assert list(keep.idle.values()) == [st]
    # one MB past the start W: not dense, and its row fits ovcap
    sparse = np.full(n, 20)
    sparse[7] = 200
    assert call(sparse) is st and st.light
    assert not keep.idle
    # a new staging at the start caps, light, is kept
    fresh = call(sparse)
    assert fresh is not st and fresh.caps == start and fresh.light
    assert list(keep.idle.values()) == [fresh]


def test_callers_at_once_hold_stagings_of_their_own(monkeypatch):
    """Two threads decode one intra stream at once, one staging kept for
    its key: each holds its own staging (one the kept, one new) while
    both are inside the call, and both decode exactly.  The batched
    entry takes its staging before any native call; the native
    entropy's arenas serve one caller at a time, so the rest of each
    call takes turns."""
    path = "tiny-intra/idr16_s3.264"
    stream = _stream(path)
    _call(_batched, stream, monkeypatch)
    kept = next(iter(wire.KEEP.idle.values()))
    both = threading.Barrier(2, timeout=HANG)
    turn = threading.Lock()
    taken, out = [], {}
    take, give_back = wire.take, wire.give_back

    def take_at_once(*args, **kw):
        st = take(*args, **kw)
        taken.append(st)
        both.wait()             # both callers hold a staging here
        assert turn.acquire(timeout=HANG)
        return st

    def give_back_in_turn(device, st):
        give_back(device, st)
        turn.release()

    monkeypatch.setattr(wire, "take", take_at_once)
    monkeypatch.setattr(wire, "give_back", give_back_in_turn)

    def run(i):
        tm = StageTimers()
        out[i] = (_digests(_batched(stream, tm)),
                  tm.counters["staging_kept"])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HANG)
    assert not any(t.is_alive() for t in threads)
    assert len(taken) == 2 and taken[0] is not taken[1]
    assert kept in taken
    assert sorted(kept for _, kept in out.values()) == [0, 1]
    assert out[0][0] == out[1][0] == _golden(path)
    # one idle staging a key
    assert len(wire.KEEP.idle) == 1


class Quiet:
    """The ``timers=`` protocol, keeping nothing."""

    def stage(self, name):
        return contextlib.nullcontext()

    def count(self, name, v):
        pass


def test_each_key_has_its_own_staging_and_the_oldest_goes():
    """Another geometry, batch size, entry (n4) or device gets a staging
    of its own; past ``KEEP_KEYS`` keys the least recently given
    back is released; a key taken again is the most recent."""
    keep = wire.StagingKeep()
    start = gop_pipeline.START_CAPS
    keys = [("cpu", 2, 128, 40, start, 0), ("cpu", 2, 256, 160, start, 0),
            ("cpu", 4, 128, 40, start, 0), ("meta", 4, 128, 40, start, 0),
            ("cpu", 1, 128, 40, device_ipb_packed.START_CAPS, 640)]
    assert len(keys) == wire.KEEP_KEYS + 1
    sts = []
    for dev, F, npad, n, caps, n4 in keys:
        st = keep.take(dev, F, npad, n, caps, Quiet(), n4=n4)
        assert all(st is not o for o in sts)
        sts.append(st)
    for (dev, *_), st in zip(keys, sts[:-1]):
        keep.give_back(dev, st)
    assert list(keep.idle.values()) == sts[:-1]
    # the first key, taken again, is its kept staging and then the newest
    dev, F, npad, n, caps, n4 = keys[0]
    assert keep.take(dev, F, npad, n, caps, Quiet(), n4=n4) is sts[0]
    keep.give_back("cpu", sts[0])
    keep.give_back("cpu", sts[-1])
    # past KEEP_KEYS keys the least recently given back (the second) goes
    assert list(keep.idle.values()) == [*sts[2:-1], sts[0], sts[-1]]
    dev, F, npad, n, caps, n4 = keys[1]
    assert keep.take(dev, F, npad, n, caps, Quiet(), n4=n4) is not sts[1]


def test_take_counts_a_kept_staging_and_keeps_its_caps():
    keep = wire.StagingKeep()
    counted = []

    class Count(Quiet):
        def count(self, name, v):
            counted.append((name, v))

    st = keep.take("cpu", 2, 128, 40, (32, 256, 64), Count())
    assert counted == [] and st.caps == (32, 256, 64)
    st.grow((64, 512, 128), Quiet())
    keep.give_back("cpu", st)
    again = keep.take("cpu", 2, 128, 40, (32, 256, 64), Count())
    assert again is st and again.caps == (64, 512, 128)
    assert counted == [("staging_kept", 1)]
    assert not keep.idle


def test_release_empties_the_keep(monkeypatch):
    """After ``release`` the key of a grown staging gives a new one at
    the start caps."""
    _call(_batched, _stream("tiny-intra/idr16_s3.264"), monkeypatch)
    (key, st), = wire.KEEP.idle.items()
    assert st.caps != st.start
    wire.release()
    assert not wire.KEEP.idle
    dev, F, npad, n, n4, pin = key
    again = wire.take(dev, F, npad, n, gop_pipeline.START_CAPS, Quiet(),
                      n4=n4, pin=pin)
    assert again is not st and again.caps == gop_pipeline.START_CAPS


def test_no_staging_is_held_twice_under_contention():
    """Many threads take and give back stagings of two keys as fast as
    they can, with the interpreter switching threads often: no staging
    is ever held by two of them at once, and the keep ends with one idle
    staging a key."""
    keep = wire.StagingKeep()
    held, book, errors = set(), threading.Lock(), []

    def work(i):
        try:
            for j in range(100):
                n = 40 if (i + j) % 2 else 80
                st = keep.take("cpu", 1, 128, n, (32, 256, 64), Quiet())
                with book:
                    assert id(st) not in held
                    held.add(id(st))
                with book:
                    held.discard(id(st))
                keep.give_back("cpu", st)
        except Exception as e:      # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HANG)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(keep.idle) == 2
