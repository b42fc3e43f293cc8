"""Emulation-prevention removal (spec 7.4.1.1, 00 00 03 -> 00 00) in the
port: ``bitio.strip_emulation_prevention`` gives the JAX package's bytes
on every NAL payload of the benchmark's pools and of the conformance
streams, on hand cases and on seeded random payloads; ``split_annexb``
gives the same NAL units; the batched entry's parse of the pools and
both decode entries strip each slice NAL's whole payload once a call and
count the bytes removed as ``epb_bytes``; the entries' pictures keep
their digests.  The decodes run on the harness's tiny intra stream: a
1080p GOP takes minutes on the CPU's plain kernels."""
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import dryv_tpu_torch.avc.nal as tnal
import dryv_tpu_torch.bitio as tbitio
from avcbench.check import digest
from dryv_tpu import bitio as jbitio
from dryv_tpu import decoder as jdecoder
from dryv_tpu.avc import split_annexb as jsplit
from dryv_tpu_torch import decoder as tdecoder
from dryv_tpu_torch import device_ipb_packed, gop_pipeline
from dryv_tpu_torch.avc import NalUnitType, split_annexb, to_annexb
from dryv_tpu_torch.utils.obs import StageTimers
from dryv_tpu_torch import wire

ROOT = Path(__file__).resolve().parent.parent
POOLS = ROOT / "avcbench" / "configs"
POOL_STREAMS = sorted(POOLS.glob("*/*.264"))
STREAMS = POOL_STREAMS + sorted(
    (ROOT / "tests" / "conformance").glob("*.264"))
SLICES = (NalUnitType.IDR_SLICE, NalUnitType.NON_IDR_SLICE)

HAND = {
    "empty": b"",
    "escape_alone": b"\x00\x00\x03",
    "trailing_escape": b"\x65\x88\x84\x00\x00\x03",
    "cabac_zero_words": b"\x80" + b"\x00\x00\x03" * 4,
    "back_to_back": b"\x00\x00\x03\x00\x00\x03",
    "escape_then_03": b"\x00\x00\x03\x03",
    "three_zeros": b"\x00\x00\x00\x03",
    "03_first": b"\x03\x00\x00\x03\x01",
    "one_zero": b"\x00\x03\x00\x03",
    "escape_in_zero_run": b"\x00\x00\x03\x00\x03\x00\x00\x00\x03\x00",
    # 00 00 03 at bytes 30-32, 31-33 and 29-31 of the payload: across and
    # at the end of the prefix the access-unit grouping strips
    "prefix_split_30": b"\x88" * 30 + b"\x00\x00\x03\x01" + b"\x11" * 8,
    "prefix_split_31": b"\x88" * 31 + b"\x00\x00\x03\x01" + b"\x11" * 8,
    "prefix_end_29": b"\x88" * 29 + b"\x00\x00\x03\x01" + b"\x11" * 8,
}


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): a staging kept from an earlier test would start
    a decode at the caps that test grew to, not at the entry's start
    caps, and so change its steps' keys."""
    wire.release()
    yield
    wire.release()


def _random_payloads(seed, n=2000):
    rng = random.Random(seed)
    return [bytes(rng.choice(b"\x00\x01\x03\xff")
                  for _ in range(rng.randrange(0, 80))) for _ in range(n)]


def _cases():
    for path in STREAMS:
        yield pytest.param(("stream", path), id=path.name)
    for name in HAND:
        yield pytest.param(("hand", name), id=name)
    for seed in (0, 1, 2**31 + 7):
        yield pytest.param(("random", seed), id=f"random{seed}")


def _payloads(kind, what):
    if kind == "hand":
        return [HAND[what]]
    if kind == "random":
        return _random_payloads(what)
    stream = what.read_bytes()
    port, jax = list(split_annexb(stream)), list(jsplit(stream))
    assert [(n.ref_idc, int(n.type), n.payload) for n in port] == \
        [(n.ref_idc, int(n.type), n.payload) for n in jax]
    assert all(type(n.payload) is bytes for n in port)
    return [n.payload for n in port]


@pytest.mark.parametrize("case", _cases())
def test_strip_equals_the_jax_package(case):
    """The same bytes, as bytes, as the JAX package's byte loop; the
    input itself back where there is nothing to strip; the strip of any
    prefix a prefix of the whole strip."""
    for data in _payloads(*case):
        got = tbitio.strip_emulation_prevention(data)
        want = jbitio.strip_emulation_prevention(data)
        assert type(got) is bytes and got == want, data
        if b"\x00\x00\x03" not in data:
            assert got is data
        for k in (1, 2, 3, 31, 32, 33):
            assert want.startswith(tbitio.strip_emulation_prevention(
                data[:k]))


@pytest.mark.parametrize("case", [
    pytest.param(("stream", p), id=p.name) for p in POOL_STREAMS] + [
    pytest.param(("hand", n), id=n) for n in HAND if n.startswith("prefix")])
def test_first_mb_from_a_prefix(case):
    """first_mb_in_slice == 0 read from the payload's stripped prefix as
    from the JAX package's whole RBSP (the pools' slices, and slices
    whose first_mb_in_slice is 0 and 1 before a prefix-boundary
    escape)."""
    kind, what = case
    if kind == "hand":
        nals = [tnal.NalUnit(3, NalUnitType.IDR_SLICE, lead + HAND[what])
                for lead in (b"\xb8", b"\x48")]
    else:
        nals = [n for n in split_annexb(what.read_bytes())
                if n.type in SLICES]
    assert nals
    for nal in nals:
        assert tdecoder._first_mb_is_zero(nal) == \
            jdecoder._first_mb_is_zero(nal)


@pytest.fixture
def one_thread():
    """One torch thread for the CPU decodes: the plain kernels issue many
    small ops, which a thread pool per test worker only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _counted_strips(monkeypatch):
    """Every payload handed to the strip, through either name it has."""
    seen = []
    strip = tbitio.strip_emulation_prevention

    def counted(data):
        seen.append(data)
        return strip(data)

    monkeypatch.setattr(tbitio, "strip_emulation_prevention", counted)
    monkeypatch.setattr(tnal, "strip_emulation_prevention", counted)
    return seen


def _digests(frames):
    return [digest(*(np.asarray(p) for p in (f.y, f.cb, f.cr)))
            for f in frames]


def _pictures(stream, keep):
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


def _parse(stream, tm):
    gop_pipeline._parse_pictures(stream, tm)
    return None


def _batched(stream, tm):
    return gop_pipeline.decode_annexb_gop_pipelined(
        stream, gop=16, n_threads=1, device="cpu", timers=tm)


def _ipb(stream, tm):
    return device_ipb_packed.decode_annexb_device_packed(
        stream, n_threads=1, device="cpu", timers=tm)


TINY = ROOT / "avcbench" / "tests" / "configs" / "tiny-intra"


@pytest.mark.parametrize("folder,name,keep,call,epb", [
    # the benchmark's pools through the batched entry's parse: 2 of the
    # intra pool's 8 slices and 1 of gop_s9's 10 hold one escape each
    (POOLS / "x264-intra-1080p", "idr8_s100.264", None, _parse, 2),
    (POOLS / "x264-ipb-1080p", "gop_s9.264", None, _parse, 1),
    # both entries, decoding (the last of the 16 slices holds an escape)
    (TINY, "idr16_s3.264", None, _batched, 1),
    (TINY, "idr16_s3.264", (14, 15), _ipb, 1),
], ids=["parse-intra-pool", "parse-ipb-pool", "batched-entry",
        "ipb-entry"])
def test_one_strip_per_slice_nal(folder, name, keep, call, epb,
                                 monkeypatch, one_thread):
    """Each slice NAL's whole payload is stripped once a call, the
    access-unit grouping reading first_mb_in_slice from a prefix;
    epb_bytes counts the bytes removed; the decoded pictures equal the
    configuration's digests."""
    stream = (folder / name).read_bytes()
    if keep is not None:
        stream = _pictures(stream, keep)
    seen = _counted_strips(monkeypatch)
    tm = StageTimers()
    frames = call(stream, tm)
    whole = [n.payload for n in split_annexb(stream) if n.type in SLICES]
    for payload in whole:
        assert sum(s == payload for s in seen) == 1
    # the rest: parameter sets and the grouping's prefixes
    assert all(len(s) <= 32 for s in seen if s not in set(whole))
    assert tm.counters["epb_bytes"] == epb
    if frames is not None:
        golden = json.loads((folder / "golden.json").read_text())[name]
        assert _digests(frames) == [golden[i] for i in keep or range(16)]
