"""The traffic generator: the same seed gives the same requests, every
seed sends the same work in another order, composed intra streams keep
idr_pic_id alternating, and a request's launches group its pictures as
the batched entry does."""
import json
from collections import Counter

import pytest

from conftest import ROOT

from avcbench.streams import Pool, check_idr_stream, compose_idr
from avcbench.traffic import Traffic, _launches

CONFIGS = ROOT / "avcbench" / "configs"
BIG = 2 ** 31 + 12345


def traffic(config, mix, seed, **over):
    folder = CONFIGS / config
    cfg = json.loads((folder / "config.json").read_text())
    m = json.loads((ROOT / "avcbench" / "traffic" / f"{mix}.json")
                   .read_text())
    m.update(over)
    return Traffic(m, folder, cfg, seed)


def sequence(t, n):
    return [t.index(i) for i in range(n)]


@pytest.mark.parametrize("config,mix", [("x264-ipb-1080p", "gop10"),
                                        ("x264-intra-1080p", "stream128")])
def test_deterministic_per_seed(config, mix):
    a, b = traffic(config, mix, BIG), traffic(config, mix, BIG)
    assert sequence(a, 50) == sequence(b, 50)
    assert [r.stream for r in a.distinct] == [r.stream for r in b.distinct]
    assert [a.sampled(i) for i in range(50)] == \
        [b.sampled(i) for i in range(50)]


def test_gop_rounds_balance_and_never_repeat():
    seqs = [sequence(traffic("x264-ipb-1080p", "gop10", s), 300)
            for s in (1, 2, BIG)]
    assert len({tuple(s) for s in seqs}) == 3
    for s in seqs:
        assert all(x != y for x, y in zip(s, s[1:]))
        assert set(Counter(s).values()) == {100}


def test_gop_request_is_the_pool_stream():
    t = traffic("x264-ipb-1080p", "gop10", 7)
    folder = CONFIGS / "x264-ipb-1080p"
    cfg = json.loads((folder / "config.json").read_text())
    assert [r.stream for r in t.distinct] == \
        [(folder / p["file"]).read_bytes() for p in cfg["pool"]]
    assert all(len(r.golden) == 10 and len(r.work["b2"]) == 10
               and len(r.work["b3"]) == 10 for r in t.distinct)


def test_intra_streams_alternate_and_balance():
    t1, t2 = (traffic("x264-intra-1080p", "stream128", s) for s in (3, BIG))
    golden = json.loads((CONFIGS / "x264-intra-1080p" / "golden.json")
                        .read_text())["idr8_s100.264"]
    for t in (t1, t2):
        seq = sequence(t, 300)
        assert len(t.distinct) == 3 and set(Counter(seq).values()) == {100}
        assert all(x != y for x, y in zip(seq, seq[1:]))
        for r in t.distinct:
            assert check_idr_stream(r.stream) == 128
            counts = Counter(golden.index(g) for g in r.golden)
            assert set(counts.values()) == {16} and len(counts) == 8
            assert len(r.work["b2"]) == 8
    assert t1.distinct[0].stream != t2.distinct[0].stream
    assert len({r.stream for r in t1.distinct}) == 3


@pytest.mark.parametrize("config,mix", [("x264-ipb-1080p", "gop10"),
                                        ("x264-intra-1080p", "stream128")])
def test_two_back_is_sometimes_the_same_request(config, mix):
    """An answer stale by two requests is right only now and then."""
    seq = sequence(traffic(config, mix, BIG), 300)
    same = [a == b for a, b in zip(seq, seq[2:])]
    assert 0 < sum(same) < len(same) / 2


def slices(picture):
    return [n for n in picture if n[0] & 0x1F in (1, 5)]


def test_composed_stream_holds_its_pictures():
    """Each picture of a composed stream has its pool picture's slices."""
    t = traffic("x264-intra-1080p", "stream128", 11)
    pool = Pool.parse((CONFIGS / "x264-intra-1080p" / "idr8_s100.264")
                      .read_bytes())
    golden = json.loads((CONFIGS / "x264-intra-1080p" / "golden.json")
                        .read_text())["idr8_s100.264"]
    r = t.distinct[0]
    order = [golden.index(g) for g in r.golden]
    assert [slices(p) for p in Pool.parse(r.stream).pictures] == \
        [slices(pool.pictures[i]) for i in order]
    with pytest.raises(ValueError, match="idr_pic_id"):
        compose_idr(pool, [0, 2])


def test_sampled_every_nth():
    t = traffic("x264-ipb-1080p", "gop10", 5)
    hits = [i for i in range(160) if t.sampled(i)]
    assert len(hits) == 10 and all(b - a == 16 for a, b in
                                   zip(hits, hits[1:]))


def test_launches_group_and_pad():
    pics = [(1.0, 10), (2.0, 20), (3.0, 30)]
    assert _launches(pics, 1) == [(1.0, 10), (2.0, 20), (3.0, 30)]
    assert _launches(pics, 2) == [(3.0, 30), (6.0, 60)]


def test_hash_mismatch_is_refused(tmp_path):
    folder = CONFIGS / "x264-ipb-1080p"
    cfg = json.loads((folder / "config.json").read_text())
    cfg["pool"][0]["sha256"] = "0" * 64
    m = json.loads((ROOT / "avcbench" / "traffic" / "gop10.json").read_text())
    with pytest.raises(ValueError, match="SHA-256"):
        Traffic(m, folder, cfg, 1)
