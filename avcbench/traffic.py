"""The one generator of requests: it reads a traffic mix
(``avcbench/traffic/<name>.json``) and a configuration's pool, and deals
the requests of a run from ``--seed``.

Request kinds ("request" in the mix):

- "gop": each request is one whole stream of the pool, byte for byte.  The
  streams are dealt in rounds, each round every stream once in a shuffled
  order, and no stream twice in a row, so every seed sends the same work.
- "idr_stream": each request is a stream of "pictures" IDR pictures of
  the pool behind the pool's parameter sets, idr_pic_id alternating
  (``streams.compose_idr``); positions take turns between the pool's two
  idr_pic_id values, and each position draws from its value's pictures
  in shuffled rounds, so every pool picture appears equally often.  A run
  makes "distinct" such streams and sends them as "gop" sends its
  streams: in shuffled rounds, never the same twice in a row, so that with
  three or more the request two back is sometimes the same and sometimes
  not.

A request's launches of a batched kernel group its pictures by "batch",
the last group padded with its last picture, as the batched entry does.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from pathlib import Path

from .streams import Pool, check_idr_stream, compose_idr, sha256


@dataclass
class Request:
    stream: bytes
    golden: list            # digests of its pictures, display order
    work: dict = field(default_factory=dict)  # kernel -> [(bytes, ops)]


def load_pool(folder: Path, cfg: dict) -> dict:
    """{file: bytes} of the configuration's pool; raises if a file's
    SHA-256 is not the one the configuration states."""
    out = {}
    for p in cfg["pool"]:
        data = (folder / p["file"]).read_bytes()
        if sha256(data) != p["sha256"]:
            raise ValueError(f"{folder / p['file']}: SHA-256 {sha256(data)}"
                             f", the configuration states {p['sha256']}")
        out[p["file"]] = data
    return out


def _launches(per_picture, batch):
    """Per-picture (bytes, ops) grouped into launches of `batch`."""
    out = []
    for b0 in range(0, len(per_picture), batch):
        group = per_picture[b0:b0 + batch]
        group = group + [group[-1]] * (batch - len(group))
        out.append((sum(g[0] for g in group), sum(g[1] for g in group)))
    return out


def _rounds(rng, items):
    """Endless shuffled rounds of `items`, never the same item twice in a
    row where there are two or more."""
    last = None
    while True:
        deck = list(items)
        rng.shuffle(deck)
        if len(deck) > 1 and deck[0] == last:
            deck[0], deck[1] = deck[1], deck[0]
        yield from deck
        last = deck[-1]


class Traffic:
    """The requests of one run: ``distinct`` (each sent, and checked,
    alike), ``index(i)`` the distinct request the i-th request sends, and
    ``sampled(i)`` whether the i-th request's output is compared."""

    def __init__(self, mix: dict, folder: Path, cfg: dict, seed: int):
        self.mix = mix
        rng = random.Random(seed)
        pool = load_pool(folder, cfg)
        golden = json.loads((folder / "golden.json").read_text())
        wpath = folder / "work.json"
        work = json.loads(wpath.read_text()) if wpath.exists() else {}
        batch = mix["batch"]
        if mix["request"] == "gop":
            self.distinct = []
            for name, data in pool.items():
                if len(golden[name]) != mix["pictures"]:
                    raise ValueError(f"{name}: {len(golden[name])} pictures, "
                                     f"the mix asks for {mix['pictures']}")
                w = {k: _launches(v, batch)
                     for k, v in work.get(name, {}).items() if v}
                self.distinct.append(Request(data, golden[name], w))
            order = _rounds(rng, range(len(self.distinct)))
        elif mix["request"] == "idr_stream":
            if len(pool) != 1:
                raise ValueError("an idr_stream mix draws from one stream")
            (name, data), = pool.items()
            p = Pool.parse(data)
            ids = p.idr_ids()
            values = sorted(set(ids))
            if None in values or len(values) != 2:
                raise ValueError(f"{name}: needs IDR pictures of two "
                                 f"idr_pic_id values, has {values}")
            self.distinct = []
            for _ in range(mix["distinct"]):
                draws = [_rounds(rng, [i for i, v in enumerate(ids)
                                       if v == val]) for val in values]
                first = rng.randrange(2)
                order = [next(draws[(first + k) % 2])
                         for k in range(mix["pictures"])]
                stream = compose_idr(p, order)
                if check_idr_stream(stream) != mix["pictures"]:
                    raise ValueError("a composed stream lost pictures")
                w = {k: _launches([v[i] for i in order], batch)
                     for k, v in work.get(name, {}).items() if v}
                self.distinct.append(Request(
                    stream, [golden[name][i] for i in order], w))
            order = _rounds(rng, range(len(self.distinct)))
        else:
            raise ValueError(f"unknown request kind {mix['request']!r}")
        self._order = order
        self._seq = []
        self._offset = rng.randrange(mix["check_every"])

    def index(self, i: int) -> int:
        while len(self._seq) <= i:
            self._seq.append(next(self._order))
        return self._seq[i]

    def sampled(self, i: int) -> bool:
        return i % self.mix["check_every"] == self._offset
