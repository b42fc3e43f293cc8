"""Seeded motion fields with H.264 macroblock layouts, for kernel B4
(``kernels.inter.mc_frame``) and its tests.

Random per-block vectors give every 4x4 block a window of its own; real
pictures do not.  ``partitioned_field`` draws MB layouts as an encoder
emits them: intra, skip (P_Skip: 16x16 list 0 reference 0; B_Skip:
direct 8x8 quadrants, mostly one vector), 16x16, 16x8, 8x16 and 8x8 with
8x8/8x4/4x8/4x4 sub-partitions, mixed within a picture.  A partition of a
B picture predicts from list 0, list 1 or both; sub-partitions share
their 8x8's direction and references but not their vectors.  A quarter
of the partitions repeat the previous one's references and vectors, so
blocks of several partitions share one (slot, vector), in shapes other
than rectangles.  Vectors stay near their block or reach past an edge of the
plane.  ``mb_groups`` finds, per MB and list, the groups of blocks that
share (slot, vector): the units in which B4's operation bound counts
each half-sample intermediate once (``chip_smoke.b4_bound``);
``group_census`` and ``full_pel_census`` describe a picture's motion by
its groups per MB and by how much of it is full-pel.
"""
from __future__ import annotations

import numpy as np

KINDS = ("intra", "skip", "16x16", "16x8", "8x16", "8x8")
SUB_KINDS = ("8x8", "8x4", "4x8", "4x4")


def _mask(bx, by, w, h):
    """Bits 4 * y + x of the w x h blocks at (bx, by) of an MB."""
    return sum(1 << (4 * (by + j) + bx + i) for j in range(h)
               for i in range(w))


def _quadrant(q):
    return 2 * (q & 1), 2 * (q >> 1)


def _partitions(kind, rng):
    """[(mask, sub-masks)] of one MB: a partition predicts in one
    direction from one reference per list; each sub-mask has its own
    vector."""
    if kind in ("skip", "16x16"):
        return [(0xFFFF, [0xFFFF])]
    if kind == "16x8":
        return [(_mask(0, y, 4, 2), [_mask(0, y, 4, 2)]) for y in (0, 2)]
    if kind == "8x16":
        return [(_mask(x, 0, 2, 4), [_mask(x, 0, 2, 4)]) for x in (0, 2)]
    out = []
    for q in range(4):
        x, y = _quadrant(q)
        sub = SUB_KINDS[rng.integers(0, 4)]
        w, h = {"8x8": (2, 2), "8x4": (2, 1), "4x8": (1, 2),
                "4x4": (1, 1)}[sub]
        subs = [_mask(x + i, y + j, w, h) for j in range(0, 2, h)
                for i in range(0, 2, w)]
        out.append((_mask(x, y, 2, 2), subs))
    return out


def _vector(rng, px, py, W, H, p_edge):
    """A quarter-pel vector for the block area at (px, py): near it, or
    with probability p_edge to a spot up to 24 samples past an edge."""
    if rng.random() >= p_edge:
        return rng.integers(-64, 65, 2)
    tx = rng.choice([rng.integers(-24, 0), rng.integers(W - 8, W + 24),
                     px + rng.integers(-16, 17)])
    ty = rng.choice([rng.integers(-24, 0), rng.integers(H - 8, H + 24),
                     py + rng.integers(-16, 17)])
    return np.array([4 * (tx - px), 4 * (ty - py)]) + rng.integers(0, 4, 2)


def partitioned_field(rng, mb_w, mb_h, R, nlists, kinds=KINDS, p_edge=0.3,
                      n_ref=(3, 2)):
    """A motion field of MB layouts drawn from `kinds` (one per MB,
    uniformly), on the packed wire's fields in raster 4x4 block order:
    {"rs0", "rs1", "ri0", "ri1": int8 [n4] (slot and reference index,
    -1 where the list is unused), "mv0", "mv1": int16 [n4, 2] quarter-pel
    (x, y), "kind": [n] the MB kinds}.  A P picture (nlists 1) uses
    list 0 only.  Reference index i of list l reads stack slot
    ``slot_of[l][i]``, a fixed draw below R; n_ref bounds the indices."""
    n = mb_w * mb_h
    W, H = 16 * mb_w, 16 * mb_h
    slot_of = rng.integers(0, R, (2, max(n_ref)))
    rs = np.full((2, n, 16), -1, np.int64)
    ri = np.full((2, n, 16), -1, np.int64)
    mv = np.zeros((2, n, 16, 2), np.int64)
    kind = rng.choice(kinds, n)
    for a in range(n):
        mbx, mby = a % mb_w, a // mb_w
        if kind[a] == "intra":
            continue
        prev = None        # (lists, refs, vector) of the last unit
        shared = kind[a] == "skip" and nlists == 2 and rng.random() < 0.7
        for _, subs in _partitions(kind[a], rng):
            if prev is not None and (shared or rng.random() < 0.25):
                lists, refs = prev[:2]
            elif kind[a] == "skip" and nlists == 1:
                lists, refs = (0,), (0, 0)
            else:
                lists = ((0,), (1,), (0, 1))[rng.integers(0, 3)] \
                    if nlists == 2 else (0,)
                refs = (rng.integers(0, n_ref[0]), rng.integers(0, n_ref[1]))
            for m in subs:
                blocks = [k for k in range(16) if m >> k & 1]
                if prev is not None and prev[:2] == (lists, refs) and (
                        shared or rng.random() < 0.25):
                    vec = prev[2]
                else:
                    px = 16 * mbx + 4 * min(k & 3 for k in blocks)
                    py = 16 * mby + 4 * min(k >> 2 for k in blocks)
                    vec = [_vector(rng, px, py, W, H, p_edge)
                           for _ in range(2)]
                prev = lists, refs, vec
                for l in lists:
                    rs[l, a, blocks] = slot_of[l, refs[l]]
                    ri[l, a, blocks] = refs[l]
                    mv[l, a, blocks] = vec[l]

    def raster(x):       # [n, 16, ...] MB order -> [n4, ...] raster
        return x.reshape(mb_h, mb_w, 4, 4, *x.shape[2:]).swapaxes(1, 2) \
            .reshape(16 * n, *x.shape[2:])

    return {"rs0": raster(rs[0]).astype(np.int8),
            "rs1": raster(rs[1]).astype(np.int8),
            "ri0": raster(ri[0]).astype(np.int8),
            "ri1": raster(ri[1]).astype(np.int8),
            "mv0": raster(mv[0]).astype(np.int16),
            "mv1": raster(mv[1]).astype(np.int16), "kind": kind}


def mb_groups(rs, mv, mb_w, mb_h):
    """The groups of one list: per MB, the blocks that use the list with
    one (slot, vector).  rs [n4] slots (-1 unused), mv [n4, 2], raster
    4x4 block order.  Returns (mb [g], mask [g]: bits 4 * y + x of the
    group's blocks in its MB, vector [g, 2]), in MB order."""
    n = mb_w * mb_h

    def per_mb(x):
        return np.asarray(x).reshape(mb_h, 4, mb_w, 4, *np.shape(x)[1:]) \
            .swapaxes(1, 2).reshape(n, 16, *np.shape(x)[1:])

    r = per_mb(rs).astype(np.int64)
    v = per_mb(mv).astype(np.int64)
    key = np.where(r >= 0, r << 32 | (v[..., 0] & 0xFFFF) << 16
                   | (v[..., 1] & 0xFFFF), -1)
    bits = 1 << np.arange(16)
    mask = ((key[:, :, None] == key[:, None, :]) * bits).sum(-1)
    lead = (r >= 0) & ((mask & -mask) == bits)
    mb, k = np.nonzero(lead)
    return mb, mask[mb, k], v[mb, k]


def group_census(lists, mb_w, mb_h):
    """Inter MBs by their number of groups over all lists: {"1": .., "2":
    .., "3": .., "4": .., ">4": ..}, and the intra MBs (no group) under
    "0".  lists: [(rs, mv)] per list."""
    per = np.zeros(mb_w * mb_h, np.int64)
    for rs, mv in lists:
        mb = mb_groups(rs, mv, mb_w, mb_h)[0]
        np.add.at(per, mb, 1)
    out = {str(c): int((per == c).sum()) for c in range(5)}
    out[">4"] = int((per > 4).sum())
    return out


def full_pel_census(lists, mb_w, mb_h):
    """How much of a picture's motion is full-pel: {"inter": MBs that use
    a list, "full_pel": those of them whose every used vector is
    full-pel in both components, "frac_blocks": the share of used
    (block, list) pairs with a fractional vector}.  lists: [(rs, mv)]
    per list, raster 4x4 block order."""
    n = mb_w * mb_h
    used = np.zeros(16 * n, bool)
    frac = np.zeros(16 * n, bool)
    pairs = fracs = 0
    for rs, mv in lists:
        u = np.asarray(rs) >= 0
        f = u & (((np.asarray(mv)[:, 0] | np.asarray(mv)[:, 1]) & 3) != 0)
        used |= u
        frac |= f
        pairs += int(u.sum())
        fracs += int(f.sum())

    def per_mb(x):
        return x.reshape(mb_h, 4, mb_w, 4).swapaxes(1, 2).reshape(n, 16) \
            .any(1)

    inter = per_mb(used)
    return {"inter": int(inter.sum()),
            "full_pel": int((inter & ~per_mb(frac)).sum()),
            "frac_blocks": fracs / pairs if pairs else 0.0}
