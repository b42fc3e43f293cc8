"""Motion compensation on H.264 macroblock layouts: the port's
``mc_frame_plain`` and the B4 wrapper ``mc_frame`` (on the CPU, its plain
version ``mc_frame_wire_plain``) equal ``dryv_tpu.kernels.inter``
(``resolve_wp_blocks_jax`` + ``mc_frame``) at tolerance 0, on motion
fields from ``dryv_tpu_torch.testing.motion.partitioned_field``: every
layout kind alone (with intra MBs beside it) and all mixed, P and B,
weighted prediction 0/1/2, and a band of MB rows placed by ``row0``.
Real pictures are made of such partitions: B4 gives an MB's blocks to
one warp, so these fields give its warps few vectors each, as real
streams do, where random per-block vectors give them many."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryv_tpu.kernels import inter as J
from dryv_tpu_torch.kernels import inter as T
from dryv_tpu_torch.testing.motion import (KINDS, full_pel_census,
                                           group_census, mb_groups,
                                           partitioned_field)

N_REF = (3, 2)
# groups of one list in one MB, at most, by layout kind (P, B)
MAX_GROUPS = {"intra": (0, 0), "skip": (1, 4), "16x16": (1, 1),
              "16x8": (2, 2), "8x16": (2, 2), "8x8": (16, 16)}


def _picture(seed, mb_w, mb_h, R, nlists, kinds, H=None):
    """Reference stacks (H luma rows, the picture's by default), a
    partitioned field and weighted-prediction tables."""
    rng = np.random.default_rng(seed)
    H = H or 16 * mb_h
    W = 16 * mb_w
    refs = (rng.integers(0, 256, (R, H, W)).astype(np.uint8),
            rng.integers(0, 256, (R, H // 2, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (R, H // 2, W // 2)).astype(np.uint8))
    f = partitioned_field(rng, mb_w, mb_h, R, nlists, kinds, n_ref=N_REF)
    expl = np.zeros((2, 32, 6), np.int16)
    expl[:, :4] = rng.integers(-128, 128, (2, 4, 6))
    imp = np.zeros((256, 2), np.int16)
    imp[:16] = rng.integers(-64, 129, (16, 2))
    return refs, f, expl, imp


def _jax_mc(refs, f, expl, imp, nlists, wp_mode, mb_w, mb_h):
    """The JAX package's prediction (int32, MB tiles) and its per-block
    WP parameters."""
    b = nlists == 2
    ri1 = f["ri1"] if b else np.full_like(f["ri0"], -1)
    wp = J.resolve_wp_blocks_jax(jnp.asarray(f["ri0"], jnp.int32),
                                 jnp.asarray(ri1, jnp.int32), wp_mode,
                                 jnp.asarray(expl), 5, 6, jnp.asarray(imp),
                                 N_REF[1])
    i32 = {k: jnp.asarray(f[k], jnp.int32)
           for k in ("rs0", "rs1", "mv0", "mv1")}
    py, pc = J.mc_frame(*map(jnp.asarray, refs), i32["rs0"],
                        i32["rs1"] if b else None, i32["mv0"],
                        i32["mv1"] if b else None, wp, mb_w, mb_h)
    return np.asarray(py), np.asarray(pc), wp


def _wire(refs, f, expl, imp, nlists, wp_mode):
    """mc_frame's arguments on the packed wire's layout: int16 vectors
    [n4, 2 lists, 2] and int8 slots / reference indices [n4, 4], read as
    strided views."""
    b = nlists == 2
    mv = torch.from_numpy(np.stack([f["mv0"], f["mv1"]], 1))
    rsri = torch.from_numpy(np.stack([f["rs0"], f["rs1"], f["ri0"],
                                      f["ri1"]], 1))
    wp = {"mode": wp_mode, "ri0": rsri[:, 2], "ri1": rsri[:, 3],
          "expl": torch.from_numpy(expl), "imp": torch.from_numpy(imp),
          "misc": torch.tensor([5, 6, N_REF[1], 0], dtype=torch.int32)}
    return (*map(torch.from_numpy, refs), rsri[:, 0],
            rsri[:, 1] if b else None, mv[:, 0], mv[:, 1] if b else None, wp)


def _used_tiles(f, nlists, mb_w, mb_h):
    """Per MB tile sample: does its block use a list ([n,16,16], [n,2,8,8])."""
    u = f["rs0"] >= 0
    if nlists == 2:
        u = u | (f["rs1"] >= 0)
    g = u.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3).reshape(-1, 4, 4)
    uc = np.kron(g, np.ones((1, 2, 2), bool))
    return np.kron(g, np.ones((1, 4, 4), bool)), np.stack([uc, uc], 1)


@pytest.mark.parametrize("wp_mode", [0, 1, 2])
@pytest.mark.parametrize("nlists", [1, 2])
@pytest.mark.parametrize("kind", KINDS + ("mixed",))
def test_partitioned_mc_matches_jax(kind, nlists, wp_mode):
    """Every block of every layout: mc_frame_plain equals the JAX
    mc_frame, and the B4 wrapper on the wire's fields and the picture's
    WP tables equals it where a list is used and predicts 0 elsewhere."""
    mb_w, mb_h = (6, 4) if (nlists + wp_mode) % 2 else (5, 3)
    kinds = {"mixed": KINDS, "intra": ("intra",)}.get(kind, (kind, "intra"))
    seed = 1000 * KINDS.index(kind) if kind in KINDS else 7000
    refs, f, expl, imp = _picture(seed + 10 * nlists + wp_mode, mb_w, mb_h,
                                  3, nlists, kinds)
    py, pc, wp = _jax_mc(refs, f, expl, imp, nlists, wp_mode, mb_w, mb_h)
    b = nlists == 2
    gy, gc = T.mc_frame_plain(
        *map(torch.from_numpy, refs),
        *(torch.from_numpy(f[k].astype(np.int32)) if b or k[-1] == "0"
          else None for k in ("rs0", "rs1", "mv0", "mv1")),
        {k: torch.from_numpy(np.array(v)) for k, v in wp.items()},
        mb_w, mb_h)
    np.testing.assert_array_equal(gy.numpy(), py)
    np.testing.assert_array_equal(gc.numpy(), pc)

    before = T.mc_frame.launches
    ky, kc = T.mc_frame(*_wire(refs, f, expl, imp, nlists, wp_mode), mb_w,
                        mb_h)
    assert T.mc_frame.launches == before
    uy, uc = _used_tiles(f, nlists, mb_w, mb_h)
    np.testing.assert_array_equal(ky.numpy(), np.where(uy, py, 0))
    np.testing.assert_array_equal(kc.numpy(), np.where(uc, pc, 0))


@pytest.mark.parametrize("nlists", [1, 2])
def test_band_rows_match_jax(nlists):
    """A band of MB rows 2..3 of a 6x5-MB picture, its fields alone and
    row0 = 8 placing it in the whole planes (as banded P recon places a
    band in its extended plane), equals those rows of the JAX picture."""
    mb_w, mb_h = 6, 5
    refs, f, expl, imp = _picture(40 + nlists, mb_w, mb_h, 2, nlists, KINDS)
    py, pc, _ = _jax_mc(refs, f, expl, imp, nlists, 1, mb_w, mb_h)
    rows = slice(2 * 4 * 4 * mb_w, 4 * 4 * 4 * mb_w)       # 4x4 blocks
    band = {k: v[rows] for k, v in f.items() if k != "kind"}
    ky, kc = T.mc_frame(*_wire(refs, band, expl, imp, nlists, 1), mb_w, 2,
                        row0=8)
    mbs = slice(2 * mb_w, 4 * mb_w)
    uy, uc = _used_tiles(band, nlists, mb_w, 2)
    assert uy.any() and not uy.all()
    np.testing.assert_array_equal(ky.numpy(), np.where(uy, py[mbs], 0))
    np.testing.assert_array_equal(kc.numpy(), np.where(uc, pc[mbs], 0))


@pytest.mark.parametrize("nlists", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_partitioned_field_layouts(kind, nlists):
    """The generator draws what it says: each kind's MBs split into at
    most its partitions' groups a list (and sub-8x8 splits into more than
    four somewhere), P pictures use list 0 only, B pictures both lists
    and bi-prediction, and some windows reach past an edge of the
    plane."""
    mb_w, mb_h = 8, 6
    f = partitioned_field(np.random.default_rng(nlists), mb_w, mb_h, 3,
                          nlists, (kind,), n_ref=N_REF)
    assert set(f["kind"]) == {kind}
    per_list = []
    for l in range(2):
        mb, mask, vec = mb_groups(f[f"rs{l}"], f[f"mv{l}"], mb_w, mb_h)
        per_list.append(np.bincount(mb, minlength=mb_w * mb_h))
        # the groups of one MB are disjoint, and each group's blocks have
        # its vector and one slot
        for a in np.unique(mb):
            m = mask[mb == a]
            assert sum(bin(x).count("1") for x in m) == \
                bin(np.bitwise_or.reduce(m)).count("1")
        for a, m, v in zip(mb, mask, vec):
            k = np.nonzero(m >> np.arange(16) & 1)[0]
            blk = (4 * (a // mb_w) + k // 4) * 4 * mb_w + 4 * (a % mb_w) \
                + k % 4
            assert (f[f"mv{l}"][blk] == v).all()
            assert len(set(f[f"rs{l}"][blk])) == 1 and f[f"rs{l}"][blk[0]] >= 0
    most = max(per_list[0].max(), per_list[1].max())
    assert most <= MAX_GROUPS[kind][nlists - 1]
    if kind == "8x8":
        assert most > 4
    census = group_census([(f["rs0"], f["mv0"]), (f["rs1"], f["mv1"])],
                          mb_w, mb_h)
    assert sum(census.values()) == mb_w * mb_h
    if kind == "intra":
        assert census["0"] == mb_w * mb_h
        return
    u0, u1 = f["rs0"] >= 0, f["rs1"] >= 0
    assert u0.any() and (u1.any() and (u0 & u1).any()) == (nlists == 2)
    x = np.arange(len(u0)) % (4 * mb_w) * 4 + (f["mv0"][:, 0] >> 2)
    y = np.arange(len(u0)) // (4 * mb_w) * 4 + (f["mv0"][:, 1] >> 2)
    out = (x < 0) | (y < 0) | (x > 16 * mb_w - 4) | (y > 16 * mb_h - 4)
    assert (out & u0).any()


@pytest.mark.parametrize("nlists", [1, 2])
def test_full_pel_census(nlists):
    """The full-pel census counts what it says: every inter MB is
    full-pel once the vectors are rounded down to full samples; one
    quarter-pel component in one block of one list takes its MB out, and
    the fractional share is that of the used (block, list) pairs."""
    mb_w, mb_h = 6, 4
    f = partitioned_field(np.random.default_rng(7 + nlists), mb_w, mb_h, 3,
                          nlists, KINDS, n_ref=N_REF)
    lists = [(f[f"rs{l}"], f[f"mv{l}"] & ~3) for l in range(nlists)]
    c = full_pel_census(lists, mb_w, mb_h)
    used = sum(int((rs >= 0).sum()) for rs, _ in lists)
    inter = (np.stack([rs >= 0 for rs, _ in lists]).any(0)
             .reshape(mb_h, 4, mb_w, 4).any((1, 3)))
    assert c == {"inter": int(inter.sum()), "full_pel": int(inter.sum()),
                 "frac_blocks": 0.0}
    # one fractional vector component in the last used block of the
    # last list
    rs, mv = lists[-1]
    blk = np.nonzero(rs >= 0)[0][-1]
    mv = mv.copy()
    mv[blk, nlists - 1] |= 1
    lists[-1] = (rs, mv)
    c = full_pel_census(lists, mb_w, mb_h)
    assert c["inter"] == int(inter.sum())
    assert c["full_pel"] == int(inter.sum()) - 1
    assert c["frac_blocks"] == 1 / used
