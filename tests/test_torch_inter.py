"""The port's motion compensation (``dryv_tpu_torch.kernels.inter``, the
plain version of kernel B4) equals ``dryv_tpu.kernels.inter`` at
tolerance 0: luma and chroma block MC at every phase, the weighted-
prediction combine and resolve (modes 0, 1, 2), and whole pictures for P
and B with random reference stacks and vectors far outside the plane."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryv_tpu.kernels import inter as J
from dryv_tpu_torch import _build
from dryv_tpu_torch.kernels import inter as T


def _picture(seed, mb_w, mb_h, R):
    """Random stacks and a motion field: list 0 only, list 1 only, both
    and neither, vectors up to ~40 pixels past every edge, reference
    indices into a zero-padded table."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    n4 = 16 * mb_w * mb_h
    refs = (rng.integers(0, 256, (R, H, W)).astype(np.uint8),
            rng.integers(0, 256, (R, H // 2, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (R, H // 2, W // 2)).astype(np.uint8))
    use = rng.integers(0, 4, n4)           # 0 none, 1 l0, 2 l1, 3 both
    rs0 = np.where(use & 1, rng.integers(0, R, n4), -1)
    rs1 = np.where(use & 2, rng.integers(0, R, n4), -1)
    ri0 = np.where(rs0 >= 0, rng.integers(0, 4, n4), -1)
    ri1 = np.where(rs1 >= 0, rng.integers(0, 4, n4), -1)
    reach = 4 * (max(H, W) + 40)
    mv = rng.integers(-reach, reach, (n4, 2, 2))
    mv[: n4 // 4] = rng.integers(-12, 13, (n4 // 4, 2, 2))   # near zero
    # every eighth-pel (so every quarter-pel) phase pair in list 0
    ph = np.arange(64)
    mv[:64, 0] = 8 * rng.integers(-4, 5, (64, 2)) + np.stack([ph & 7,
                                                              ph >> 3], 1)
    expl = np.zeros((2, 32, 6), np.int32)
    expl[:, :4] = rng.integers(-128, 128, (2, 4, 6))
    imp = np.zeros((256, 2), np.int32)
    imp[:16] = rng.integers(-64, 129, (16, 2))
    return (refs, rs0.astype(np.int32), rs1.astype(np.int32),
            mv.astype(np.int32), ri0.astype(np.int32), ri1.astype(np.int32),
            expl, imp)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("geom", [(6, 4), (5, 3)])
def test_block_mc_matches_jax(geom):
    """Luma and chroma MC of one list, every quarter- and eighth-pel
    phase, windows clamped at every edge."""
    mb_w, mb_h = geom
    refs, rs0, _, mv, *_ = _picture(11 * mb_w, mb_w, mb_h, 3)
    H, W = refs[0].shape[1:]
    n4 = 16 * mb_w * mb_h
    mv0 = mv[:, 0]
    assert len({(x & 3, y & 3) for x, y in mv0}) == 16
    assert len({(x & 7, y & 7) for x, y in mv0}) == 64
    idx = np.arange(n4)
    bx4, by4 = idx % (4 * mb_w), idx // (4 * mb_w)
    slot = np.maximum(rs0, 0)
    ry = refs[0].astype(np.int32).reshape(-1)
    got = T.mc_luma_blocks(_t(ry), _t(slot), _t(mv0), _t(bx4), _t(by4), H, W)
    ref = J.mc_luma_blocks(_j(ry), _j(slot), _j(mv0), _j(bx4), _j(by4), H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rc = refs[1].astype(np.int32).reshape(-1)
    got = T.mc_chroma_blocks(_t(rc), _t(slot), _t(mv0), _t(bx4), _t(by4),
                             H // 2, W // 2)
    ref = J.mc_chroma_blocks(_j(rc), _j(slot), _j(mv0), _j(bx4), _j(by4),
                             H // 2, W // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("wp_mode", [0, 1, 2])
def test_resolve_and_combine_match_jax(wp_mode):
    _, rs0, rs1, _, ri0, ri1, expl, imp = _picture(5, 6, 4, 2)
    got = T.resolve_wp_blocks_torch(_t(ri0), _t(ri1), wp_mode, _t(expl),
                                    torch.tensor(5), torch.tensor(6),
                                    _t(imp), torch.tensor(4))
    ref = J.resolve_wp_blocks_jax(_j(ri0), _j(ri1), wp_mode, _j(expl), 5, 6,
                                  _j(imp), 4)
    host = J.resolve_wp_blocks(ri0, ri1, wp_mode, expl, 5, 6, imp, 4)
    copy = T.resolve_wp_blocks(ri0, ri1, wp_mode, expl, 5, 6, imp, 4)
    assert set(got) == set(ref) == set(copy) == set(T.WP_KEYS)
    for k in T.WP_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
        np.testing.assert_array_equal(copy[k], host[k], k)
    rng = np.random.default_rng(wp_mode)
    p0 = rng.integers(0, 256, (len(ri0), 4, 4)).astype(np.int32)
    p1 = rng.integers(0, 256, (len(ri0), 4, 4)).astype(np.int32)
    w = [got[k] for k in ("wy0", "oy0", "wy1", "oy1", "dy")]
    out = T.wp_combine(_t(p0), _t(p1), _t(rs0 >= 0), _t(rs1 >= 0), *w)
    ref = J.wp_combine(_j(p0), _j(p1), _j(rs0 >= 0), _j(rs1 >= 0),
                       *(_j(x.numpy()) for x in w))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _jax_mc(pic, mb_w, mb_h, nlists, wp_mode):
    refs, rs0, rs1, mv, ri0, ri1, expl, imp = pic
    if nlists == 1:
        rs1 = ri1 = np.full_like(rs0, -1)
    wp = J.resolve_wp_blocks_jax(_j(ri0), _j(ri1), wp_mode, _j(expl), 5, 6,
                                 _j(imp), 4)
    py, pc = J.mc_frame(*map(_j, refs), _j(rs0),
                        _j(rs1) if nlists == 2 else None, _j(mv[:, 0]),
                        _j(mv[:, 1]) if nlists == 2 else None, wp, mb_w,
                        mb_h)
    return np.asarray(py), np.asarray(pc), wp


@pytest.mark.parametrize("nlists", [1, 2])
@pytest.mark.parametrize("wp_mode", [0, 1, 2])
@pytest.mark.parametrize("geom,R", [((6, 4), 3), ((5, 3), 1), ((6, 4), 2)])
def test_mc_frame_matches_jax(geom, R, wp_mode, nlists):
    """mc_frame_plain (the JAX layout: int32 fields, per-block WP) equals
    the JAX mc_frame on every block; the B4 wrapper on the packed wire's
    int8/int16 fields and the picture's WP tables equals it on every
    block that uses a list, and predicts 0 elsewhere."""
    mb_w, mb_h = geom
    pic = _picture(R * 100 + wp_mode * 10 + nlists, mb_w, mb_h, R)
    refs, rs0, rs1, mv, ri0, ri1, expl, imp = pic
    py, pc, wp = _jax_mc(pic, mb_w, mb_h, nlists, wp_mode)
    b = nlists == 2
    gy, gc = T.mc_frame_plain(
        *map(_t, refs), _t(rs0), _t(rs1) if b else None, _t(mv[:, 0]),
        _t(mv[:, 1]) if b else None,
        {k: _t(np.asarray(v)) for k, v in wp.items()}, mb_w, mb_h)
    np.testing.assert_array_equal(gy.numpy(), py)
    np.testing.assert_array_equal(gc.numpy(), pc)

    n4 = len(rs0)
    mv16 = _t(mv.astype(np.int16))                    # [n4, 2 lists, 2]
    rsri = _t(np.stack([rs0, rs1, ri0, ri1], 1).astype(np.int8))
    tabs = {"mode": wp_mode, "ri0": rsri[:, 2], "ri1": rsri[:, 3],
            "expl": _t(expl.astype(np.int16)),
            "imp": _t(imp.astype(np.int16)),
            "misc": torch.tensor([5, 6, 4, 0], dtype=torch.int32)}
    before = T.mc_frame.launches
    ky, kc = T.mc_frame(*map(_t, refs), rsri[:, 0], rsri[:, 1] if b else None,
                        mv16[:, 0], mv16[:, 1] if b else None, tabs, mb_w,
                        mb_h)
    assert T.mc_frame.launches == before and _build._lib is None
    assert ky.dtype == kc.dtype == torch.uint8
    u = (rs0 >= 0) | ((rs1 >= 0) if b else False)
    assert u.sum() < n4
    g = u.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3).reshape(-1, 4, 4)
    uy = np.kron(g, np.ones((1, 4, 4), bool))
    uc = np.repeat(np.kron(g, np.ones((1, 2, 2), bool))[:, None], 2, 1)
    np.testing.assert_array_equal(ky.numpy(), np.where(uy, py, 0))
    np.testing.assert_array_equal(kc.numpy(), np.where(uc, pc, 0))


def test_mc_frame_checks_its_inputs():
    refs, rs0, rs1, mv, ri0, ri1, expl, imp = _picture(1, 2, 2, 1)
    t = [_t(r) for r in refs]
    mv16 = _t(mv.astype(np.int16))
    rs8 = _t(rs0.astype(np.int8))
    with pytest.raises(ValueError, match="int8"):
        T.mc_frame(*t, _t(rs0), None, mv16[:, 0], None, {"mode": 0}, 2, 2)
    with pytest.raises(ValueError, match="int16"):
        T.mc_frame(*t, rs8, None, _t(mv[:, 0]), None, {"mode": 0}, 2, 2)
    with pytest.raises(ValueError, match="both"):
        T.mc_frame(*t, rs8, rs8, mv16[:, 0], None, {"mode": 0}, 2, 2)
    with pytest.raises(ValueError, match="MBs"):
        T.mc_frame(*t, rs8, None, mv16[:, 0], None, {"mode": 0}, 2, 3)
    with pytest.raises(ValueError, match="wp mode"):
        T.mc_frame(*t, rs8, None, mv16[:, 0], None, {"mode": 3}, 2, 2)
