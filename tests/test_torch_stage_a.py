"""The plain versions of kernels B5 (stage A into B2's int16 rows) and
B6 (the deblock parameter rows) against the JAX package, at tolerance 0.

B5's plain version ``stage_a_plain`` equals
``dryv_tpu.kernels.pallas_wavefront.stage_a_residuals`` followed by the
clamp to [-255, 255], over every kind (I4, I8, I16, PCM, and the I/P/B
path's inter MBs as I4/I8 by their transform-8x8 flag, its kind 11
included), QP 0 to 51 with both ends present, flat and random LevelScale
lists, and chroma QP offsets of -12 and +12.  Levels stay small enough
that the JAX matmuls are exact (|acc| < 2^24), as in
tests/test_torch_transform.py; its coded flags per 4x4 block (nz4, asked
for by the I/P/B step) equal the step's jnp expression in the JAX
package on the wire's native kinds and transform-8x8 bits.  B6's plain
version ``deblock_params_plain`` on the packed I/P/B wire's layout equals
``pack_params`` of ``deblock_precompute_intra_jax`` (all-intra) and of
``deblock_precompute_jax`` (inter boundary strengths), with sorted
random slices under disable_deblocking_filter_idc 0/1/2 and filter
offsets up to +-12.  The clamp of the residual rows changes no inter
tile (clip(pred + r, 0, 255) with pred in [0, 255])."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch.coeffs import KIND_I4, KIND_I8
from dryv_tpu_torch.kernels.deblock import deblock_params
from dryv_tpu_torch.kernels.geometry import LS4_FLAT, LS8_FLAT, PRE_KEYS
from dryv_tpu_torch.kernels.transform import (luma_residual_raster,
                                              stage_a, stage_a_plain,
                                              stage_a_residuals)
from dryv_tpu_torch.tables import chroma_qp, decoder_tables

from test_torch_deblock import _inter_picture

GEOMS = [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)]


def _lists(rng, custom):
    """(ls4y, ls4cb, ls4cr [6,4,4], ls8y [6,8,8]): flat, or each list
    random weights 4..32 times the normative V tables."""
    from dryv_tpu_torch.refimpl.transform import CLASS4, CLASS8, V4X4, V8X8

    if not custom:
        return LS4_FLAT, LS4_FLAT, LS4_FLAT, LS8_FLAT
    ls4 = [(rng.integers(4, 33, (4, 4))[None] * V4X4[:, CLASS4])
           .astype(np.int32) for _ in range(3)]
    return (*ls4, (rng.integers(4, 33, (8, 8))[None] * V8X8[:, CLASS8])
            .astype(np.int32))


def wire_kinds(rng, F, n):
    """Native kinds 0..11 [F, n], the kind byte's transform-8x8 bit as
    the packed I/P/B wire sets it (inter MBs at random, I8 MBs at random,
    0 elsewhere: intra folds it into the kind), and stage A's kinds from
    them as the I/P/B step remaps them (inter 4..10 -> I8 with the bit,
    else I4)."""
    native = rng.integers(0, 12, (F, n))
    t8 = rng.integers(0, 2, (F, n))
    inter = (native >= 4) & (native <= 10)
    kind = np.where(inter, np.where(t8 == 1, KIND_I8, KIND_I4), native)
    return native, np.where(inter | (native == KIND_I8), t8, 0), kind


def stage_a_inputs(rng, F, n, amp=32, sparse=False):
    """Random stage A syntax [F, n, ...] (numpy): kinds from the I/P/B
    path's remap of native kinds 0..11 (``wire_kinds``), QP 0..51 with 0
    and 51 present, chroma QPs from offsets -12 / +12, levels in [-amp,
    amp].  With `sparse`, luma 4x4 blocks are all 0 at random (p 0.6)
    and whole 8x8 quadrants too (p 0.3), so that the coded flags take
    both values; the wire's native kinds and transform-8x8 bits come
    back then as well: (syntax, native, t8)."""
    native, t8, kind = wire_kinds(rng, F, n)
    qp = rng.integers(0, 52, (F, n))
    qp.flat[:2] = [0, 51]
    tabs = decoder_tables("cpu")
    q = torch.from_numpy(qp)
    s = {"kind": kind, "qp_y": qp,
         "qp_cb": chroma_qp(q, -12, tabs["qpc_tab"]).numpy(),
         "qp_cr": chroma_qp(q, 12, tabs["qpc_tab"]).numpy()}
    s = {k: v.astype(np.int32) for k, v in s.items()}
    for k, width in (("luma_lv", 256), ("luma_dc", 16), ("chroma_dc", 8),
                     ("chroma_ac", 128)):
        s[k] = rng.integers(-amp, amp + 1, (F, n, width)).astype(np.int16)
    if not sparse:
        return s
    lv = s["luma_lv"].reshape(F, n, 16, 16)
    lv[rng.random((F, n, 16)) < 0.6] = 0
    lv.reshape(F, n, 4, 64)[rng.random((F, n, 4)) < 0.3] = 0
    return s, native, t8


def coded_blocks_jax(native, t8, luma_lv, mb_w, mb_h):
    """The I/P/B step's coded flags per 4x4 block of one picture: the
    jnp expression of ``dryv_tpu/device_ipb_packed.py`` (:265-276) on
    its native kinds [n], kind-byte transform-8x8 bits [n] and luma
    levels [n, 256]; bool [4 mb_h, 4 mb_w]."""
    import jax.numpy as jnp
    from dryv_tpu.avc.neighbors import ZSCAN_4X4_POS

    n = mb_w * mb_h
    kind, t8, lanes = (jnp.asarray(a) for a in (native, t8, luma_lv))
    nzz = lanes[:, :256].reshape(n, 16, 16).any(-1)
    nz8 = lanes[:, :256].reshape(n, 4, 64).any(-1)
    blk = jnp.arange(16)
    nz_z = jnp.where((t8 == 1)[:, None] | (kind == KIND_I8)[:, None],
                     nz8[:, blk >> 2], nzz)
    perm = np.zeros(16, np.int32)
    for z in range(16):
        ox, oy = ZSCAN_4X4_POS[z]
        perm[oy * 4 + ox] = z
    return np.asarray(nz_z[:, jnp.asarray(perm)]
                      .reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3)
                      .reshape(4 * mb_h, 4 * mb_w))


@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("geom,F", GEOMS)
def test_stage_a_plain_matches_jax(geom, F, custom):
    import jax.numpy as jnp
    from dryv_tpu.kernels.pallas_wavefront import stage_a_residuals as J

    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(100 * mb_w + 10 * mb_h + custom)
    s = stage_a_inputs(rng, F, n)
    lists = _lists(rng, custom)
    _, y_z, c = J({k: jnp.asarray(v) for k, v in s.items()},
                  *(jnp.asarray(a) for a in lists), F, n)
    yres, cres = stage_a_plain({k: torch.from_numpy(v) for k, v in s.items()},
                               decoder_tables("cpu", *lists))
    assert yres.dtype == cres.dtype == torch.int16
    np.testing.assert_array_equal(
        yres.numpy().reshape(F * n, 256),
        np.clip(np.asarray(y_z).T, -255, 255))
    np.testing.assert_array_equal(cres.numpy(),
                                  np.clip(np.asarray(c), -255, 255))
    # the wrapper takes its plain version on the CPU
    got = stage_a({k: torch.from_numpy(v) for k, v in s.items()},
                  decoder_tables("cpu", *lists))
    assert all(torch.equal(a, b) for a, b in zip(got, (yres, cres)))


@pytest.mark.parametrize("geom,F", GEOMS)
def test_coded_blocks_match_jax(geom, F):
    """B5's nz4 (the wrapper on the CPU: ``coded_blocks_plain``) equals
    the I/P/B step's jnp expression on the wire's native kinds and
    transform-8x8 bits, and the residual rows stay those without it."""
    mb_w, mb_h = geom
    n = mb_w * mb_h
    rng = np.random.default_rng(31 * n + F)
    s, native, t8 = stage_a_inputs(rng, F, n, sparse=True)
    st = {k: torch.from_numpy(v) for k, v in s.items()}
    tabs = decoder_tables("cpu")
    yres, cres, nz4 = stage_a(st, tabs, mb_w)
    assert nz4.dtype == torch.uint8 and nz4.shape == (F, 4 * mb_h, 4 * mb_w)
    for f in range(F):
        np.testing.assert_array_equal(
            nz4[f].numpy(), coded_blocks_jax(native[f], t8[f],
                                             s["luma_lv"][f], mb_w, mb_h))
    if n > 1:
        assert set(np.unique(nz4.numpy())) == {0, 1}
    assert all(torch.equal(a, b)
               for a, b in zip((yres, cres), stage_a_plain(st, tabs)))
    with pytest.raises(ValueError):     # n MBs do not make rows of n + 1
        stage_a(st, tabs, n + 1)


def test_stage_a_level_layouts():
    """B5 takes its levels as the column slices of dense rows (padded
    past n MBs, and a band of them) or as segments with contiguous rows
    (and a slice of pictures); a segment with rows of another stride,
    or dense slices out of order, raise before any launch."""
    from dryv_tpu_torch.kernels.transform import LEVELS, _check_level_layout

    dense = torch.zeros((2, 12, 408), dtype=torch.int16)
    cols = {k: dense[:, :10, c:c + w] for (k, w), c in
            zip(LEVELS, (0, 256, 272, 280))}
    apart = {k: torch.zeros((3, 10, w), dtype=torch.int16)
             for k, w in LEVELS}
    for levels in ([cols[k] for k, _ in LEVELS],
                   [cols[k][:, 2:7] for k, _ in LEVELS],
                   [apart[k] for k, _ in LEVELS],
                   [apart[k][1:] for k, _ in LEVELS]):
        _check_level_layout(levels, levels[0].device)
    wide = torch.zeros((2, 10, 512), dtype=torch.int16)[..., :256]
    for levels in ([wide] + [apart[k][:2] for k, _ in LEVELS[1:]],
                   [cols[k] for k, _ in reversed(LEVELS)]):
        with pytest.raises(ValueError):
            _check_level_layout(levels, levels[0].device)


def test_clamped_rows_give_the_same_inter_tiles():
    """The I/P/B path adds stage A's clamped int16 rows to its
    predictions: clip(pred + r, 0, 255) is the same with r unclamped,
    on levels large enough that many residuals leave [-255, 255]."""
    rng = np.random.default_rng(5)
    F, n = 1, 40
    s = {k: torch.from_numpy(v)
         for k, v in stage_a_inputs(rng, F, n, amp=2000).items()}
    s["qp_y"] = torch.full((F, n), 40, dtype=torch.int32)
    tabs = decoder_tables("cpu")
    y_z, c = stage_a_residuals(s, tabs)
    yres, cres = stage_a_plain(s, tabs)
    assert (y_z.abs() > 255).float().mean() > 0.2
    assert (c.abs() > 255).any()
    pred_y = torch.from_numpy(rng.integers(0, 256, (F, n, 256))
                              .astype(np.uint8))
    pred_c = torch.from_numpy(rng.integers(0, 256, (F, n, 2, 8, 8))
                              .astype(np.uint8))
    for full, clamped, pred in (
            (luma_residual_raster(y_z, s["kind"]),
             luma_residual_raster(yres, s["kind"]), pred_y),
            (c, cres, pred_c)):
        assert torch.equal((pred + full).clamp(0, 255),
                           (pred + clamped).clamp(0, 255))


def pack_jax(pre):
    """``pack_params`` of a JAX PRE_KEYS dict of one picture: [n, 192]."""
    n = np.asarray(pre["bsv"]).shape[0]
    return np.concatenate([np.asarray(pre[k]).reshape(n, -1)
                           for k in PRE_KEYS], -1).astype(np.uint8)


def deblock_inputs(rng, mb_w, mb_h, F, inter):
    """B6's inputs for F random pictures (``_inter_picture``: native
    kinds, sorted slices with idc 0/1/2 and offsets up to +-12, coded
    flags, vectors both sides of |dv| >= 4, reference keys -1..2), on
    the packed wire's layout; all-intra kinds without `inter`.  Returns
    (per-picture numpy fields, the wrapper's tensors)."""
    pics = [_inter_picture(rng, mb_w, mb_h) for _ in range(F)]
    if not inter:
        for p in pics:
            p[0] = rng.choice([0, 1, 2, 3], mb_w * mb_h).astype(np.int32)
    kind, qp, sid, ctl, t8, nz4, mv0, mv1, rk0, rk1 = [
        np.stack(a) for a in zip(*pics)]
    per_mb = [kind, qp, sid] + [np.take_along_axis(ctl[..., i], sid, 1)
                                for i in range(3)]
    n4 = 16 * mb_w * mb_h
    mv = np.stack([mv0.reshape(F, n4, 2), mv1.reshape(F, n4, 2)], 2)
    rs = np.stack([rk0.reshape(F, n4), rk1.reshape(F, n4),
                   np.zeros((F, n4)), np.zeros((F, n4))], -1)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in per_mb]
    extra = {}
    if inter:
        extra = {"t8": torch.from_numpy(t8.astype(np.int32)),
                 "nz4": torch.from_numpy(nz4),
                 "mv": torch.from_numpy(mv.astype(np.int16)),
                 "rs": torch.from_numpy(rs.astype(np.int8))}
    return pics, per_mb, args, extra


@pytest.mark.parametrize("offs", [(2, -3), (12, -12)])
@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("geom,F", GEOMS)
def test_deblock_params_plain_matches_jax(geom, F, inter, offs):
    import jax.numpy as jnp
    from dryv_tpu.kernels.deblock import (deblock_precompute_intra_jax,
                                          deblock_precompute_jax)

    mb_w, mb_h = geom
    c0, c1 = offs
    rng = np.random.default_rng(10 * mb_w + mb_h + 7 * inter + c0)
    pics, per_mb, args, extra = deblock_inputs(rng, mb_w, mb_h, F, inter)
    got = deblock_params(*args, mb_w, mb_h, c0, c1, decoder_tables("cpu"),
                         **extra)
    assert got.dtype == torch.uint8 and got.shape == (F, mb_w * mb_h, 192)
    for f, pic in enumerate(pics):
        fields = [jnp.asarray(a[f]) for a in per_mb]
        if inter:
            t8, nz4, mv0, mv1, rk0, rk1 = pic[4:]
            ref = deblock_precompute_jax(
                *fields, mb_w, mb_h, c0, c1,
                *(jnp.asarray(a) for a in (t8, nz4, mv0, mv1, rk0, rk1)))
        else:
            ref = deblock_precompute_intra_jax(*fields, mb_w, mb_h, c0, c1)
        np.testing.assert_array_equal(got[f].numpy(), pack_jax(ref))
    bs = got[..., :16].numpy()
    if mb_w > 1:
        assert set(np.unique(bs)) >= ({0, 1, 2, 3, 4} if inter
                                      else {0, 3, 4})


def test_deblock_params_takes_all_inter_inputs_or_none():
    rng = np.random.default_rng(1)
    _, _, args, extra = deblock_inputs(rng, 3, 2, 1, True)
    extra.pop("nz4")
    with pytest.raises(ValueError):
        deblock_params(*args, 3, 2, 0, 0, decoder_tables("cpu"), **extra)
