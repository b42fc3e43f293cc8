"""Every numpy helper the port copies out of a jax-importing module equals
its original, and the port's constant tables carry the JAX package's
numbers."""
import numpy as np
import pytest

from dryv_tpu_torch import gop_pipeline as tgp
from dryv_tpu_torch import wire
from dryv_tpu_torch.kernels import geometry as G


@pytest.mark.parametrize("geom", [(1, 1), (5, 3), (8, 6), (120, 68)])
def test_diag_schedule(geom):
    from dryv_tpu.kernels.wavefront import diag_schedule

    for a, b in zip(G.diag_schedule(*geom), diag_schedule(*geom)):
        np.testing.assert_array_equal(a, b)


def test_geometry_tables():
    from dryv_tpu.kernels import deblock, densify, pallas_wavefront, \
        transform, wavefront

    for name in ("BLK4_A", "BLK4_B", "BLK4_C", "BLK4_D", "BLK8_A", "BLK8_B",
                 "BLK8_C", "BLK8_D"):
        np.testing.assert_array_equal(getattr(G, name),
                                      getattr(wavefront, name))
    np.testing.assert_array_equal(G.Z2SP, pallas_wavefront._Z2SP)
    np.testing.assert_array_equal(G.Q2SP, pallas_wavefront._Q2SP)
    np.testing.assert_array_equal(G.LS4_FLAT, transform.LS4_FLAT)
    np.testing.assert_array_equal(G.LS8_FLAT, transform.LS8_FLAT)
    assert (G.BLK, G.L, G.NB) == (densify.BLK, densify.L, densify.NB)
    for x, q in ((0, 128), (1, 128), (8160, 128), (8192, 128), (7, 8)):
        assert G.round_up(x, q) == densify.round_up(x, q)
    assert G.PRE_KEYS == deblock.PRE_KEYS


def test_blob_helpers():
    """``wire.layout`` and ``wire.alloc`` without motion segments are the
    batched JAX pipeline's ``_blob_layout`` and ``_alloc_blob``."""
    from dryv_tpu import gop_pipeline as jgp

    assert wire.I16_STRIDE == jgp.I16_STRIDE
    assert wire.U8_STRIDE == jgp.U8_STRIDE
    assert [(n, d) for n, d, _ in wire.SEGMENTS[:wire.COEFF]] == \
        [(n, d) for n, d, _ in jgp._BLOB_SPEC]
    for caps in ((16, 8192, 8160, 32, 256, 64), (4, 128, 12, 96, 512, 128),
                 (1, 128, 1, 256, 256, 64), (3, 256, 200, 64, 768, 192)):
        assert wire.layout(*caps) == jgp._blob_layout(*caps)
        blob, views = wire.alloc(*caps)
        jblob, jviews = jgp._alloc_blob(*caps)
        np.testing.assert_array_equal(blob, jblob)
        assert views.keys() == jviews.keys()
        for k in views:
            assert views[k].dtype == jviews[k].dtype
            np.testing.assert_array_equal(views[k], jviews[k])
    for x, q in ((0, 64), (65, 64), (300, 256), (4096, 256), (33, 32)):
        assert wire.round_cap(x, q) == jgp._round_cap(x, q)


def test_syntax_keys_and_stack_frames():
    from dryv_tpu.parallel.gop import stack_frames
    from dryv_tpu.pipeline import SYNTAX_KEYS
    from dryv_tpu.testing.fixtures import get_fixture
    from dryv_tpu_torch import syntax
    from dryv_tpu_torch.pipeline import frames_from_stream

    assert syntax.SYNTAX_KEYS == SYNTAX_KEYS
    stream = get_fixture("slices_qp28")[0]
    fs_list = frames_from_stream(stream)[0] * 2
    got = syntax.stack_frames(fs_list)
    ref = stack_frames(fs_list)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("geom,n_bands", [((4, 3), 2), ((8, 6), 4),
                                          ((120, 68), 3), ((5, 4), 3)])
def test_band_schedule(geom, n_bands):
    from dryv_tpu.parallel.bands import band_schedule
    from dryv_tpu_torch.parallel.bands import band_schedule as tbs

    got, ref = tbs(*geom, n_bands), band_schedule(*geom, n_bands)
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


FIXTURES = ["mix_qp26", "pcm", "slices_qp28", "dblk_slices_qp28",
            "cavlc_mix_qp26", "c422_qp27", "lossless_i4", "scal_mix8_qp28",
            "scal_pps_qp30", "mono_qp26"]


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_and_scope(name):
    from dryv_tpu import gop_pipeline as jgp
    from dryv_tpu.testing.fixtures import get_fixture

    stream = get_fixture(name)[0]
    pics, sps, pps = tgp._parse_pictures(stream)
    jpics, jsps, jpps = jgp._parse_pictures(stream)
    assert len(pics) == len(jpics)
    for (sd, hs), (jsd, jhs) in zip(pics, jpics):
        assert sd == jsd
        assert tgp._gop_supported(sps, pps, hs) == \
            jgp._gop_supported(jsps, jpps, jhs)
    assert wire.dbctl_of(pics[0][1]).tolist() == \
        [list(r) for r in _jax_dbctl(pics[0][1])]


def _jax_dbctl(headers):
    """The control rows the JAX pipeline builds inline (dbctl_of)."""
    return [(1, 0, 0) if h.deblocking is not None
            and h.deblocking.disable_idc == 1 else
            (0, 0, 0) if h.deblocking is None else
            (h.deblocking.disable_idc, h.deblocking.alpha_c0_offset_div2 * 2,
             h.deblocking.beta_offset_div2 * 2) for h in headers]


def test_decoder_tables():
    import torch

    from dryv_tpu.kernels.pred_tables import tables_4x4, tables_8x8
    from dryv_tpu.refimpl.deblock import ALPHA, BETA, TC0
    from dryv_tpu.refimpl.transform import QPC_TAB
    from dryv_tpu_torch.tables import chroma_qp, decoder_tables

    t = decoder_tables("cpu")
    np.testing.assert_array_equal(t["ls4y"].numpy(),
                                  G.LS4_FLAT.reshape(6, 16))
    np.testing.assert_array_equal(t["ls8y"].numpy(),
                                  G.LS8_FLAT.reshape(6, 64))
    np.testing.assert_array_equal(t["alpha"].numpy(), ALPHA)
    np.testing.assert_array_equal(t["beta"].numpy(), BETA)
    np.testing.assert_array_equal(t["tc0"].numpy(), TC0)
    np.testing.assert_array_equal(t["qpc_tab"].numpy(), QPC_TAB)
    for key, tabs in (("tap4", tables_4x4()), ("tap8", tables_8x8())):
        idx, w, r, s = tabs
        tap = t[key].numpy().astype(np.int32)
        np.testing.assert_array_equal(tap[..., 0:3], idx)
        np.testing.assert_array_equal(tap[..., 3:6], w)
        np.testing.assert_array_equal(tap[..., 6], r)
        np.testing.assert_array_equal(tap[..., 7], s)
    np.testing.assert_array_equal(t["avail4"].numpy(),
                                  np.stack([G.BLK4_A, G.BLK4_B, G.BLK4_C]))
    custom = np.arange(96, dtype=np.int32).reshape(6, 4, 4) + 1
    np.testing.assert_array_equal(
        decoder_tables("cpu", ls4cb=custom)["ls4cb"].numpy(),
        custom.reshape(6, 16))
    # chroma QP mapping vs the JAX pipeline's host helper
    from dryv_tpu.gop_pipeline import _qpc_vec
    qp = np.arange(52)
    for off in (-12, -2, 0, 5, 12):
        np.testing.assert_array_equal(
            chroma_qp(torch.as_tensor(qp), off, t["qpc_tab"]).numpy(),
            _qpc_vec(qp, off))


def test_ipb_wire_copies():
    """The packed I/P/B wire format of the port equals the JAX path's:
    ``wire.layout`` and ``wire.alloc`` at F = 1 with the motion segments
    are its ``_layout`` and ``_alloc``, the coefficient segments' shapes
    less the leading 1."""
    from dryv_tpu import device_ipb_packed as jip

    assert [(n, d) for n, d, _ in wire.SEGMENTS] == \
        [(n, d) for n, d, _ in jip._IPB_SPEC]
    for npad, n, n4, W, ecap, ovcap in (
            (8192, 8160, 130560, 32, 1024, 256),
            (128, 24, 384, 96, 2048, 512), (128, 1, 16, 256, 1024, 256)):
        offs, total = wire.layout(1, npad, n, W, ecap, ovcap, n4)
        joffs, jtotal = jip._layout(npad, n, n4, W, ecap, ovcap)
        assert total == jtotal and offs.keys() == joffs.keys()
        for k, (off, shape, dt) in offs.items():
            lead = 1 if list(offs).index(k) < wire.COEFF else 0
            assert shape[:lead] == (1,) * lead
            assert (off, shape[lead:], dt) == joffs[k], k
        blob, views = wire.alloc(1, npad, n, W, ecap, ovcap, n4)
        jblob, jviews = jip._alloc(npad, n, n4, W, ecap, ovcap)
        np.testing.assert_array_equal(blob, jblob)
        assert views.keys() == jviews.keys()
        for k in views:
            assert views[k].dtype == jviews[k].dtype
            np.testing.assert_array_equal(
                views[k].reshape(jviews[k].shape), jviews[k])
