"""The port's sharded decode (``dryv_tpu_torch.parallel``) and the plain
version of kernel B2b on the CPU, bit-exact (tolerance 0) against the
JAX package, run as its own tests run it (Pallas in interpret mode, 8
virtual CPU devices), and against the oracle's goldens.  ``mix_qp26``
(4x3 MBs, one slice) puts every band boundary inside a slice;
``big_qp30`` (8x6 MBs, a slice every 2 MB rows) has band boundaries on a
slice start (3 and 4 bands) and inside a slice (2 bands)."""
from functools import lru_cache

import numpy as np
import pytest
import torch

from dryv_tpu.avc import split_annexb
from dryv_tpu.coeffs import pack_frame
from dryv_tpu.decoder import SyntaxDecoder, group_access_units
from dryv_tpu.testing.fixtures import get_fixture
from dryv_tpu_torch import parallel as tpar
from dryv_tpu_torch.kernels.wavefront import intra_recon

from test_pallas_wavefront import _random_syntax
from test_torch_wavefront import port_recon

CPU8 = ["cpu"] * 8


@lru_cache(maxsize=None)
def _fixture(name):
    stream, golden, _, _ = get_fixture(name)
    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    sps, pps, mbs, _ = sd.decode_picture_syntax(group_access_units(rest)[0])
    return pack_frame(mbs, sps, pps), golden


def _assert_planes(got, *refs):
    """got: (y, cb, cr) [F, ...]; each ref (y, cb, cr) [F, ...] or one
    picture's planes, which every frame must equal."""
    for ref in refs:
        for g, r in zip(got, ref):
            g = np.asarray(g)
            r = np.broadcast_to(np.asarray(r), g.shape)
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("geom,cut", [((8, 6), 3), ((5, 4), 2)])
def test_banded_wavefront_matches_pallas(geom, cut):
    """B2b's plain version on the bottom band (MB rows cut..) with a halo
    from the unbanded reconstruction equals the Pallas kernel with
    banded=True fed the same halo through pack_halo_blocks, and the
    unbanded planes' bottom rows."""
    from dryv_tpu.kernels.pallas_wavefront import (lane_geometry,
                                                   make_gop_recon_pallas)
    from dryv_tpu.parallel.bands import pack_halo_blocks

    mb_w, mb_h = geom
    F = 2
    rng = np.random.default_rng(11 * mb_w + cut)
    s, y_resid, c_resid = _random_syntax(rng, mb_w, mb_h, F)
    fy, fcb, fcr = (np.asarray(p) for p in make_gop_recon_pallas(
        mb_w, mb_h, F, interpret=True)(s, y_resid, c_resid))
    rows, a = mb_h - cut, cut * mb_w
    sb = {k: np.ascontiguousarray(v[:, a:]) for k, v in s.items()}
    yb, cbb = y_resid[:, a:], c_resid[:, a:]
    hy = np.ascontiguousarray(fy[:, 16 * cut - 1])               # [F, W]
    hc = np.stack([fcb[:, 8 * cut - 1], fcr[:, 8 * cut - 1]], 1)  # [F,2,W/2]
    _, _, Kpad, _ = lane_geometry(mb_w, rows, F, F)
    halo = pack_halo_blocks(hy.reshape(F, mb_w, 16),
                            hc.reshape(F, 2, mb_w, 8).transpose(0, 2, 1, 3),
                            mb_w, rows, F, Kpad)
    ref = make_gop_recon_pallas(mb_w, rows, F, Fi=F, banded=True,
                                interpret=True)(sb, yb, cbb, halo)
    before = intra_recon.banded_launches
    got = port_recon(sb, yb, cbb, mb_w, rows,
                     halo=(torch.from_numpy(hy), torch.from_numpy(hc)))
    assert intra_recon.banded_launches == before    # CPU: plain version
    assert all(g.dtype == torch.uint8 for g in got)
    _assert_planes([g.numpy() for g in got], ref,
                   (fy[:, 16 * cut:], fcb[:, 8 * cut:], fcr[:, 8 * cut:]))


def test_banded_wavefront_rejects_bad_halo():
    meta = torch.zeros((1, 4, 32), dtype=torch.uint8)
    yres = torch.zeros((1, 4, 256), dtype=torch.int16)
    cres = torch.zeros((1, 4, 2, 8, 8), dtype=torch.int16)
    bad = (torch.zeros((1, 64), dtype=torch.uint8),
           torch.zeros((1, 2, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="halo"):
        intra_recon(meta, yres, cres, {}, 4, 1, halo=bad)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("gop", [2, 4])
def test_gop_sharded(gop, use_pallas):
    """gop + 1 pictures: both versions pad the GOP with its last picture."""
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.gop import decode_gop_sharded

    fs, golden = _fixture("mix_qp26")
    fl = [fs] * (gop + 1)
    got = tpar.decode_gop_sharded(fl, tpar.make_mesh({"gop": gop}, CPU8),
                                  use_pallas=use_pallas)
    assert got[0].shape[0] == gop + 1 and got[0].dtype == np.uint8
    ref = decode_gop_sharded(fl, make_mesh({"gop": gop}),
                             use_pallas=use_pallas)
    _assert_planes(got, ref, golden)


@pytest.mark.parametrize("name", ["mix_qp26", "big_qp30"])
@pytest.mark.parametrize("n_bands,Fi", [(2, 2), (4, 1), (3, 1)])
def test_banded_gop_pipeline(name, n_bands, Fi):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_gop_pallas_fn

    fs, golden = _fixture(name)
    F = 2 * Fi
    run = tpar.make_banded_gop_fn(tpar.make_mesh({"band": n_bands}, CPU8),
                                  fs.mb_w, fs.mb_h, F, Fi=Fi)
    got = run([fs] * F)
    ref = make_banded_gop_pallas_fn(make_mesh({"band": n_bands}), fs.mb_w,
                                    fs.mb_h, F, Fi=Fi,
                                    interpret=True)([fs] * F)
    _assert_planes(got, ref, golden)


@pytest.mark.parametrize("axes", [{"band": 2}, {"band": 3},
                                  {"gop": 2, "band": 2}])
def test_banded_frame(axes):
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_frame_fn

    fs, golden = _fixture("mix_qp26")
    got = tpar.make_banded_frame_fn(tpar.make_mesh(axes, CPU8), fs.mb_w,
                                    fs.mb_h)(fs)
    ref = make_banded_frame_fn(make_mesh(axes), fs.mb_w, fs.mb_h)(fs)
    _assert_planes(got, ref, golden)


def test_make_mesh(monkeypatch):
    from dryv_tpu.parallel import make_mesh

    m = tpar.make_mesh({"gop": 2, "band": 4}, CPU8)
    assert m.shape == dict(make_mesh({"gop": 2, "band": 4}).shape)
    assert m.axis_names == ("gop", "band")
    assert m.axis_devices("band") == [torch.device("cpu")] * 4
    assert tpar.make_mesh(devices=CPU8).shape == {"gop": 8}
    with pytest.raises(AssertionError):
        make_mesh({"gop": 16})
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        tpar.make_mesh({"gop": 16}, CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh({"gop": 1})


@pytest.mark.parametrize("n,split", [(8, (2, 4)), (2, (1, 2))])
def test_dryrun_multichip(n, split):
    """Every frame of every sharded decode equals the native C++ decode."""
    r = tpar.dryrun_multichip(n, ["cpu"] * n)
    assert (r["gop"], r["band"]) == split and r["frames"] == 2


def _p_picture(mb_w, mb_h, seed):
    """A single-reference P picture as tests/test_parallel.py makes it:
    quarter-pel vectors reaching up to +-12 integer rows (across 2-MB-row
    bands) and past the picture's edges horizontally, some blocks with
    no reference (they predict 0)."""
    H, W = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    n4 = n * 16
    rng = np.random.RandomState(seed)
    ref = (rng.randint(0, 256, (H, W)).astype(np.uint8),
           rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
           rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8))
    mv = np.stack([rng.randint(-220, 221, n4),
                   rng.randint(-48, 49, n4)], axis=1).astype(np.int32)
    rs = np.where(rng.rand(n4) < 0.1, -1, 0).astype(np.int32)
    y_resid = rng.randint(-30, 31, (n, 16, 16)).astype(np.int32)
    c_resid = rng.randint(-30, 31, (n, 2, 8, 8)).astype(np.int32)
    return (*ref, mv, rs, y_resid, c_resid)


def _unbanded_p(ref_y, ref_cb, ref_cr, mv, rs, y_resid, c_resid, mb_w,
                mb_h):
    """The same picture through B4's plain version on the whole plane."""
    from dryv_tpu_torch.kernels.inter import mc_frame

    t = [torch.from_numpy(p)[None] for p in (ref_y, ref_cb, ref_cr)]
    mv16 = torch.from_numpy(mv.astype(np.int16))
    slot = torch.from_numpy(np.where(rs >= 0, 0, -1).astype(np.int8))
    py, pc = mc_frame(*t, slot, None, mv16, None, {"mode": 0}, mb_w, mb_h)
    ty = np.clip(py.numpy().astype(np.int32) + y_resid, 0, 255)
    tc = np.clip(pc.numpy().astype(np.int32) + c_resid, 0, 255)
    H, W = 16 * mb_h, 16 * mb_w
    return (ty.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3)
            .reshape(H, W).astype(np.uint8),
            *(tc[:, p].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3)
              .reshape(H // 2, W // 2).astype(np.uint8) for p in (0, 1)))


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_p_recon(n_bands):
    """make_banded_p_recon_fn on meshes that repeat the CPU equals the JAX
    function (8 virtual CPU devices) and the unbanded B4 path; the 4-band
    case chains its 64-row aprons over two bands of 32 rows."""
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_p_recon_fn

    mb_w, mb_h = 6, 8
    pic = _p_picture(mb_w, mb_h, 3)
    got = tpar.make_banded_p_recon_fn(
        tpar.make_mesh({"band": n_bands}, CPU8), mb_w, mb_h, apron=64)(*pic)
    ref = make_banded_p_recon_fn(make_mesh({"band": n_bands}), mb_w, mb_h,
                                 apron=64)(*pic)
    _assert_planes(got, ref, _unbanded_p(*pic, mb_w, mb_h))
    with pytest.raises(AssertionError, match="exceeds apron"):
        tpar.make_banded_p_recon_fn(tpar.make_mesh({"band": 2}, CPU8), mb_w,
                                    mb_h, apron=16)(*pic)
