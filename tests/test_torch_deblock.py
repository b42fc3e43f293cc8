"""The port's deblock precompute equals deblock_precompute_intra_jax, and
the plain in-place filter (B3's twin) applied after the plain wavefront
equals the Pallas recon + deblock kernels in interpret mode."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.deblock import (deblock, deblock_precompute_intra,
                                            pack_params)
from dryv_tpu_torch.kernels.geometry import PRE_KEYS
from dryv_tpu_torch.tables import decoder_tables

from test_pallas_deblock import _random_pre
from test_pallas_wavefront import _random_syntax
from test_torch_wavefront import port_recon


@pytest.mark.parametrize("geom", [(1, 1), (5, 3), (8, 6)])
def test_precompute_matches_jax(geom):
    import jax.numpy as jnp
    from dryv_tpu.kernels.deblock import deblock_precompute_intra_jax

    mb_w, mb_h = geom
    n = mb_w * mb_h
    F = 3
    rng = np.random.default_rng(5 * mb_w + mb_h)
    kind = rng.integers(0, 4, (F, n)).astype(np.int32)
    qp = rng.integers(0, 52, (F, n)).astype(np.int32)
    sid = np.sort(rng.integers(0, 3, (F, n)), axis=1).astype(np.int32)
    dis = rng.integers(0, 3, (F, n)).astype(np.int32)
    offa = (2 * rng.integers(-6, 7, (F, n))).astype(np.int32)
    offb = (2 * rng.integers(-6, 7, (F, n))).astype(np.int32)
    c0, c1 = 2, -3
    got = deblock_precompute_intra(*(torch.from_numpy(a) for a in (
        kind, qp, sid, dis, offa, offb)), mb_w, mb_h, c0, c1,
        decoder_tables("cpu"))
    for f in range(F):
        ref = deblock_precompute_intra_jax(
            *(jnp.asarray(a[f]) for a in (kind, qp, sid, dis, offa, offb)),
            mb_w, mb_h, c0, c1)
        for k in PRE_KEYS:
            np.testing.assert_array_equal(got[k][f].numpy(),
                                          np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_plain_deblock_matches_pallas(geom, F):
    from dryv_tpu.kernels.pallas_deblock import make_gop_recon_deblock_pallas

    mb_w, mb_h = geom
    rng = np.random.default_rng(31 * mb_w + mb_h)
    s, y_resid, c_resid = _random_syntax(rng, mb_w, mb_h, F)
    pre = _random_pre(rng, s, mb_w, mb_h, F)
    fn = make_gop_recon_deblock_pallas(mb_w, mb_h, F, interpret=True)
    ref = fn(s, y_resid, c_resid, pre)
    y, cb, cr = port_recon(s, y_resid, c_resid, mb_w, mb_h)
    prm = pack_params({k: torch.from_numpy(v) for k, v in pre.items()})
    got = deblock(prm, y, cb, cr, mb_w, mb_h)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
