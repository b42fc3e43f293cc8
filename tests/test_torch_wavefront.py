"""The plain intra wavefront (B2's twin) equals the Pallas whole-GOP
kernel make_gop_recon_pallas in interpret mode on random legal syntax,
PCM included."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.geometry import Q2SP, Z2SP
from dryv_tpu_torch.kernels.wavefront import intra_recon, recon_inputs
from dryv_tpu_torch.tables import decoder_tables

from test_pallas_wavefront import _random_syntax


def port_recon(s, y_resid, c_resid, mb_w, mb_h, tables=None, halo=None):
    """Spatial residual tiles as the Pallas recon takes them -> planes
    through recon_inputs + intra_recon (B2b with `halo`) on the CPU."""
    from dryv_tpu.coeffs import KIND_I8

    F, n = s["kind"].shape
    sp = y_resid.reshape(F, n, 256)
    y_z = np.where((s["kind"] == KIND_I8)[..., None], sp[..., Q2SP],
                   sp[..., Z2SP])
    st = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}
    st["pcm_y"] = st["pcm_y"].reshape(F, n, 256)
    meta, yres, cres = recon_inputs(st, torch.from_numpy(y_z),
                                    torch.from_numpy(c_resid))
    return intra_recon(meta, yres, cres, tables or decoder_tables("cpu"),
                       mb_w, mb_h, halo=halo)


@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_plain_wavefront_matches_pallas(geom, F):
    from dryv_tpu.kernels.pallas_wavefront import make_gop_recon_pallas

    mb_w, mb_h = geom
    rng = np.random.default_rng(7 * mb_w + mb_h)
    s, y_resid, c_resid = _random_syntax(rng, mb_w, mb_h, F)
    recon = make_gop_recon_pallas(mb_w, mb_h, F, interpret=True)
    ref = recon(s, y_resid, c_resid)
    got = port_recon(s, y_resid, c_resid, mb_w, mb_h)
    for g, r in zip(got, ref):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
