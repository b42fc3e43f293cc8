"""The plain densify (B1's twin) equals the Pallas make_densify kernel in
interpret mode: empty rows, count == W, count > W (zeros past W) and
full 408-coefficient rows."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.densify import densify, densify_plain


def _rows(rng, F, npad, W):
    """Bitmaps with a spread of per-row counts and int8 values."""
    counts = rng.integers(0, 409, (F, npad))
    counts[:, 0] = 0            # empty row
    counts[:, 1] = W            # exactly W
    counts[:, 2] = W + 1        # just past W
    counts[:, 3] = 408          # every coefficient
    bits = np.zeros((F, npad, 408), np.uint8)
    for f in range(F):
        for r in range(npad):
            bits[f, r, rng.permutation(408)[:counts[f, r]]] = 1
    bmp = np.packbits(bits, axis=-1, bitorder="little")
    vals = rng.integers(-127, 128, (F, npad, W)).astype(np.int8)
    return bmp, vals


@pytest.mark.parametrize("npad,W", [(128, 32), (256, 96)])
def test_densify_matches_pallas(npad, W):
    import jax.numpy as jnp
    from dryv_tpu.kernels.densify import make_densify

    rng = np.random.default_rng(npad + W)
    F = 2
    bmp, vals = _rows(rng, F, npad, W)
    ref = np.asarray(make_densify(F, npad, W, interpret=True)(
        jnp.asarray(bmp), jnp.asarray(vals)))
    got = densify(torch.from_numpy(bmp), torch.from_numpy(vals))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    # rows past W keep their first W values and zero the rest
    row = got.numpy()[0, 2]
    assert np.count_nonzero(row) <= W


def test_densify_plain_semantics():
    """Coefficient c takes vals[rank - 1] (inclusive rank of set bits)."""
    bits = np.zeros((1, 1, 408), np.uint8)
    bits[0, 0, [0, 7, 8, 200, 407]] = 1
    bmp = np.packbits(bits, axis=-1, bitorder="little")
    vals = np.array([[[5, -3, 7, 100, -127, 9, 9, 9]]], np.int8)
    out = densify_plain(torch.from_numpy(bmp), torch.from_numpy(vals))
    want = np.zeros(408, np.int16)
    want[[0, 7, 8, 200, 407]] = [5, -3, 7, 100, -127]
    np.testing.assert_array_equal(out.numpy()[0, 0], want)
