"""Stage A of the port (int32 adds and shifts) equals the JAX stage A
(exact float32 matmuls) bit for bit, on random levels across QP 0..51,
with flat and custom LevelScale tables.  Levels stay small enough that
the JAX matmuls are exact (|acc| < 2^24), as in
tests/test_jax_pipeline.py."""
import numpy as np
import pytest
import torch

from dryv_tpu.refimpl.transform import CLASS4, CLASS8, V4X4, V8X8
from dryv_tpu_torch.kernels import transform as T
from dryv_tpu_torch.kernels.geometry import LS4_FLAT, LS8_FLAT


def _levelscales(rng, custom):
    if not custom:
        return LS4_FLAT, LS8_FLAT
    w4 = rng.integers(4, 33, (4, 4))
    w8 = rng.integers(4, 33, (8, 8))
    return ((w4[None] * V4X4[:, CLASS4]).astype(np.int32),
            (w8[None] * V8X8[:, CLASS8]).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("custom", [False, True])
def test_luma_zrows_and_chroma_tiles(custom):
    import jax.numpy as jnp
    from dryv_tpu.kernels import transform as J

    rng = np.random.default_rng(11 + custom)
    M = 520
    ls4, ls8 = _levelscales(rng, custom)
    qp = np.arange(M, dtype=np.int32) % 52
    kind = rng.integers(0, 3, M).astype(np.int32)
    Z = rng.integers(-32, 33, (M, 256)).astype(np.int32)
    dc = rng.integers(-32, 33, (M, 16)).astype(np.int32)
    ref = J.luma_residual_zrows(jnp.asarray(kind), jnp.asarray(qp),
                                jnp.asarray(Z.T), jnp.asarray(dc.T),
                                jnp.asarray(ls4), jnp.asarray(ls8))
    got = T.luma_residual_zrows(_t(kind), _t(qp), _t(Z), _t(dc),
                                _t(ls4.reshape(6, 16)),
                                _t(ls8.reshape(6, 64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).T)

    qpc = rng.integers(0, 52, M).astype(np.int32)
    qpr = rng.integers(0, 52, M).astype(np.int32)
    cdc = rng.integers(-32, 33, (M, 2, 4)).astype(np.int32)
    cac = rng.integers(-32, 33, (M, 2, 4, 16)).astype(np.int32)
    ls4r = _levelscales(rng, custom)[0]
    ref = J.chroma_residual_tiles(
        jnp.asarray(qpc), jnp.asarray(qpr), jnp.asarray(cdc.reshape(M, 2, 2,
                                                                     2)),
        jnp.asarray(cac.reshape(M, 2, 4, 4, 4)), M, jnp.asarray(ls4),
        jnp.asarray(ls4r))
    got = T.chroma_residual_tiles(_t(qpc), _t(qpr), _t(cdc), _t(cac),
                                  _t(ls4.reshape(6, 16)),
                                  _t(ls4r.reshape(6, 16)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_block_transforms():
    """dequant4/8, idct4/8, i16_dc and chroma_dc against the JAX block
    versions (normative direction order included)."""
    import jax.numpy as jnp
    from dryv_tpu.kernels import transform as J

    rng = np.random.default_rng(3)
    N = 300
    qp = rng.integers(0, 52, N).astype(np.int32)
    c4 = rng.integers(-64, 65, (N, 4, 4)).astype(np.int32)
    c8 = rng.integers(-64, 65, (N, 8, 8)).astype(np.int32)
    ls4 = LS4_FLAT
    ls8 = LS8_FLAT
    np.testing.assert_array_equal(
        T.dequant4(_t(c4.reshape(N, 16)), _t(qp),
                   _t(ls4.reshape(6, 16))).numpy().reshape(N, 4, 4),
        np.asarray(J.dequant4(jnp.asarray(c4), jnp.asarray(qp),
                              jnp.asarray(ls4))))
    np.testing.assert_array_equal(
        T.dequant8(_t(c8.reshape(N, 64)), _t(qp),
                   _t(ls8.reshape(6, 64))).numpy().reshape(N, 8, 8),
        np.asarray(J.dequant8(jnp.asarray(c8), jnp.asarray(qp),
                              jnp.asarray(ls8))))
    d4 = rng.integers(-4000, 4001, (N, 4, 4)).astype(np.int32)
    d8 = rng.integers(-4000, 4001, (N, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(T.idct4(_t(d4)).numpy(),
                                  np.asarray(J.idct4(jnp.asarray(d4))))
    np.testing.assert_array_equal(T.idct8(_t(d8)).numpy(),
                                  np.asarray(J.idct8(jnp.asarray(d8))))
    np.testing.assert_array_equal(
        T.i16_dc(_t(c4.reshape(N, 16)), _t(qp),
                 _t(ls4.reshape(6, 16))).numpy().reshape(N, 4, 4),
        np.asarray(J.i16_dc(jnp.asarray(c4), jnp.asarray(qp),
                            jnp.asarray(ls4))))
    c2 = c4[:, :2, :2]
    np.testing.assert_array_equal(
        T.chroma_dc(_t(c2.reshape(N, 4)), _t(qp),
                    _t(ls4.reshape(6, 16))).numpy().reshape(N, 2, 2),
        np.asarray(J.chroma_dc(jnp.asarray(c2), jnp.asarray(qp),
                               jnp.asarray(ls4))))


def test_stage_a_residuals_compact_dict():
    """The batched entry on the compact ABI dict, as the pipelines feed
    it, against pallas_wavefront.stage_a_residuals."""
    import jax.numpy as jnp
    from dryv_tpu.kernels.pallas_wavefront import stage_a_residuals
    from dryv_tpu_torch.tables import decoder_tables

    rng = np.random.default_rng(17)
    F, n = 3, 40
    s = {
        "kind": rng.integers(0, 3, (F, n)).astype(np.uint8),
        "qp_y": rng.integers(0, 52, (F, n)).astype(np.uint8),
        "qp_cb": rng.integers(0, 40, (F, n)).astype(np.uint8),
        "qp_cr": rng.integers(0, 40, (F, n)).astype(np.uint8),
        "luma_lv": rng.integers(-32, 33, (F, n, 256)).astype(np.int16),
        "luma_dc": rng.integers(-32, 33, (F, n, 16)).astype(np.int16),
        "chroma_dc": rng.integers(-32, 33, (F, n, 8)).astype(np.int16),
        "chroma_ac": rng.integers(-32, 33, (F, n, 128)).astype(np.int16),
    }
    ls = [jnp.asarray(LS4_FLAT)] * 3 + [jnp.asarray(LS8_FLAT)]
    _, y_z, c = stage_a_residuals({k: jnp.asarray(v) for k, v in s.items()},
                                  *ls, F, n)
    gy, gc = T.stage_a_residuals({k: _t(v) for k, v in s.items()},
                                 decoder_tables("cpu"))
    np.testing.assert_array_equal(gy.numpy().reshape(F * n, 256),
                                  np.asarray(y_z).T)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(c))
