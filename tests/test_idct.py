"""IDCT conformance tests.

Mirrors the reference's IEEE 1180-1990 conformance strategy (test/dct.c:229):
random blocks through fdct -> clamp -> idct, statistical error bounds vs a
float64 reference IDCT -- but applied to *both* device IDCT paths:

* float (matrix-form) path: must meet IEEE-1180 bounds easily,
* integer islow path: must meet IEEE-1180 bounds AND be bit-identical to
  the numpy reference implementation of the same fixed-point algorithm.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from jaxjpeg.ops import idct as idct_ops
from jaxjpeg.ops import idct_islow
from jaxjpeg.testing.oracle import idct8x8_float64


def _ieee1180_blocks(lo: int, hi: int, n: int, seed: int) -> np.ndarray:
    """Random pixel blocks -> float64 fdct -> clamped int coefficients."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(lo, hi + 1, size=(n, 8, 8)).astype(np.float64)
    from jaxjpeg.testing.encoder import _M

    coefs = np.einsum("ui,nij,vj->nuv", _M, pix, _M)
    return np.clip(np.round(coefs), -2048, 2047).astype(np.int32)


IEEE_RANGES = [(-256, 255), (-5, 5), (-300, 300)]


@pytest.mark.parametrize("lo,hi", IEEE_RANGES)
def test_float_idct_ieee1180(lo, hi):
    n = 2000
    coefs = _ieee1180_blocks(lo, hi, n, seed=42)
    ref = np.clip(np.round(idct8x8_float64(coefs)), -256, 255)
    got = np.asarray(idct_ops.idct8x8(jnp.asarray(coefs)))
    got = np.clip(np.round(got), -256, 255)
    err = got - ref
    assert np.abs(err).max() <= 1, "peak error"
    assert (err**2).mean() <= 0.02, "overall MSE"
    assert (err**2).mean(axis=0).max() <= 0.06, "worst pixel MSE"
    assert abs(err.mean()) <= 0.0015, "overall mean error"


@pytest.mark.parametrize("lo,hi", IEEE_RANGES)
def test_islow_idct_ieee1180(lo, hi):
    n = 2000
    coefs = _ieee1180_blocks(lo, hi, n, seed=43)
    ref = np.clip(np.round(idct8x8_float64(coefs)), -256, 255)
    got = np.asarray(idct_islow.idct8x8_islow(jnp.asarray(coefs)))
    got = np.clip(got, -256, 255)
    err = got - ref
    assert np.abs(err).max() <= 1, "peak error"
    assert (err**2).mean() <= 0.02, "overall MSE"
    assert abs(err.mean()) <= 0.0015, "overall mean error"


def test_zero_in_zero_out():
    z = jnp.zeros((4, 8, 8), jnp.int32)
    assert (np.asarray(idct_ops.idct8x8(z)) == 0).all()
    assert (np.asarray(idct_islow.idct8x8_islow(z)) == 0).all()


def test_islow_jnp_matches_numpy():
    """The jnp and numpy islow paths are the same arithmetic, bit for bit."""
    rng = np.random.default_rng(7)
    coefs = rng.integers(-2048, 2048, size=(512, 8, 8), dtype=np.int32)
    a = np.asarray(idct_islow.idct8x8_islow(jnp.asarray(coefs)))
    b = idct_islow.idct8x8_islow(coefs, xp=np)
    np.testing.assert_array_equal(a, b)


def test_dc_only_block():
    """A DC-only block must decode flat to round(dc/8) (orthonormal scaling)."""
    coefs = np.zeros((1, 8, 8), np.int32)
    coefs[0, 0, 0] = 400
    out = np.asarray(idct_islow.idct8x8_islow(jnp.asarray(coefs)))
    expected = int(np.round(400 / 8.0))
    assert (out == expected).all()
