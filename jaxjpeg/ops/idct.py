"""8x8 inverse DCT, matrix form (float fast path).

The reference factors the 8-point IDCT into butterflies with 5 multiplies
(dct.c:21-87) to save scalar multiplies.  Here the 2-D IDCT is the
*matrix form*

    x = M^T @ S @ M

with ``M`` the orthonormal 8-point DCT-II basis -- two batched (.., 8) @
(8, 8) contractions, no factorization, no scale-vector bookkeeping.  The
contractions run at ``Precision.HIGHEST`` (float32 products may otherwise
run in reduced precision, e.g. TF32 on a GPU), so accuracy exceeds the
float butterfly (it *is* the definition) and IEEE-1180 conformance
(test/dct.c:229) holds.

The bit-exact integer path is ``idct_islow.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Orthonormal 8-point DCT-II basis, float32. M[u, n] = c(u) cos((2n+1)u pi/16).
def dct_basis(dtype=np.float32) -> np.ndarray:
    u = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.sqrt(2.0 / 8.0) * np.cos((2 * n + 1) * u * np.pi / 16.0)
    m[0, :] = np.sqrt(1.0 / 8.0)
    return m.astype(dtype)


IDCT_BASIS = dct_basis()


def idct8x8(blocks: jax.Array) -> jax.Array:
    """Inverse 2-D DCT of (..., 8, 8) coefficient blocks (float32 out).

    ``Precision.HIGHEST`` forces true f32 products: a reduced default
    precision (bf16 or TF32 multiplies) would blow the IEEE-1180 bounds
    (peak error must be <= 1 LSB at sample scale).
    """
    m = jnp.asarray(IDCT_BASIS)
    s = blocks.astype(jnp.float32)
    # x[i, j] = sum_{u,v} M[u, i] * S[u, v] * M[v, j]
    t = jax.lax.dot_general(
        s, m, (((s.ndim - 2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (..., v, i) after contracting u
    x = jax.lax.dot_general(
        t, m, (((t.ndim - 2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (..., i, j)
    return x


def dequant_idct(coefs: jax.Array, qtable: jax.Array) -> jax.Array:
    """Dequantize + IDCT: (..., 8, 8) int coefs, (8, 8) quant -> float32.

    The dequant multiply fuses into the first matmul's operand producer
    under XLA, mirroring how the reference folds quant scales into the
    horizontal pass (horz_quant_*.fs.glsl, jpeg_gpu.c:1320-1341).
    """
    deq = coefs.astype(jnp.float32) * qtable.astype(jnp.float32)
    return idct8x8(deq)


def dequant_idct_pixels(coefs: jax.Array, qtable: jax.Array) -> jax.Array:
    """Full float sample path: dequant, IDCT, +128 level shift, clamp -> uint8."""
    x = dequant_idct(coefs, qtable) + 128.0
    return jnp.clip(jnp.round(x), 0.0, 255.0).astype(jnp.uint8)


def dequant_idct_float_plane(coefs: jax.Array, qtable: jax.Array) -> jax.Array:
    """Float sample path emitting the raster plane directly.

    Same arithmetic as dequant_idct_pixels + blocks_to_plane, but the
    second pass assembles per-pixel-row outputs in (vb, row, hb, col)
    order, so the plane is a free reshape with no standalone u8
    blocks->plane transpose (same trick as
    ops/idct_islow.dequant_idct_islow_plane).
    """
    m = jnp.asarray(IDCT_BASIS)
    *lead, vb, hb, _, _ = coefs.shape
    deq = coefs.astype(jnp.float32) * qtable.astype(jnp.float32)
    # Pass 1: contract v -> sample column j: (..., vb, hb, 8u, 8j).
    y = jnp.einsum(
        "...uv,vj->...uj", deq, m, precision=jax.lax.Precision.HIGHEST
    )
    # Pass 2 per pixel row i: contract u, emit rows in plane order.
    rows = []
    for i in range(8):
        r = jnp.einsum(
            "...uj,u->...j", y, m[:, i],
            precision=jax.lax.Precision.HIGHEST,
        )
        r = jnp.clip(jnp.round(r + 128.0), 0.0, 255.0).astype(jnp.uint8)
        rows.append(r)                                # (..., vb, hb, 8j)
    out = jnp.stack(rows, axis=-3)                    # (..., vb, 8i, hb, 8j)
    return out.reshape(*lead, vb * 8, hb * 8)


def blocks_to_plane(blocks: jax.Array) -> jax.Array:
    """(..., vb, hb, 8, 8) block grid -> (..., vb*8, hb*8) sample plane."""
    *lead, vb, hb, _, _ = blocks.shape
    x = jnp.swapaxes(blocks, -3, -2)  # (..., vb, 8, hb, 8)
    return x.reshape(*lead, vb * 8, hb * 8)


def plane_to_blocks(plane: jax.Array) -> jax.Array:
    """(..., H, W) sample plane -> (..., H/8, W/8, 8, 8) block grid."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8)
    return jnp.swapaxes(x, -3, -2)
