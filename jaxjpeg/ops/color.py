"""Chroma upsampling + YCbCr -> RGB conversion.

Replacement for the reference's final GL passes: the display
shaders' nearest-neighbor upsample + JFIF color matrix (yuv.fs.glsl:11-23,
unyuv.fs.glsl:12-49) and libjpeg's pinned ``do_fancy_upsampling=FALSE``
replication mode (jpeg_wrap.c:171-178).

Two conversion paths:

* :func:`ycbcr_to_rgb_exact` -- libjpeg-compatible fixed-point arithmetic
  (16-bit scaled constants, per-term rounding structure of the standard
  table-driven converter), bit-exact vs libjpeg's RGB output.
* :func:`ycbcr_to_rgb_float` -- plain float JFIF matrix as the shaders use
  ([1.402, -0.34414, -0.71414, 1.772], yuv.fs.glsl:11-15); fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
# FIX(x) = round(x * 2^16) of the JFIF constants.
FIX_1_40200 = 91881
FIX_0_34414 = 22554
FIX_0_71414 = 46802
FIX_1_77200 = 116130


def upsample_nearest(plane: jax.Array, xdec: int, ydec: int, xp=jnp) -> jax.Array:
    """Replicate a chroma plane 2^xdec x 2^ydec (the `s >> xdec` semantics)."""
    if ydec:
        plane = xp.repeat(plane, 1 << ydec, axis=-2)
    if xdec:
        plane = xp.repeat(plane, 1 << xdec, axis=-1)
    return plane


def _edge_pad(plane, axis, xp):
    """Pad one sample on both sides of ``axis`` by edge replication."""
    pad = [(0, 0)] * plane.ndim
    pad[axis] = (1, 1)
    if xp is jnp:
        return jnp.pad(plane, pad, mode="edge")
    import numpy as np

    return np.pad(plane, pad, mode="edge")


def upsample_fancy_h2(plane: jax.Array, axis: int, xp=jnp) -> jax.Array:
    """Triangle-filter 2x upsample along ``axis`` (libjpeg 'fancy' mode).

    Bit-exact reimplementation of the classic centered 1/4-3/4 filter:
    nearer-neighbor weight 3, farther weight 1; the two output phases use
    rounding constants 1 and 2 so the pair sums preserve energy; edge
    samples replicate.  Works on u8 sample planes (int arithmetic; int16
    suffices -- values stay under 2^10 -- and halves the HBM traffic of
    the full-resolution intermediates, which dominate this pass).
    """
    x = plane.astype(xp.int16)
    padded = _edge_pad(x, axis, xp)
    n = x.shape[axis]

    def take(arr, lo, hi):
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(lo, hi)
        return arr[tuple(idx)]

    left = take(padded, 0, n)       # s[i-1] (edge-replicated)
    right = take(padded, 2, n + 2)  # s[i+1]
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    out = xp.stack([even, odd], axis=axis + 1 if axis >= 0 else plane.ndim + axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return out.reshape(shape).astype(plane.dtype)


def upsample_fancy_h2v2(plane: jax.Array, xp=jnp) -> jax.Array:
    """Fancy 2x2 upsample (4:2:0): vertical triangle pass into 10-bit sums,
    then horizontal triangle pass with 16-way rounding -- the exact
    fixed-point structure of the standard two-pass implementation.
    Intermediates are int16 (max value 4088 < 2^15): the pass is
    bandwidth-bound on full-resolution temporaries, so narrower is
    faster."""
    x = plane.astype(xp.int16)
    h, w = x.shape[-2], x.shape[-1]
    padded = _edge_pad(x, -2, xp)

    def rows(lo, hi):
        return padded[..., lo:hi, :]

    above = rows(0, h)
    below = rows(2, h + 2)
    # Column sums for the two output row phases: nearer row x3 + farther.
    sum_even = 3 * x + above   # output rows 2r
    sum_odd = 3 * x + below    # output rows 2r + 1
    colsum = xp.stack([sum_even, sum_odd], axis=-2)
    colsum = colsum.reshape(x.shape[:-2] + (2 * h, w))

    cpad = _edge_pad(colsum, -1, xp)
    left = cpad[..., :, 0:w]
    right = cpad[..., :, 2 : w + 2]
    even = (3 * colsum + left + 8) >> 4
    odd = (3 * colsum + right + 7) >> 4
    # Edge columns: (colsum * 4 + 8|7) >> 4 -- equivalent to the general
    # form with the edge-replicated neighbor, so no special casing needed.
    out = xp.stack([even, odd], axis=-1)
    return out.reshape(x.shape[:-2] + (2 * h, 2 * w)).astype(plane.dtype)


def upsample_fancy(plane: jax.Array, xdec: int, ydec: int, xp=jnp) -> jax.Array:
    """Dispatch fancy upsampling by decimation; falls back to replication
    for factors the fancy filters do not define (e.g. 4:1:1)."""
    if (xdec, ydec) == (0, 0):
        return plane
    if (xdec, ydec) == (1, 1):
        return upsample_fancy_h2v2(plane, xp=xp)
    if (xdec, ydec) == (1, 0):
        return upsample_fancy_h2(plane, axis=plane.ndim - 1, xp=xp)
    if (xdec, ydec) == (0, 1):
        return upsample_fancy_h2(plane, axis=plane.ndim - 2, xp=xp)
    return upsample_nearest(plane, xdec, ydec, xp=xp)


def ycbcr_to_rgb_exact(
    y: jax.Array, cb: jax.Array, cr: jax.Array, xp=jnp
) -> jax.Array:
    """Fixed-point YCbCr->RGB, bit-exact vs libjpeg's integer converter.

    Per-channel rounding mirrors the table-driven structure: R and B round
    their single chroma product; G sums both products with one rounding
    constant folded into the Cr term.  ``xp`` selects jnp or numpy.
    """
    yi = y.astype(xp.int32)
    cbi = cb.astype(xp.int32) - 128
    cri = cr.astype(xp.int32) - 128
    r = yi + ((FIX_1_40200 * cri + ONE_HALF) >> SCALEBITS)
    b = yi + ((FIX_1_77200 * cbi + ONE_HALF) >> SCALEBITS)
    g = yi + ((-FIX_0_34414 * cbi + (-FIX_0_71414 * cri + ONE_HALF)) >> SCALEBITS)
    rgb = xp.stack([r, g, b], axis=-1)
    return xp.clip(rgb, 0, 255).astype(xp.uint8)


def ycbcr_to_rgb_float(y: jax.Array, cb: jax.Array, cr: jax.Array) -> jax.Array:
    """Float JFIF conversion (fast path; matches the GLSL matrix)."""
    yf = y.astype(jnp.float32)
    cbf = cb.astype(jnp.float32) - 128.0
    crf = cr.astype(jnp.float32) - 128.0
    r = yf + 1.402 * crf
    g = yf - 0.34414 * cbf - 0.71414 * crf
    b = yf + 1.772 * cbf
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(jnp.round(rgb), 0.0, 255.0).astype(jnp.uint8)


def _row_clamped_neighbors(x, axis: int, true_n: int):
    """(prev, next) of ``x`` along ``axis`` by slice-concat, edge-replicated
    at index 0 and at ``true_n - 1`` (the TRUE image edge, which may sit
    inside the MCU padding)."""
    n = x.shape[axis]

    def take(lo, hi):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, hi)
        return x[tuple(idx)]

    prev = jnp.concatenate([take(0, 1), take(0, n - 1)], axis=axis)
    nxt = jnp.concatenate([take(1, n), take(n - 1, n)], axis=axis)
    if true_n < n:
        nxt = jax.lax.dynamic_update_slice_in_dim(
            nxt, take(true_n - 1, true_n), true_n - 1, axis=axis
        )
    return prev, nxt


def upsample_fancy_h2_padded(plane: jax.Array, axis: int, true_n: int) -> jax.Array:
    """Triangle 2x upsample along ``axis`` on the MCU-padded plane.

    Same arithmetic as upsample_fancy_h2, but neighbors come from
    slice-concats with the true edge clamped in place, so every op runs on
    the aligned padded shape; outputs beyond 2*true_n are garbage the
    caller crops.
    """
    x = plane.astype(jnp.int16)
    left, right = _row_clamped_neighbors(x, axis, true_n)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    stacked = jnp.stack([even, odd], axis=axis + 1 if axis >= 0 else plane.ndim + axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * x.shape[axis]
    return stacked.reshape(shape).astype(plane.dtype)


def upsample_fancy_h2v2_padded(
    plane: jax.Array, true_h: int, true_w: int
) -> jax.Array:
    """Fancy 2x2 upsample on the MCU-padded plane with true-edge clamps.

    Bit-identical to upsample_fancy_h2v2 over the true region; the padded
    tail is garbage the caller crops.  Callers should place a
    jax.lax.optimization_barrier before this (the filter reads the plane
    several times; XLA otherwise rematerialises the producing IDCT into
    every tap)."""
    x = plane.astype(jnp.int16)
    h, w = x.shape[-2], x.shape[-1]
    above, below = _row_clamped_neighbors(x, -2, true_h)
    sum_even = 3 * x + above
    sum_odd = 3 * x + below
    colsum = jnp.stack([sum_even, sum_odd], axis=-2)
    colsum = colsum.reshape(x.shape[:-2] + (2 * h, w))
    left, right = _row_clamped_neighbors(colsum, -1, true_w)
    even = (3 * colsum + left + 8) >> 4
    odd = (3 * colsum + right + 7) >> 4
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(x.shape[:-2] + (2 * h, 2 * w)).astype(plane.dtype)


def upsample_fancy_padded(
    plane: jax.Array, xdec: int, ydec: int, true_w: int, true_h: int
) -> jax.Array:
    """Padded-plane fancy dispatch (cf. upsample_fancy, which crops first)."""
    if (xdec, ydec) == (0, 0):
        return plane
    if (xdec, ydec) == (1, 1):
        return upsample_fancy_h2v2_padded(plane, true_h, true_w)
    if (xdec, ydec) == (1, 0):
        return upsample_fancy_h2_padded(plane, plane.ndim - 1, true_w)
    if (xdec, ydec) == (0, 1):
        return upsample_fancy_h2_padded(plane, plane.ndim - 2, true_h)
    return upsample_nearest(plane, xdec, ydec)
