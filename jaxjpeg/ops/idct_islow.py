"""Bit-exact integer inverse DCT ("islow"-compatible).

Implements the classic Loeffler-Ligtenberg-Moshovitz 8-point IDCT in the
exact fixed-point arithmetic libjpeg(-turbo)'s accurate integer path uses
(13-bit constants, two passes, PASS1 descale by CONST_BITS-2, final descale
by CONST_BITS+PASS1_BITS+3), so decoded samples are *bit-identical* to
libjpeg's ``JDCT_ISLOW`` output -- the parity target from BASELINE.md.
The reference's own float AAN IDCT (dct.c) only meets IEEE-1180 bounds;
bit-exactness is something it never had (SURVEY.md section 7, hard part 2).

Written as vectorised jnp int32 ops over (..., 8, 8) blocks: each butterfly
line operates on whole (..., 8) row/column lanes: pure elementwise work
with no scalar loops.  All adds/shifts occur in int32 with the
same wraparound semantics as the C implementation.

This is a from-scratch implementation of the published algorithm
(ITU T.81 / IEEE 1180 literature; constants are FIX(x) = round(x * 2^13)
of the standard rotation constants), not a translation of any C source.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

CONST_BITS = 13
PASS1_BITS = 2

# FIX(x) = round(x * 2^13) for the standard rotation constants.
F_0_298631336 = 2446
F_0_390180644 = 3196
F_0_541196100 = 4433
F_0_765366865 = 6270
F_0_899976223 = 7373
F_1_175875602 = 9633
F_1_501321110 = 12299
F_1_847759065 = 15137
F_1_961570560 = 16069
F_2_053119869 = 16819
F_2_562915447 = 20995
F_3_072711026 = 25172


def _descale(x: jax.Array, n: int) -> jax.Array:
    """(x + 2^(n-1)) >> n with arithmetic shift (fixed-point rounding)."""
    return (x + (1 << (n - 1))) >> n


def _idct8(c0, c1, c2, c3, c4, c5, c6, c7, descale_bits: int):
    """One 8-point integer IDCT pass over int32 lanes.

    Inputs are the 8 frequency lanes; returns the 8 sample lanes, each
    descaled by ``descale_bits``.
    """
    # Even part: rotate (c2, c6), combine with (c0, c4).
    z1 = (c2 + c6) * F_0_541196100
    t2 = z1 - c6 * F_1_847759065
    t3 = z1 + c2 * F_0_765366865
    t0 = (c0 + c4) << CONST_BITS
    t1 = (c0 - c4) << CONST_BITS
    e0 = t0 + t3
    e3 = t0 - t3
    e1 = t1 + t2
    e2 = t1 - t2

    # Odd part: 4-point section with the 1.175 common rotation.
    z1 = c7 + c1
    z2 = c5 + c3
    z3 = c7 + c3
    z4 = c5 + c1
    z5 = (z3 + z4) * F_1_175875602
    o0 = c7 * F_0_298631336
    o1 = c5 * F_2_053119869
    o2 = c3 * F_3_072711026
    o3 = c1 * F_1_501321110
    z1 = z1 * (-F_0_899976223)
    z2 = z2 * (-F_2_562915447)
    z3 = z3 * (-F_1_961570560) + z5
    z4 = z4 * (-F_0_390180644) + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4

    return (
        _descale(e0 + o3, descale_bits),
        _descale(e1 + o2, descale_bits),
        _descale(e2 + o1, descale_bits),
        _descale(e3 + o0, descale_bits),
        _descale(e3 - o0, descale_bits),
        _descale(e2 - o1, descale_bits),
        _descale(e1 - o2, descale_bits),
        _descale(e0 - o3, descale_bits),
    )


def idct8x8_islow(deq: jax.Array, xp=jnp) -> jax.Array:
    """Integer IDCT of dequantized (..., 8, 8) int32 blocks -> int32 samples.

    Output samples are centered (level shift NOT applied); callers add 128
    and clamp.  Bit-exact vs libjpeg's accurate integer inverse DCT.
    ``xp`` selects the array backend (jnp on device, numpy for the host
    decoder backend) -- the arithmetic is identical in both.
    """
    x = deq.astype(xp.int32)
    # Pass 1: columns (operate along axis -2). Descale by CONST_BITS-PASS1_BITS.
    cols = [x[..., u, :] for u in range(8)]
    p1 = _idct8(*cols, descale_bits=CONST_BITS - PASS1_BITS)
    y = xp.stack(p1, axis=-2)
    # Pass 2: rows (axis -1). Final descale folds in the x8 scale and PASS1.
    rows = [y[..., :, v] for v in range(8)]
    p2 = _idct8(*rows, descale_bits=CONST_BITS + PASS1_BITS + 3)
    return xp.stack(p2, axis=-1)


def dequant_idct_islow_pixels(coefs: jax.Array, qtable: jax.Array, xp=jnp) -> jax.Array:
    """Bit-exact sample path: int dequant, islow IDCT, +128, clamp -> uint8."""
    deq = coefs.astype(xp.int32) * qtable.astype(xp.int32)
    x = idct8x8_islow(deq, xp=xp) + 128
    return xp.clip(x, 0, 255).astype(xp.uint8)


def dequant_idct_islow_plane(coefs: jax.Array, qtable: jax.Array) -> jax.Array:
    """Bit-exact sample path emitting the raster plane directly.

    (..., vb, hb, 8, 8) coefficients -> (..., vb*8, hb*8) uint8 samples.
    Identical arithmetic to dequant_idct_islow_pixels, but the second pass
    assembles its outputs in (vb, row-in-block, hb, col-in-block) order, so
    the plane is a free reshape, with no separate blocks->plane u8
    transpose.
    """
    x = coefs.astype(jnp.int32) * qtable.astype(jnp.int32)
    *lead, vb, hb, _, _ = x.shape
    # Pass 1: columns (along u). Each slice is (..., vb, hb, 8v).
    cols = [x[..., u, :] for u in range(8)]
    p1 = _idct8(*cols, descale_bits=CONST_BITS - PASS1_BITS)
    # Pass 2: rows, one output row u at a time; row u lands at plane row
    # vb*8+u via the axis=-3 stack below (no standalone transpose).
    out_rows = []
    for u in range(8):
        cv = [p1[u][..., v] for v in range(8)]
        o = _idct8(*cv, descale_bits=CONST_BITS + PASS1_BITS + 3)
        row = jnp.stack(o, axis=-1)              # (..., vb, hb, 8v)
        row = jnp.clip(row + 128, 0, 255).astype(jnp.uint8)
        out_rows.append(row)
    y = jnp.stack(out_rows, axis=-3)             # (..., vb, 8u, hb, 8v)
    return y.reshape(*lead, vb * 8, hb * 8)
