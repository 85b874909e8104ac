"""Device expander for the PACK upload: (run, value) entries -> coefficients.

The host uploads only the run-length packed entropy symbols (the
reference's minimal-upload experiment, README.md:18-20, jpeg_gpu.c:1287)
and the device expands them to dense coefficients.

Stream format per block mirrors xjpeg's packed layout (xjpeg.c:484-535):
a u16 ``DC & 0xfff`` entry (absolute DC -- prediction already applied, so
blocks are position-independent), then ``run<<12 | value&0xfff`` per
non-zero AC (``0xF000`` for a zero run of 16), then ``0x0000`` as EOB
(omitted when the block fills to 63).

Entries are fixed 16-bit, so no serial decode is needed: an entry's
zig-zag position is a cumulative sum of ``run + 1`` over the entries
before it in its block (a segmented cumsum over the whole stream), and
one scatter writes every coefficient.  Plain XLA on every platform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jaxjpeg.ops.zigzag import ZIGZAG


def _sign12(v):
    """12-bit two's complement -> int32."""
    return jnp.where(v >= 0x800, v - 0x1000, v)


def expand_pack(entries: jax.Array, block_starts: jax.Array) -> jax.Array:
    """Expand packed entries -> (n_blocks, 64) int16 natural-order coefs.

    ``entries`` (N,) uint16 in scan order; ``block_starts`` (n_blocks,)
    int32, the index of each block's DC entry, ascending (scan order).
    """
    n = entries.shape[0]
    n_blocks = block_starts.shape[0]
    e = entries.astype(jnp.int32)
    is_start = jnp.zeros((n,), jnp.int32).at[block_starts].set(1)
    blk = jnp.cumsum(is_start) - 1
    first = block_starts[blk]
    at_dc = jnp.arange(n, dtype=jnp.int32) == first
    step = jnp.where(at_dc, 0, (e >> 12) + 1)
    csum = jnp.cumsum(step)
    k = csum - csum[first]  # zig-zag position; 0 for the DC entry
    write = jnp.logical_or(at_dc, jnp.logical_and(e != 0, k <= 63))
    pos = jnp.asarray(ZIGZAG, jnp.int32)[jnp.minimum(k, 63)]
    size = n_blocks * 64
    idx = jnp.where(write, blk * 64 + pos, size)
    out = jnp.zeros((size,), jnp.int16).at[idx].set(
        _sign12(e & 0xFFF).astype(jnp.int16), mode="drop"
    )
    return out.reshape(n_blocks, 64)
