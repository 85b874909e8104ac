"""Restart-parallel Huffman entropy decode on the device.

The host uploads *entropy bits* (destuffed segment words) and the device
produces dense quantized coefficients.  Restart segments are independent
by construction (bit buffer and DC predictors reset at every marker,
T.81 F.2.1.3), so every segment decodes in its own lane with no
communication.  Every segment has the same block structure (the
MCU-interleaved component order, repeated for each MCU of the interval),
so the block step ``t`` -- and with it the component and the Huffman
table slot -- is uniform across lanes; only the bit position differs.

Two implementations of the same arithmetic (``ops/route.py`` picks one):

* **kernel** -- Pallas through Triton.  One program decodes ``_LANES``
  segments (one warp, one segment per thread).  The bit window, word
  pointer and DC predictors stay in registers across all block steps of
  the segment; the AC loop of a block step exits as soon as no lane of
  the program is still decoding.  Tables are read by the program itself.
* **plain** -- the same core over a ``(n_segments,)`` vector in
  ``jax.numpy``, with a real ``.at[].set`` scatter.  The CPU route, and
  the baseline the kernel is timed against.

Layout:

* streams ``(B, NW, 1024)`` int32: word ``w`` of segment ``b*1024 + j``
  at ``[b, w, j]`` (big-endian words, 1-padded tail -- the bit reader
  contract, spec F.2.2.5).  Word-major within a batch, so lanes that read
  the same word index read adjacent addresses.
* Huffman tables in canonical-rank form (host/segments.py): ``cbase``
  ``(NI, 8, 16)``, ``counts`` ``(NI, 8, 17)``, ``symbols`` ``(NI, 8, 128)``
  -- slots 0..3 DC, 4..7 AC, one table set per image.
* output ``(B*1024, T, 64)`` int16: natural-order coefficients of block
  step ``t`` of segment ``s``.  Each coefficient is scattered straight to
  its position, so ``(S, R*bpm, 64)`` reshapes to MCU-major
  ``(S*R, bpm, 64)`` with no transpose.

Per-lane decode uses a 64-bit MSB-aligned bit window held in two int32
registers, refilled by one 32-bit word whenever 32 bits or fewer remain.
The symbol rank is the canonical-code rank identity (spec F.2.2.3):

    rank = sum_L clamp(top_L(window) - (mincode[L] - 1), 0, count[L])

and one gather of a packed ``sym | len << 8`` entry by rank returns both
the symbol and its code length.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from jaxjpeg.info import scan_to_frame_order
from jaxjpeg.ops import route as route_mod
from jaxjpeg.ops.zigzag import ZIGZAG

ROUTE_OP = "entropy_decode"  # this op's name in ops/route.py
SEGMENTS_PER_BATCH = 1024
N_SLOTS = 8          # Huffman table slots per image: 0..3 DC, 4..7 AC
SYMBOL_WORDS = 128   # 256 packed 16-bit entries, 2 per word

ERR_BAD_CODE = 1
ERR_OVERRUN = 2

# Segments per kernel program: one warp, one segment per thread.  Small
# programs let the AC loop exit early and give the scheduler many warps.
_LANES = 32
_NUM_WARPS = 1

_INT_MIN = -0x80000000


# ---------------------------------------------------------------- bit ops
def _lsr(x, n):
    """Logical shift right with per-lane counts in [0, 31]."""
    x, n = jnp.broadcast_arrays(x, jnp.asarray(n, jnp.int32))
    return jax.lax.shift_right_logical(x, n)


def _shl(x, n):
    x, n = jnp.broadcast_arrays(x, jnp.asarray(n, jnp.int32))
    return jax.lax.shift_left(x, n)


def _lsr_safe(x, n):
    """Logical shift right; n in [0, 32] (32 -> 0)."""
    return jnp.where(n >= 32, 0, _lsr(x, jnp.minimum(n, 31)))


def _shl_safe(x, n):
    """Shift left; n in [0, 32] (32 -> 0)."""
    return jnp.where(n >= 32, 0, _shl(x, jnp.minimum(n, 31)))


def _gather(table, idx, size: int):
    """table[idx] for a ref (in a kernel) or an array, idx clamped in range."""
    return table[jnp.clip(idx, 0, size - 1)]


# ------------------------------------------------------------ decode core
# The bit reader of each lane: a 64-bit window (hi, lo), the bits it
# holds, and the index of the next word to load.
def refill(hi, lo, navail, wp, fetch):
    """Top the window back above 32 bits with one word, where needed."""
    w = fetch(wp)
    need = navail <= 32
    hi = jnp.where(need, hi | _lsr_safe(w, navail), hi)
    lo = jnp.where(need, lo | _shl_safe(w, 32 - navail), lo)
    navail = jnp.where(need, navail + 32, navail)
    wp = jnp.where(need, wp + 1, wp)
    return hi, lo, navail, wp


def consume(hi, lo, navail, n):
    """Advance by n bits per lane (0 <= n <= 31)."""
    hi = _shl_safe(hi, n) | _lsr_safe(lo, 32 - n)
    lo = _shl_safe(lo, n)
    return hi, lo, navail - n


def decode_symbol(hi, tbl, tables):
    """Canonical Huffman decode from the top 16 bits of ``hi``.

    ``tbl`` is the table row (``image * 8 + slot``), a scalar or one per
    lane; ``tables`` the flat (cbase, counts, symbols) refs or arrays.
    Returns (symbol, code_len); code_len > 16 marks an invalid code.
    """
    cbase, counts, symbols = tables
    n_rows = cbase.shape[0] // 16
    lengths = jnp.arange(1, 17, dtype=jnp.int32)
    row = tbl if jnp.ndim(tbl) == 0 else tbl[:, None]
    cb = _gather(cbase, row * 16 + lengths - 1, n_rows * 16)
    ct = _gather(counts, row * 17 + lengths - 1, n_rows * 17)
    top = _lsr(hi[:, None], 32 - lengths[None, :])
    rank = jnp.sum(jnp.clip(top - cb, 0, ct), axis=1)
    idx = jnp.clip(rank - 1, 0, 255)
    word = _gather(symbols, tbl * SYMBOL_WORDS + _lsr(idx, 1), n_rows * SYMBOL_WORDS)
    ent = _lsr(word, (idx & 1) * 16) & 0xFFFF
    # Invalid windows saturate the rank at the last real code, so they
    # need their own check: beyond every codeword iff the (unsigned)
    # window is >= the table's scaled first-unassigned code.
    lim = _gather(counts, tbl * 17 + 16, n_rows * 17)
    bad = (hi ^ jnp.int32(_INT_MIN)) >= lim
    ln = jnp.where(bad, 17, _lsr(ent, 8))
    return ent & 0xFF, ln


def extract_extend(hi, ln, size):
    """Amplitude bits at [ln, ln+size) of the window, EXTENDed (F.2.2.1)."""
    raw = _lsr_safe(_shl(hi, jnp.minimum(ln, 31)), 32 - size)
    half = _shl(1, jnp.maximum(size - 1, 0))
    full = _shl(1, jnp.minimum(size, 30))
    neg = jnp.logical_and(size > 0, raw < half)
    return jnp.where(neg, raw - full + 1, raw)


def _decode_segments(ctx, seg, img, n_steps, out):
    """Decode every block step of the segments ``seg`` (one per lane).

    ``ctx`` supplies the inputs (refs in the kernel, arrays in the plain
    version) and ``scatter(out, idx, val, mask) -> out``.  ``img`` is the
    image of each lane (scalar in the kernel: a program never straddles a
    1024-segment batch).  Returns (err, out).
    """
    nw = ctx.nw
    zero = jnp.zeros(seg.shape, jnp.int32)
    b = seg // SEGMENTS_PER_BATCH
    lane_off = b * (nw * SEGMENTS_PER_BATCH) + seg % SEGMENTS_PER_BATCH
    n_words = ctx.streams.shape[0]

    def fetch(wp):
        word = _gather(ctx.streams, lane_off + wp * SEGMENTS_PER_BATCH, n_words)
        return jnp.where(wp < nw, word, 0)

    n_img = ctx.seg_meta.shape[0] // 3
    last_seg = (
        _gather(ctx.seg_meta, img * 3, 3 * n_img) * SEGMENTS_PER_BATCH
        + _gather(ctx.seg_meta, img * 3 + 1, 3 * n_img)
    )
    last_steps = _gather(ctx.seg_meta, img * 3 + 2, 3 * n_img)
    tbl_base = img * N_SLOTS
    n_t = ctx.comp_map.shape[0]

    def step(t, carry):
        hi, lo, navail, wp, d0, d1, d2, d3, err, out = carry
        comp = _gather(ctx.comp_map, t, n_t)
        dtbl = tbl_base + _gather(ctx.dcslot, t, n_t)
        atbl = tbl_base + _gather(ctx.acslot, t, n_t)
        base = (seg * n_steps + t) * 64

        # ---- DC ----
        hi, lo, navail, wp = refill(hi, lo, navail, wp, fetch)
        sym, ln = decode_symbol(hi, dtbl, ctx.tables)
        bad_dc = jnp.logical_or(ln > 16, sym > 15)
        size = jnp.minimum(sym, 15)
        diff = jnp.where(bad_dc, 0, extract_extend(hi, ln, size))
        hi, lo, navail = consume(
            hi, lo, navail, jnp.where(bad_dc, 0, ln + size)
        )
        pred = jnp.where(
            comp == 0, d0, jnp.where(comp == 1, d1, jnp.where(comp == 2, d2, d3))
        )
        dc = pred + diff
        d0, d1, d2, d3 = (
            jnp.where(comp == i, dc, d) for i, d in enumerate((d0, d1, d2, d3))
        )
        out = ctx.scatter(out, base, dc, seg >= 0)
        step_err = jnp.where(bad_dc, ERR_BAD_CODE, 0)

        # ---- AC: one symbol per iteration until no lane is active ----
        def ac_cond(c):
            return jnp.max(c[5]) > 0

        def ac_body(c):
            hi, lo, navail, wp, k, active, e, out = c
            act = active > 0
            hi, lo, navail, wp = refill(hi, lo, navail, wp, fetch)
            sym, ln = decode_symbol(hi, atbl, ctx.tables)
            bad = jnp.logical_and(act, ln > 16)
            sym = jnp.where(bad, 0, sym)  # treat as EOB to make progress
            run = _lsr(sym, 4)
            size = sym & 15
            coded = jnp.logical_and(act, sym != 0)
            # size 0 is only legal as EOB (0x00) or ZRL (0xF0).
            badsym = jnp.logical_and(
                coded, jnp.logical_and(size == 0, run != 15)
            )
            newk = k + run + 1
            over = jnp.logical_and(coded, newk > 63)
            write = jnp.logical_and(
                jnp.logical_and(coded, size > 0), jnp.logical_not(over)
            )
            val = extract_extend(hi, ln, size)
            pos = _gather(ctx.zigzag, newk, 64)
            out = ctx.scatter(out, base + pos, val, write)
            hi, lo, navail = consume(
                hi, lo, navail,
                jnp.where(jnp.logical_and(act, jnp.logical_not(bad)), ln + size, 0),
            )
            k = jnp.where(coded, jnp.minimum(newk, 63), k)
            still = jnp.logical_and(coded, k < 63)
            still = jnp.logical_and(still, jnp.logical_not(over))
            still = jnp.logical_and(still, jnp.logical_not(badsym))
            e = (
                e
                | jnp.where(jnp.logical_or(bad, badsym), ERR_BAD_CODE, 0)
                | jnp.where(over, ERR_OVERRUN, 0)
            )
            return hi, lo, navail, wp, k, still.astype(jnp.int32), e, out

        active = jnp.logical_not(bad_dc).astype(jnp.int32)
        hi, lo, navail, wp, _, _, step_err, out = jax.lax.while_loop(
            ac_cond, ac_body, (hi, lo, navail, wp, zero, active, step_err, out)
        )
        # The last segment of an image may be short: its padded block
        # steps decode 1-padding, whose flags are meaningless.  Suppress
        # exactly those so the flags are exact for every segment.
        tail = jnp.logical_and(seg == last_seg, t >= last_steps)
        err = err | jnp.where(tail, 0, step_err)
        return hi, lo, navail, wp, d0, d1, d2, d3, err, out

    init = (zero,) * 9 + (out,)
    carry = jax.lax.fori_loop(0, n_steps, step, init)
    return carry[8], carry[9]


class _Inputs:
    """The decode inputs, as flat refs (kernel) or flat arrays (plain)."""

    def __init__(self, nw, streams, img_of_batch, comp_map, dcslot, acslot,
                 seg_meta, cbase, counts, symbols, zigzag, scatter):
        self.nw = nw
        self.streams = streams
        self.img_of_batch = img_of_batch
        self.comp_map = comp_map
        self.dcslot = dcslot
        self.acslot = acslot
        self.seg_meta = seg_meta
        self.tables = (cbase, counts, symbols)
        self.zigzag = zigzag
        self.scatter = scatter


def _kernel_scatter(out_ref):
    def scatter(out, idx, val, mask):
        pltriton.store(out_ref.at[idx], val.astype(out_ref.dtype), mask=mask)
        return out
    return scatter


def _entropy_kernel(nw, n_steps, streams_ref, img_ref, comp_ref, dcslot_ref,
                    acslot_ref, meta_ref, cbase_ref, counts_ref, symbols_ref,
                    zz_ref, _zeros_ref, out_ref, err_ref):
    seg0 = pl.program_id(0) * _LANES
    seg = seg0 + jnp.arange(_LANES, dtype=jnp.int32)
    img = img_ref[seg0 // SEGMENTS_PER_BATCH]
    ctx = _Inputs(
        nw, streams_ref, img_ref, comp_ref, dcslot_ref, acslot_ref, meta_ref,
        cbase_ref, counts_ref, symbols_ref, zz_ref, _kernel_scatter(out_ref),
    )
    err, _ = _decode_segments(ctx, seg, img, n_steps, None)
    err_ref[seg] = err


def _flat_inputs(streams, img_of_batch, comp_map, dcslot, acslot, seg_meta,
                 cbase, counts, symbols):
    return (
        streams.reshape(-1),
        img_of_batch.astype(jnp.int32),
        comp_map, dcslot, acslot,
        seg_meta.reshape(-1),
        cbase.reshape(-1), counts.reshape(-1), symbols.reshape(-1),
        jnp.asarray(ZIGZAG, jnp.int32),
    )


def _decode_kernel(nw, n_steps, n_seg, flat, interpret):
    out_shape = (
        jax.ShapeDtypeStruct((n_seg * n_steps * 64,), jnp.int16),
        jax.ShapeDtypeStruct((n_seg,), jnp.int32),
    )
    zeros = jnp.zeros((n_seg * n_steps * 64,), jnp.int16)
    return pl.pallas_call(
        functools.partial(_entropy_kernel, nw, n_steps),
        out_shape=out_shape,
        grid=(n_seg // _LANES,),
        # Only coded positions are scattered: the output starts as zeros.
        input_output_aliases={len(flat): 0},
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="entropy_decode",
    )(*flat, zeros)


def _decode_plain(nw, n_steps, n_seg, flat):
    streams, img_of_batch = flat[0], flat[1]
    size = n_seg * n_steps * 64

    def scatter(out, idx, val, mask):
        return out.at[jnp.where(mask, idx, size)].set(
            val.astype(jnp.int16), mode="drop"
        )

    ctx = _Inputs(nw, *flat, scatter)
    seg = jnp.arange(n_seg, dtype=jnp.int32)
    img = img_of_batch[seg // SEGMENTS_PER_BATCH]
    err, out = _decode_segments(
        ctx, seg, img, n_steps, jnp.zeros((size,), jnp.int16)
    )
    return out, err


def decode_segments_device_multi(
    streams: jax.Array,       # (B, NW, 1024) int32
    img_of_batch: jax.Array,  # (B,) int32: image index of segment batch b
    comp_map: jax.Array,      # (T,) int32: frame component of block step t
    dcslot_map: jax.Array,    # (T,) int32
    acslot_map: jax.Array,    # (T,) int32
    seg_meta: jax.Array,      # (NI, 3) int32: last segment (batch, lane, steps)
    cbase: jax.Array,         # (NI, 8, 16) int32
    counts: jax.Array,        # (NI, 8, 17) int32 (slot 16: invalid limit)
    symbols: jax.Array,       # (NI, 8, 128) int32, (sym|len<<8) 2/word
    interpret: Optional[bool] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Device entropy decode with per-image Huffman tables.

    A corpus batch stacks every image's segment batches on the leading
    axis; ``img_of_batch`` routes each batch to its image's tables (the
    block-step maps are shared -- same geometry bucket).

    Returns (coefs, err): coefs (B*1024, T, 64) int16 natural-order, err
    (B*1024,) int32 per-segment error flags (0 = clean).
    """
    b, nw = streams.shape[0], streams.shape[1]
    n_steps = comp_map.shape[0]
    n_seg = b * SEGMENTS_PER_BATCH
    flat = _flat_inputs(
        streams, img_of_batch, comp_map, dcslot_map, acslot_map, seg_meta,
        cbase, counts, symbols,
    )
    how = route_mod.route(interpret, op=ROUTE_OP)
    if how == route_mod.PLAIN:
        out, err = _decode_plain(nw, n_steps, n_seg, flat)
    else:
        out, err = _decode_kernel(
            nw, n_steps, n_seg, flat, how == route_mod.INTERPRET
        )
    return out.reshape(n_seg, n_steps, 64), err


def decode_segments_device(
    streams: jax.Array,       # (B, NW, 1024) int32
    comp_map: jax.Array,      # (T,) int32
    dcslot_map: jax.Array,    # (T,) int32
    acslot_map: jax.Array,    # (T,) int32
    seg_meta: jax.Array,      # (3,) int32: last segment (batch, lane, steps)
    cbase: jax.Array,         # (8, 16) int32
    counts: jax.Array,        # (8, 17) int32 (slot 16: invalid limit)
    symbols: jax.Array,       # (8, 128) int32, (sym|len<<8) 2/word
    interpret: Optional[bool] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Single-image device entropy decode (tables: DeviceScanPlan.kernel_tables).

    Returns (coefs, err) as decode_segments_device_multi.
    """
    b = streams.shape[0]
    return decode_segments_device_multi(
        streams,
        jnp.zeros((b,), jnp.int32),
        comp_map, dcslot_map, acslot_map, seg_meta[None],
        cbase[None], counts[None], symbols[None],
        interpret=interpret,
    )


@jax.jit
def apply_dc_base(kernel_out, dc_base, comp_map):
    """Add per-pseudo-segment DC predictor bases (DRI-less streams).

    A pseudo restart segment (host/segments.py:build_plan_no_dri) starts
    mid-stream, so its true DC predictors are the running values the
    index scan recorded -- the decoder started from 0, which offsets every
    block's cumulative DC in the segment by exactly the base.

    kernel_out (S, T, 64) int16; dc_base (S, C) int32; comp_map (T,)
    int32 (frame component of block step t).
    """
    add = jnp.take(dc_base, comp_map, axis=1).astype(jnp.int16)  # (S, T)
    return kernel_out.at[:, :, 0].add(add)


def assemble_components(
    kernel_out: jax.Array,          # (S, T, 64) int16
    n_segments: int,
    mcus_per_segment: int,
    n_mcus: int,
    nhmb: int,
    nvmb: int,
    comp_geometry: Tuple[Tuple[int, int], ...],  # per SCAN comp (hsamp, vsamp)
    frame_order: Optional[Tuple[int, ...]] = None,
):
    """Decoder output -> per-component (vb, hb, 8, 8) coefficient tensors.

    The decoder output is already MCU-major: segment s, block step t is
    MCU ``s*R + t // bpm``, block ``t % bpm`` of the MCU (components in
    scan order, sub-blocks row-major).  Components with one block per MCU
    are a reshape; sampled components interleave their (vs, hs) blocks
    into block rows.  ``frame_order`` (the scan's ``comp_idx``) reorders
    the tuple to frame positions for out-of-order scans.
    """
    t = kernel_out.shape[-2]
    bpm = sum(hs * vs for hs, vs in comp_geometry)
    assert t == mcus_per_segment * bpm
    lead = kernel_out.shape[:-3]
    x = kernel_out[..., :n_segments, :, :]
    x = x.reshape(lead + (n_segments * mcus_per_segment, bpm, 64))
    x = x[..., :n_mcus, :, :]
    nl = len(lead)
    out = []
    off = 0
    for hs, vs in comp_geometry:
        nb = hs * vs
        yc = x[..., off : off + nb, :]
        off += nb
        yc = yc.reshape(lead + (nvmb, nhmb, vs, hs, 64))
        if nb > 1:
            yc = yc.transpose(
                tuple(range(nl)) + (nl, nl + 2, nl + 1, nl + 3, nl + 4)
            )
        out.append(yc.reshape(lead + (nvmb * vs, nhmb * hs, 8, 8)))
    if frame_order is not None:
        out = scan_to_frame_order(out, frame_order)
    return tuple(out)


def zero_flagged(kernel_out, err):
    """Blank the coefficients of flagged segments (on_error="zero"): the
    damage stays inside the restart boundary."""
    return jnp.where((err != 0)[:, None, None], jnp.int16(0), kernel_out)

