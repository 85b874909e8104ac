"""Self-synchronising parallel index scan on the device.

A stream without restart markers is one serial Huffman chain: to decode
it in parallel the device first has to find where every MCU starts.  This
module finds those bit offsets on the device (the parallel decode of
arXiv:2111.09219; numpy prototype and derivation in host/specsync.py), so
the host's only per-frame work is destuffing and one strided window copy.

Algorithm:

* The destuffed stream splits into S fixed-size subsequences (SB bytes),
  one per lane; lane ``g`` reads its own window row of ``NWS`` words.
* A Jacobi fixed-point iteration on subsequence ENTRY states (bit
  position, block-in-MCU phase c, at_dc, zigzag k): each round decodes
  every subsequence from its current entry to its first token boundary
  past the subsequence end; round r+1's entry of lane g+1 is round r's
  exit of lane g, with entry 0 pinned to the true scan start.  At the
  fixed point the chain IS the serial decode by induction; Huffman
  self-synchronisation only bounds how fast it arrives.  The rounds run
  as a ``lax.while_loop`` around the scan, so convergence is detected,
  not assumed.
* Each round also counts the MCU starts each lane passes.  After
  convergence an exclusive cumsum of those counts gives every lane the
  global index of its first MCU, and a final record pass scatters each
  MCU's start bit straight into ``bitpos``.
* No DC predictor sums are tracked: with one MCU per pseudo segment the
  restart decoder's own output holds each segment's total DC diff, so the
  DC bases are one exclusive cumsum of decoder output
  (``dc_base_from_coefs``).

The scan shares the bit reader and the canonical rank decode with the
restart decoder (ops/entropy_device.py); unlike it, the Huffman table is
chosen per lane, since lanes sit at arbitrary block phases.  Two
implementations of the same arithmetic: a Pallas kernel through Triton
(one lane per thread) and a plain ``jax.numpy`` version over all lanes,
chosen by ``ops/route.py``.

Failure handling: non-convergence within ``max_rounds`` or fewer MCU
starts than MCUs set ``ok=False``; the caller then falls back to the
serial native scan.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from jaxjpeg.ops import route as route_mod
from jaxjpeg.ops.entropy_device import (
    SEGMENTS_PER_BATCH,
    _gather,
    _lsr,
    _lsr_safe,
    _shl,
    _shl_safe,
    consume,
    decode_symbol,
    refill,
)

ROUTE_OP = "index_scan"  # this op's name in ops/route.py
_LANES = 32
_NUM_WARPS = 1


def _scan_lanes(ctx, lane, entry, first, bitpos):
    """One round over the lanes ``lane`` from their ``entry`` states.

    Returns (exit (p, c, at_dc, k), MCU starts passed, bitpos).  With
    ``first`` (the global MCU index of each lane's first start) the MCU
    starts are scattered into ``bitpos`` through ``ctx.scatter``.
    """
    sb_bits = ctx.sb * 8
    nws = ctx.nws
    n_words = ctx.windows.shape[0]
    bpm = ctx.dcslot.shape[0]
    # Lanes past the stream get end <= 0 and never activate.
    end = jnp.minimum(sb_bits, ctx.nbits - lane * sb_bits)
    lane_off = (
        (lane // SEGMENTS_PER_BATCH) * (nws * SEGMENTS_PER_BATCH)
        + lane % SEGMENTS_PER_BATCH
    )

    def fetch(wp):
        word = _gather(ctx.windows, lane_off + wp * SEGMENTS_PER_BATCH, n_words)
        return jnp.where(jnp.logical_and(wp >= 0, wp < nws), word, 0)

    p, c, at_dc, k = entry
    wp0 = _lsr(p, 5)
    sh = p & 31
    w0 = fetch(wp0)
    w1 = fetch(wp0 + 1)
    hi = _shl(w0, sh) | _lsr_safe(w1, 32 - sh)
    lo = _shl_safe(w1, sh)
    navail = 64 - sh
    wp = wp0 + 2
    zero = jnp.zeros(lane.shape, jnp.int32)
    lane_base = lane * sb_bits
    max_iters = sb_bits + 2  # every active step consumes >= 1 bit

    def cond(carry):
        it, p = carry[0], carry[1]
        return jnp.logical_and(it < max_iters, jnp.max((p < end).astype(jnp.int32)) > 0)

    def body(carry):
        it, p, c, at_dc, k, hi, lo, navail, wp, n, bitpos = carry
        act = p < end
        is_mcu = jnp.logical_and(jnp.logical_and(act, at_dc > 0), c == 0)
        if first is not None:
            bitpos = ctx.scatter(bitpos, first + n, lane_base + p, is_mcu)
        n = n + is_mcu.astype(jnp.int32)
        hi, lo, navail, wp = refill(hi, lo, navail, wp, fetch)
        slot = jnp.where(
            at_dc > 0, _gather(ctx.dcslot, c, bpm), _gather(ctx.acslot, c, bpm)
        )
        sym, ln = decode_symbol(hi, slot, ctx.tables)
        # Invalid codes consume 17 bits as EOB (any deterministic >= 1-bit
        # rule works off the true path); at most 31 bits per step.
        bad = ln > 16
        sym = jnp.where(bad, 0, sym)
        ln = jnp.where(bad, 17, ln)
        dc_size = jnp.minimum(sym, 15)
        run = _lsr(sym, 4)
        ac_size = sym & 15
        newk = k + run + 1
        blk_end = jnp.logical_and(
            at_dc == 0, jnp.logical_or(sym == 0, newk >= 63)
        )
        used = jnp.where(at_dc > 0, ln + dc_size, ln + ac_size)
        used = jnp.where(act, used, 0)
        hi, lo, navail = consume(hi, lo, navail, used)
        p = p + used
        k = jnp.where(
            jnp.logical_and(act, at_dc > 0),
            0,
            jnp.where(act, jnp.minimum(newk, 63), k),
        )
        newc = jnp.where(blk_end, c + 1, c)
        newc = jnp.where(newc == bpm, 0, newc)
        c = jnp.where(act, newc, c)
        at_dc = jnp.where(
            act, jnp.where(at_dc > 0, 0, blk_end.astype(jnp.int32)), at_dc
        )
        return it + 1, p, c, at_dc, k, hi, lo, navail, wp, n, bitpos

    carry = (jnp.int32(0), p, c, at_dc, k, hi, lo, navail, wp, zero, bitpos)
    carry = jax.lax.while_loop(cond, body, carry)
    _, p, c, at_dc, k, _, _, _, _, n, bitpos = carry
    return (p, c, at_dc, k), n, bitpos


class _Inputs:
    def __init__(self, sb, nws, nbits, windows, dcslot, acslot, cbase,
                 counts, symbols, scatter):
        self.sb = sb
        self.nws = nws
        self.nbits = nbits
        self.windows = windows
        self.dcslot = dcslot
        self.acslot = acslot
        self.tables = (cbase, counts, symbols)
        self.scatter = scatter


def _scan_kernel(sb, nws, record, nbits_ref, windows_ref, dcslot_ref,
                 acslot_ref, cbase_ref, counts_ref, symbols_ref, entry_ref,
                 first_ref, *out_refs):
    if record:
        _zeros_ref, exit_ref, n_ref, bitpos_ref = out_refs
    else:
        exit_ref, n_ref = out_refs
    n_lanes = n_ref.shape[0]
    lane = pl.program_id(0) * _LANES + jnp.arange(_LANES, dtype=jnp.int32)

    def scatter(bitpos, idx, val, mask):
        # The last _LANES slots are a dump: masked-off lanes address one
        # each, so no two lanes of a store share an address (the Pallas
        # interpreter writes masked-off lanes back with their old value).
        n_mcus = bitpos_ref.shape[0] - _LANES
        mask = jnp.logical_and(mask, idx < n_mcus)
        idx = jnp.where(mask, idx, n_mcus + lane % _LANES)
        pltriton.store(bitpos_ref.at[idx], val, mask=mask)
        return bitpos

    ctx = _Inputs(
        sb, nws, nbits_ref[0], windows_ref, dcslot_ref, acslot_ref,
        cbase_ref, counts_ref, symbols_ref, scatter,
    )
    entry = tuple(entry_ref[i * n_lanes + lane] for i in range(4))
    first = first_ref[lane] if record else None
    exit_state, n, _ = _scan_lanes(ctx, lane, entry, first, None)
    for i in range(4):
        exit_ref[i * n_lanes + lane] = exit_state[i]
    n_ref[lane] = n


def _scan_round(windows, entry, first, nbits, dcslot, acslot, cbase, counts,
                symbols, *, sb, n_mcus, record, how):
    """One round: (exit (4, S), counts (S,)[, bitpos (n_mcus,)])."""
    bs, nws = windows.shape[0], windows.shape[1]
    n_lanes = bs * SEGMENTS_PER_BATCH
    flat = (
        nbits, windows.reshape(-1), dcslot, acslot, cbase.reshape(-1),
        counts.reshape(-1), symbols.reshape(-1),
    )
    if how == route_mod.PLAIN:
        def scatter(bitpos, idx, val, mask):
            return bitpos.at[jnp.where(mask, idx, n_mcus)].set(val, mode="drop")

        ctx = _Inputs(sb, nws, nbits[0], *flat[1:], scatter)
        lane = jnp.arange(n_lanes, dtype=jnp.int32)
        bitpos = jnp.zeros((n_mcus,), jnp.int32) if record else None
        exit_state, n, bitpos = _scan_lanes(
            ctx, lane, tuple(entry), first if record else None, bitpos
        )
        out = (jnp.stack(exit_state), n)
        return out + (bitpos,) if record else out
    out_shape = [
        jax.ShapeDtypeStruct((4 * n_lanes,), jnp.int32),
        jax.ShapeDtypeStruct((n_lanes,), jnp.int32),
    ]
    args = flat + (entry.reshape(-1), first)
    aliases = {}
    if record:
        out_shape.append(jax.ShapeDtypeStruct((n_mcus + _LANES,), jnp.int32))
        aliases = {len(args): 2}
        args = args + (jnp.zeros((n_mcus + _LANES,), jnp.int32),)
    res = pl.pallas_call(
        functools.partial(_scan_kernel, sb, nws, record),
        out_shape=out_shape,
        grid=(n_lanes // _LANES,),
        input_output_aliases=aliases,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=how == route_mod.INTERPRET,
        name="index_scan_record" if record else "index_scan",
    )(*args)
    if record:
        return res[0].reshape(4, n_lanes), res[1], res[2][:n_mcus]
    return res[0].reshape(4, n_lanes), res[1]


def device_index_scan(
    windows: jax.Array,    # (BS, NWS, 1024) i32 per-lane word windows
    nbits: jax.Array,      # (1,) i32 real stream bits
    dcslot: jax.Array,     # (bpm,) i32 DC table slot of block phase c
    acslot: jax.Array,     # (bpm,) i32 AC table slot of block phase c
    cbase: jax.Array,      # (8, 16) i32
    counts: jax.Array,     # (8, 17) i32
    symbols: jax.Array,    # (8, 128) i32
    *,
    sb: int,
    n_mcus: int,
    max_rounds: int = 16,
    interpret: bool | None = None,
):
    """Parallel index scan: converged per-MCU bit offsets, on device.

    Returns (bitpos, ok, stats):
      bitpos (n_mcus,) i32 -- destuffed-stream bit offset of each MCU
        (garbage unless ok);
      ok () bool -- converged AND at least n_mcus MCU starts found (the
        caller falls back to the serial scan when False);
      stats (2,) i32 -- (rounds, MCU starts found).

    A pure function of device arrays and static config: safe inside a
    larger jit.
    """
    how = route_mod.route(interpret, op=ROUTE_OP)
    bs = windows.shape[0]
    n_lanes = bs * SEGMENTS_PER_BATCH
    sb_bits = sb * 8
    # Lanes at or past the stream end never decode; pin their entries to
    # the start state so the shift chain does not ripple the tail lane's
    # exit through the padding lanes (one per round), which would stall
    # the convergence check without changing any real state.
    live = (jnp.arange(n_lanes, dtype=jnp.int32) * sb_bits < nbits[0])[None, :]
    pin = jnp.array([0, 0, 1, 0], jnp.int32)[:, None]
    zeros = jnp.zeros((n_lanes,), jnp.int32)
    scan = functools.partial(
        _scan_round, windows, nbits=nbits, dcslot=dcslot, acslot=acslot,
        cbase=cbase, counts=counts, symbols=symbols, sb=sb, n_mcus=n_mcus,
        how=how,
    )

    def next_entry(exit_state):
        # Normalise dead k at DC boundaries, shift by one lane, re-base p
        # to the next lane's window, and pin lane 0.
        p, c, at_dc, k = exit_state
        k = jnp.where(at_dc > 0, 0, k)
        shifted = jnp.stack([p - sb_bits, c, at_dc, k])[:, :-1]
        shifted = jnp.concatenate([pin, shifted], axis=1)
        return jnp.where(live, shifted, pin)

    def round_body(carry):
        entry, _, _, rounds = carry
        exit_state, n = scan(entry, zeros, record=False)
        new_entry = next_entry(exit_state)
        changed = jnp.any(new_entry != entry)
        return new_entry, n, changed, rounds + 1

    def round_cond(carry):
        _, _, changed, rounds = carry
        return jnp.logical_and(changed, rounds < max_rounds)

    entry0 = jnp.broadcast_to(pin, (4, n_lanes))
    entry, n, changed, rounds = jax.lax.while_loop(
        round_cond, round_body, (entry0, zeros, jnp.bool_(True), jnp.int32(0))
    )
    # At the fixed point the last round ran from the converged entries, so
    # its per-lane MCU counts place every lane's starts globally.
    first = jnp.cumsum(n) - n
    total = jnp.sum(n)
    _, _, bitpos = scan(entry, first, record=True)
    ok = jnp.logical_and(jnp.logical_not(changed), total >= n_mcus)
    return bitpos, ok, jnp.stack([rounds, total])


def gather_entropy_streams(
    windows: jax.Array,   # (BS, NWS, 1024) i32
    bitpos: jax.Array,    # (n_mcus,) i32
    *,
    nw: int,
    spw: int,             # non-overlapping words per window row (SB // 4)
    nws: int,             # words per window row (spw + overlap)
) -> jax.Array:
    """Bit-aligned per-MCU streams for the restart decoder, built on device.

    One XLA gather pulls each pseudo segment's ``nw + 1`` words out of the
    uploaded window tensor starting at ``bitpos >> 5`` (the window rows'
    first ``spw`` words tile the destuffed stream exactly, so flat word W
    lives at [W // spw, W % spw] in lane layout), then a per-lane variable
    shift aligns bit ``bitpos & 31`` to bit 0.  Words past the window grid
    read as all 1-bits (the bit reader's padding contract).  Returns
    (B2, nw, 1024) i32, B2 = ceil(n_mcus / 1024); padding lanes replay
    segment 0 (their decodes are sliced off by assembly).
    """
    bs = windows.shape[0]
    n_mcus = bitpos.shape[0]
    b2 = -(-n_mcus // SEGMENTS_PER_BATCH)
    seg = jnp.pad(bitpos, (0, b2 * SEGMENTS_PER_BATCH - n_mcus))
    sh = seg & 31
    grid_words = bs * SEGMENTS_PER_BATCH * spw
    word = _lsr(seg, 5)[:, None] + jnp.arange(nw + 1, dtype=jnp.int32)[None, :]
    past = word >= grid_words
    word = jnp.minimum(word, grid_words - 1)
    g = word // spw
    w_in = word - g * spw
    flat_idx = (
        (g // SEGMENTS_PER_BATCH) * nws + w_in
    ) * SEGMENTS_PER_BATCH + g % SEGMENTS_PER_BATCH
    rows = jnp.take(windows.reshape(-1), flat_idx, axis=0)
    rows = jnp.where(past, -1, rows)                   # (S2, nw+1)
    aligned = _shl(rows[:, :nw], sh[:, None]) | _lsr_safe(
        rows[:, 1:], 32 - sh[:, None]
    )
    return aligned.reshape(b2, SEGMENTS_PER_BATCH, nw).transpose(0, 2, 1)


def dc_base_from_coefs(
    kernel_out: jax.Array,     # (S, T, 64) i16 restart-decoder output
    t_last: Tuple[int, ...],   # last block step of each scan component
) -> jax.Array:
    """Per-pseudo-segment DC predictor bases from the decode itself.

    With one MCU per pseudo segment the decoder accumulates DC diffs from
    0 within each segment, so component c's LAST block step carries the
    segment's total DC diff; the predictor entering segment m is the
    exclusive prefix sum over segment order -- exactly what the serial
    index scan records, with no extra decode work.  Returns (S, C) i32
    for entropy_device.apply_dc_base.
    """
    cols = []
    for t in t_last:
        tot = kernel_out[:, t, 0].astype(jnp.int32)
        cols.append(jnp.cumsum(tot) - tot)
    return jnp.stack(cols, axis=-1)
