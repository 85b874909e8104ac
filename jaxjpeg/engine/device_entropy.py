"""Engine glue: parsed JPEG -> on-device entropy decode -> coefficients.

Combines the host-side stream packing (host/segments.py), the device
decoder (ops/entropy_device.py) and the assembly into the QUANT-stage
contract the pixel pipeline consumes: the host ships entropy bits; the
device does everything else.

Inputs the device path cannot take go to the host entropy decoder with
identical output -- a documented contract, not an error.  Each such
fallback is counted in ``FALLBACKS`` by reason, so a caller that needs
the device path (a benchmark, a chip check) can tell that it ran.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jaxjpeg.errors import JpegFormatError, JpegUnsupportedError
from jaxjpeg.host.parser import ParsedJpeg
from jaxjpeg.host.segments import build_plan_auto, build_spec_scan_input
from jaxjpeg.ops import entropy_device
from jaxjpeg.utils.logging import get_logger

log = get_logger("engine")

# Fallbacks from the device path to the host, by reason:
#   "plan_rejected": the device planner refused the stream (host entropy);
#   "scan_not_converged": the device index scan did not converge (serial
#     host index scan, then device decode).
FALLBACKS: collections.Counter = collections.Counter()


def note_fallback(reason: str, detail: object = "") -> None:
    FALLBACKS[reason] += 1
    log.info("device entropy fallback: %s %s", reason, detail)


@dataclasses.dataclass
class DeviceEntropyResult:
    coefs: Tuple[jax.Array, ...]  # per comp (vb, hb, 8, 8) int16, on device
    err: jax.Array                # (S,) int32 per-segment error flags
    # Device index scan runs only: (rounds, MCU starts found).
    specsync_stats: Optional[np.ndarray] = None


@functools.partial(
    jax.jit,
    static_argnames=("sb", "n_mcus", "nw", "spw", "nws", "t_last",
                     "max_rounds", "interpret"),
)
def _spec_decode_kernel_out(
    windows, nbits, dcslot_c, acslot_c,
    comp_map, dcslot_map, acslot_map, seg_meta, cbase, counts, symbols,
    *, sb, n_mcus, nw, spw, nws, t_last, max_rounds, interpret,
):
    """One program: device index scan -> on-device stream realign ->
    restart decode -> derived DC bases.  Returns (kernel_out, err, ok,
    stats); outputs are garbage unless ok (the caller falls back)."""
    from jaxjpeg.ops import specsync_device

    bitpos, ok, stats = specsync_device.device_index_scan(
        windows, nbits, dcslot_c, acslot_c, cbase, counts, symbols,
        sb=sb, n_mcus=n_mcus, max_rounds=max_rounds, interpret=interpret,
    )
    # Row-width check: every pseudo segment (plus its worst-case one-word
    # refill overshoot) must fit the nw-word rows the gather builds, or
    # the decode would read zeros mid-segment.  Folded into ok -> the
    # caller falls back.
    seg_bits = jnp.diff(bitpos, append=nbits.astype(jnp.int32))
    ok = jnp.logical_and(ok, jnp.max(seg_bits) + 63 <= nw * 32)
    streams = specsync_device.gather_entropy_streams(
        windows, bitpos, nw=nw, spw=spw, nws=nws
    )
    out, err = entropy_device.decode_segments_device(
        streams, comp_map, dcslot_map, acslot_map, seg_meta,
        cbase, counts, symbols, interpret=interpret,
    )
    dcb = specsync_device.dc_base_from_coefs(out, t_last)
    out = entropy_device.apply_dc_base(out, dcb, comp_map)
    return out, err, ok, stats


def _specsync_enabled() -> bool:
    return os.environ.get("JAXJPEG_SPECSYNC", "1") != "0"


def _uses_index_scan(parsed: ParsedJpeg, specsync: Optional[bool]) -> bool:
    header = parsed.header
    if specsync is None:
        specsync = _specsync_enabled()
    return bool(
        specsync
        and not header.restart_interval
        and len(parsed.segments) == 1
        and header.n_mcus >= 2
    )


def _spec_decode_try(parsed: ParsedJpeg, interpret):
    """DRI-less decode via the device parallel index scan.

    Returns (kernel_out, err, stats) with the DC bases already applied,
    or None when the scan did not converge or the stream is out of range
    -- the caller then falls back to the serial host scan
    (build_plan_auto)."""
    try:
        inp = build_spec_scan_input(parsed)
    except JpegUnsupportedError as e:
        note_fallback("scan_not_converged", e)
        return None
    out, err, ok, stats = _spec_decode_kernel_out(
        jnp.asarray(inp.windows),
        jnp.asarray(np.array([inp.n_bits], np.int32)),
        jnp.asarray(inp.dcslot_of_c),
        jnp.asarray(inp.acslot_of_c),
        jnp.asarray(inp.comp_of_step),
        jnp.asarray(inp.dc_slot_of_step),
        jnp.asarray(inp.ac_slot_of_step),
        jnp.asarray(inp.seg_meta),
        jnp.asarray(inp.cbase),
        jnp.asarray(inp.counts),
        jnp.asarray(inp.symbols),
        sb=inp.subseq_bytes, n_mcus=inp.n_mcus, nw=inp.nw, spw=inp.spw,
        nws=inp.nws, t_last=inp.t_last, max_rounds=16, interpret=interpret,
    )
    if not bool(ok):
        note_fallback("scan_not_converged", np.asarray(stats))
        return None
    return out, err, np.asarray(stats)


def entropy_decode_device(
    parsed: ParsedJpeg,
    interpret: Optional[bool] = None,
    check_errors: bool = True,
    on_error: str = "raise",
    specsync: Optional[bool] = None,
) -> DeviceEntropyResult:
    """Decode the scan's restart segments on the device.

    ``on_error`` makes restart segments the fault-isolation boundary the
    format designed them to be (SURVEY.md section 5): "raise" aborts on
    any flagged segment (the reference's behaviour, ctx->error); "zero"
    salvages the image -- corrupt segments decode to zero coefficients
    (flat gray blocks) while every other segment is unaffected.

    DRI-less streams default to the DEVICE parallel index scan
    (ops/specsync_device.py): the host only destuffs and uploads window
    rows, and pseudo-segment boundaries, stream realignment and DC bases
    are all computed on the device.  Non-convergence falls back to the
    serial host scan transparently.  ``specsync=False`` (or env
    JAXJPEG_SPECSYNC=0) forces the host-scan path.
    """
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be 'raise' or 'zero', got {on_error!r}")
    header = parsed.header
    comp_geometry = tuple(
        (header.components[i].hsamp, header.components[i].vsamp)
        for i in header.scan.comp_idx
    )
    spec_stats = None
    spec_result = None
    if _uses_index_scan(parsed, specsync):
        spec_result = _spec_decode_try(parsed, interpret)
    if spec_result is not None:
        kernel_out, err, spec_stats = spec_result
        plan_nseg, plan_mps = header.n_mcus, 1
        kind = "pseudo segment"
    else:
        plan = build_plan_auto(parsed)
        plan_nseg, plan_mps = plan.n_segments, plan.mcus_per_segment
        kind = "restart segment" if plan.dc_base is None else "pseudo segment"
        kernel_out, err = entropy_device.decode_segments_device(
            jnp.asarray(plan.streams),
            *(jnp.asarray(x) for x in plan.kernel_tables),
            interpret=interpret,
        )
        if plan.dc_base is not None:
            # DRI-less pseudo segments: restore the DC predictor
            # continuation the index scan recorded (before salvage, so
            # zeroed segments stay flat gray).
            kernel_out = entropy_device.apply_dc_base(
                kernel_out,
                jnp.asarray(_pad_rows(plan.dc_base, kernel_out.shape[0])),
                jnp.asarray(plan.comp_of_step),
            )
    if on_error == "zero":
        kernel_out = entropy_device.zero_flagged(kernel_out, err)
    coefs = _assemble(
        kernel_out,
        plan_nseg,
        plan_mps,
        header.n_mcus,
        header.nhmb,
        header.nvmb,
        comp_geometry,
        header.scan.comp_idx,
    )
    if check_errors and on_error == "raise":
        # Flags are exact for every segment (the decoder suppresses the
        # spurious tail flags of a short last segment itself).
        _raise_on_flags(np.asarray(err)[:plan_nseg], kind)
    return DeviceEntropyResult(coefs=coefs, err=err, specsync_stats=spec_stats)


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + x.shape[1:], dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _raise_on_flags(flags: np.ndarray, kind: str) -> None:
    if flags.any():
        bad = int(np.flatnonzero(flags)[0])
        raise JpegFormatError(
            f"device entropy decode failed in {kind} {bad} "
            f"(flags={int(flags[bad])})"
        )


@functools.partial(jax.jit, static_argnums=range(1, 8))
def _assemble(
    kernel_out, n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom,
    frame_order=None,
):
    return entropy_device.assemble_components(
        kernel_out,
        n_segments=n_segments,
        mcus_per_segment=mcus_per_segment,
        n_mcus=n_mcus,
        nhmb=nhmb,
        nvmb=nvmb,
        comp_geometry=geom,
        frame_order=frame_order,
    )


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _expand_pack(entries, block_starts, n_mcus, nhmb, nvmb, geom, frame_order):
    from jaxjpeg.ops import pack_device

    bpm = sum(hs * vs for hs, vs in geom)
    blocks = pack_device.expand_pack(entries, block_starts)
    return entropy_device.assemble_components(
        blocks.reshape(n_mcus, bpm, 64), n_mcus, 1, n_mcus, nhmb, nvmb,
        geom, frame_order,
    )


def expand_pack_device(parsed: ParsedJpeg, scan) -> Tuple[jax.Array, ...]:
    """PACK-upload path: ship (run,value) entries, expand to coefs on device.

    ``scan`` is a host ScanResult with ``want_pack=True``.  Covers streams
    without restart markers (the host did the Huffman work); minimises
    host->device bytes like the reference's pack mode (jpeg_gpu.c:1287).
    """
    from jaxjpeg.host.pack_plan import build_pack_plan

    header = parsed.header
    plan = build_pack_plan(parsed, scan)
    geom = tuple(
        (header.components[i].hsamp, header.components[i].vsamp)
        for i in header.scan.comp_idx
    )
    return _expand_pack(
        jnp.asarray(plan.entries), jnp.asarray(plan.block_starts),
        header.n_mcus, header.nhmb, header.nvmb, geom, header.scan.comp_idx,
    )


def _spec_decode_sharded_try(
    parsed: ParsedJpeg, mesh, exact, upsample, check_errors
) -> Optional[np.ndarray]:
    """Distributed DRI-less decode via the replicated device index scan.

    Returns the cropped RGB array, or None when the scan did not
    converge / the stream is out of range (the caller then runs the
    serial host-scan path)."""
    from jaxjpeg.engine import pipeline
    from jaxjpeg.parallel.shard import decode_image_device_sharded_spec

    header = parsed.header
    try:
        inp = build_spec_scan_input(parsed)
    except JpegUnsupportedError as e:
        note_fallback("scan_not_converged", e)
        return None
    spec = pipeline.PipelineSpec.from_header(
        header, exact=exact, upsample=upsample
    )
    geom = tuple(
        (header.components[i].hsamp, header.components[i].vsamp)
        for i in header.scan.comp_idx
    )
    assemble_args = (
        header.n_mcus, 1, header.n_mcus, header.nhmb, header.nvmb, geom,
        header.scan.comp_idx,
    )
    scan_cfg = (inp.subseq_bytes, inp.nw, inp.spw, inp.nws, inp.t_last)
    qtables = tuple(
        jnp.asarray(header.quant_for(c).values.astype(np.int32))
        for c in header.components
    )
    rgb, err, ok = decode_image_device_sharded_spec(
        spec, mesh, assemble_args, scan_cfg,
        jnp.asarray(inp.windows),
        jnp.asarray(np.array([inp.n_bits], np.int32)),
        (jnp.asarray(inp.dcslot_of_c), jnp.asarray(inp.acslot_of_c)),
        tuple(
            jnp.asarray(x)
            for x in (
                inp.comp_of_step, inp.dc_slot_of_step, inp.ac_slot_of_step,
                inp.seg_meta, inp.cbase, inp.counts, inp.symbols,
            )
        ),
        qtables,
    )
    if not bool(ok):
        note_fallback("scan_not_converged", "sharded")
        return None
    if check_errors:
        _raise_on_flags(np.asarray(err)[: header.n_mcus], "pseudo segment")
    return np.asarray(rgb)[: header.height, : header.width]


def decode_image_device_sharded(
    parsed: ParsedJpeg,
    mesh,
    exact: bool = True,
    upsample: str = "nearest",
    check_errors: bool = True,
    specsync: Optional[bool] = None,
) -> np.ndarray:
    """Distributed fully-on-device decode of one image.

    Restart-segment batches shard over the mesh's data axis, coefficients
    are all_gathered, and the pixel pipeline splits MCU rows over the
    space axis (parallel/shard.py:decode_image_device_sharded).  Returns
    the cropped RGB array.

    DRI-less streams default to the DEVICE parallel index scan run
    replicated per device (parallel/shard.py:
    decode_image_device_sharded_spec) -- no serial host scan in the
    distributed path either; non-convergence falls back to it.
    """
    from jaxjpeg.engine import pipeline
    from jaxjpeg.parallel.mesh import DATA_AXIS
    from jaxjpeg.parallel.shard import (
        decode_image_device_sharded as _sharded,
    )

    header = parsed.header
    if _uses_index_scan(parsed, specsync):
        rgb = _spec_decode_sharded_try(
            parsed, mesh, exact, upsample, check_errors
        )
        if rgb is not None:
            return rgb
    plan = build_plan_auto(parsed)
    data_size = mesh.shape[DATA_AXIS]
    streams = plan.streams
    pad = (-streams.shape[0]) % data_size
    if pad:  # dummy batches decode 1-padding garbage; flagged + ignored
        filler = np.full(
            (pad,) + streams.shape[1:], -1, dtype=streams.dtype
        )
        streams = np.concatenate([streams, filler])
    n_slots = streams.shape[0] * entropy_device.SEGMENTS_PER_BATCH
    dcb = None
    if plan.dc_base is not None:
        # DRI-less pseudo segments: per-segment DC bases ride the same
        # data sharding as the streams.
        dcb = jnp.asarray(_pad_rows(plan.dc_base, n_slots))
    plan_tables = tuple(jnp.asarray(x) for x in plan.kernel_tables)
    geom = tuple(
        (header.components[i].hsamp, header.components[i].vsamp)
        for i in header.scan.comp_idx
    )
    spec = pipeline.PipelineSpec.from_header(header, exact=exact, upsample=upsample)
    assemble_args = (
        plan.n_segments, plan.mcus_per_segment, header.n_mcus,
        header.nhmb, header.nvmb, geom, header.scan.comp_idx,
    )
    qtables = tuple(
        jnp.asarray(header.quant_for(c).values.astype(np.int32))
        for c in header.components
    )
    rgb, err = _sharded(
        spec, mesh, assemble_args, jnp.asarray(streams), plan_tables,
        qtables, dcb,
    )
    if check_errors:
        kind = "restart segment" if plan.dc_base is None else "pseudo segment"
        _raise_on_flags(np.asarray(err)[: plan.n_segments], kind)
    return np.asarray(rgb)[: header.height, : header.width]


def decode_image_device(
    parsed: ParsedJpeg,
    stage="rgb",
    exact: bool = True,
    upsample: str = "nearest",
    interpret: Optional[bool] = None,
    on_error: str = "raise",
):
    """Fully on-device decode: entropy bits in device memory -> pixels.

    The host only parses markers and packs destuffed segment words;
    Huffman decode, dequant, IDCT, upsample and color conversion all run
    on the device with no intermediate host round-trip.
    """
    from jaxjpeg.engine import pipeline
    from jaxjpeg.engine.stages import OutputStage

    header = parsed.header
    spec = pipeline.PipelineSpec.from_header(header, exact=exact, upsample=upsample)
    stage = stage if isinstance(stage, OutputStage) else OutputStage(stage)
    result = entropy_decode_device(
        parsed, interpret=interpret, on_error=on_error
    )
    if stage == OutputStage.QUANT:
        return result.coefs
    qtables = tuple(
        header.quant_for(c).values.astype(np.int32) for c in header.components
    )
    return pipeline.run(spec, stage, result.coefs, qtables)
