"""Sharded batched decode: shard_map over the (data, space) mesh.

Decode of a batch of same-geometry images, images sharded over the ``data``
axis and MCU block rows sharded over the ``space`` axis.  Because nearest
chroma upsampling never crosses an MCU row (each output row reads exactly
one chroma row, yuv.fs.glsl:20 semantics), the steady-state pixel pipeline
needs **zero** inter-chip traffic -- the sharding is communication-free by
construction, which is the design goal (SURVEY.md section 7 step 5: make
boundary exchange the *only* inter-device traffic, then remove it).

The one collective in the step is a ``psum``-reduced decode checksum over
both axes: a cheap global integrity signature (sum of all output samples)
that validates cross-shard agreement and keeps a real collective in the
compiled program.  (The DC-boundary/halo exchanges arrive with the device
entropy decoder and fancy-upsampling modes, where real cross-shard
dependencies exist.)
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jaxjpeg.engine.pipeline import PipelineSpec
from jaxjpeg.ops import color as color_ops
from jaxjpeg.ops import idct as idct_ops
from jaxjpeg.ops import idct_islow
from jaxjpeg.parallel.mesh import DATA_AXIS, SPACE_AXIS


def _clamp_true_rows(plane, true_h: int, axis_name: str):
    """Replicate the last true sample row into the MCU padding rows.

    Fancy filters read neighbor rows, so the padding garbage below the true
    component height must be replaced by edge replication *before* halos are
    exchanged.  The clamp row always lives in the same shard as the padding
    (padding < one MCU row <= shard rows).
    """
    r = plane.shape[-2]
    base = jax.lax.axis_index(axis_name) * r
    iota = jnp.arange(r)
    local_limit = jnp.clip(true_h - 1 - base, 0, r - 1)
    idx = jnp.minimum(iota, local_limit)
    # Shards entirely above the boundary keep identity indices.
    idx = jnp.where(base + iota <= true_h - 1, iota, idx)
    return jnp.take(plane, idx, axis=-2)


def _fancy_v_halo(plane, axis_name: str):
    """Vertical triangle column sums with a one-row halo exchange.

    Returns the interleaved (.., 2r, w) 10-bit column sums (3*this + other)
    of the fancy h2v2/h1v2 vertical pass; the row above the shard's first
    row and below its last row arrive from the neighbor shards via
    ppermute -- the block-boundary exchange of BASELINE.json config #5.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    x = plane.astype(jnp.int32)
    if n == 1:
        above = jnp.concatenate([x[..., :1, :], x[..., :-1, :]], axis=-2)
        below = jnp.concatenate([x[..., 1:, :], x[..., -1:, :]], axis=-2)
    else:
        from_above = jax.lax.ppermute(
            x[..., -1:, :], axis_name, [(i, i + 1) for i in range(n - 1)]
        )
        from_below = jax.lax.ppermute(
            x[..., :1, :], axis_name, [(i + 1, i) for i in range(n - 1)]
        )
        top = jnp.where(idx == 0, x[..., :1, :], from_above)
        bot = jnp.where(idx == n - 1, x[..., -1:, :], from_below)
        above = jnp.concatenate([top, x[..., :-1, :]], axis=-2)
        below = jnp.concatenate([x[..., 1:, :], bot], axis=-2)
    sum_even = 3 * x + above
    sum_odd = 3 * x + below
    r, w = x.shape[-2], x.shape[-1]
    out = jnp.stack([sum_even, sum_odd], axis=-2)
    return out.reshape(x.shape[:-2] + (2 * r, w))


def _fancy_h_from_colsums(colsum, true_w: int):
    """Horizontal pass of the fancy filter on 10-bit column sums."""
    w = colsum.shape[-1]
    iota = jnp.arange(w)
    idx = jnp.minimum(iota, true_w - 1)
    cs = jnp.take(colsum, idx, axis=-1)  # replicate past the true width
    left = jnp.concatenate([cs[..., :1], cs[..., :-1]], axis=-1)
    right = jnp.concatenate([cs[..., 1:], cs[..., -1:]], axis=-1)
    even = (3 * cs + left + 8) >> 4
    odd = (3 * cs + right + 7) >> 4
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(cs.shape[:-1] + (2 * w,)).astype(jnp.uint8)


def _fancy_h1v2_from_colsums(colsum, true_w: int):
    """4:4:0 vertical-only fancy: finish the (3*this + other + 1|2)>>2."""
    iota = jnp.arange(colsum.shape[-1])
    idx = jnp.minimum(iota, true_w - 1)
    cs = jnp.take(colsum, idx, axis=-1)
    # Even output rows used rounding 1, odd rows rounding 2 (interleaved
    # by _fancy_v_halo): rebuild the per-row constant.
    r2 = cs.shape[-2]
    rounding = jnp.where(jnp.arange(r2)[:, None] % 2 == 0, 1, 2)
    return ((cs + rounding) >> 2).astype(jnp.uint8)


def _upsample_sharded(plane, spec: PipelineSpec, ci: int, axis_name: str):
    """Per-shard chroma upsample matching engine/pipeline.py semantics."""
    from jaxjpeg.ops.color import upsample_fancy_h2

    xdec, ydec = spec.comp_decs[ci]
    if spec.upsample != "fancy" or (xdec, ydec) == (0, 0):
        return color_ops.upsample_nearest(plane, xdec, ydec)
    cw, ch = spec.comp_sizes[ci]
    plane = _clamp_true_rows(plane, ch, axis_name)
    if (xdec, ydec) == (1, 1):
        colsum = _fancy_v_halo(plane, axis_name)
        return _fancy_h_from_colsums(colsum, cw)
    if (xdec, ydec) == (0, 1):
        colsum = _fancy_v_halo(plane, axis_name)
        return _fancy_h1v2_from_colsums(colsum, cw)
    if (xdec, ydec) == (1, 0):
        iota = jnp.arange(plane.shape[-1])
        p = jnp.take(plane, jnp.minimum(iota, cw - 1), axis=-1)
        return upsample_fancy_h2(p, axis=p.ndim - 1)
    return color_ops.upsample_nearest(plane, xdec, ydec)  # 4:1:1 replicates


def _local_decode_rgb(spec: PipelineSpec, coefs, qtables):
    """Decode this shard's (batch_shard, row_shard) slab to RGB samples.

    Works on MCU-aligned shards: every component's block rows split evenly
    because the space axis divides the MCU row count.  Crop happens after
    (un-sharding or per-shard slicing at the caller).
    """
    planes = []
    for ci in range(spec.ncomps):
        if spec.exact:
            plane = idct_islow.dequant_idct_islow_plane(coefs[ci], qtables[ci])
        else:
            plane = idct_ops.dequant_idct_float_plane(coefs[ci], qtables[ci])
        planes.append(_upsample_sharded(plane, spec, ci, SPACE_AXIS))
    if spec.ncomps == 1:
        y = planes[0]
        return jnp.broadcast_to(y[..., None], y.shape + (3,))
    return color_ops.ycbcr_to_rgb_exact(*planes)


def _local_seg_meta(seg_meta, local_batches: int):
    """seg_meta locates an image's (possibly short) LAST segment by its
    global batch index, so the decoder can suppress the meaningless error
    flags of its padded tail steps.  Each shard decodes only its local
    batches: remap to shard-local coordinates (-1 when the last segment
    lives on another shard, which never matches a segment)."""
    lb = seg_meta[0] - jax.lax.axis_index(DATA_AXIS) * local_batches
    in_shard = jnp.logical_and(lb >= 0, lb < local_batches)
    return seg_meta.at[0].set(jnp.where(in_shard, lb, -1))


def _space_slices(comps, space: int):
    """This device's MCU block-row slice of every (vb, hb, 8, 8) plane."""
    sidx = jax.lax.axis_index(SPACE_AXIS)
    out = []
    for c in comps:
        rows = c.shape[0] // space
        out.append(jax.lax.dynamic_slice_in_dim(c, sidx * rows, rows, axis=0))
    return tuple(out)


@functools.partial(jax.jit, static_argnums=(0, 1))
def decode_batch_sharded(
    spec: PipelineSpec,
    mesh: Mesh,
    coefs: Tuple[jax.Array, ...],
    qtables: Tuple[jax.Array, ...],
):
    """Decode (N, vb, hb, 8, 8) coefficient batches over the mesh.

    Returns (rgb, checksum): rgb is (N, Hpad, Wpad, 3) uint8 sharded
    (data, space) on its first two axes -- still MCU-padded; callers crop
    ``[..., :H, :W, :]``.  checksum is a replicated uint32 decode signature
    (psum over all shards).
    """
    coef_specs = tuple(P(DATA_AXIS, SPACE_AXIS) for _ in coefs)
    # Per-image quant tables (N, 1, 1, 8, 8) shard with the batch; shared
    # (8, 8) tables replicate.
    q_specs = tuple(
        P(DATA_AXIS) if q.ndim == 5 else P() for q in qtables
    )

    def step(coefs, qtables):
        rgb = _local_decode_rgb(spec, coefs, qtables)
        local_sum = jnp.sum(rgb.astype(jnp.uint32))
        checksum = jax.lax.psum(
            jax.lax.psum(local_sum, DATA_AXIS), SPACE_AXIS
        )
        return rgb, checksum

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(coef_specs, q_specs),
        out_specs=(P(DATA_AXIS, SPACE_AXIS), P()),
    )(coefs, qtables)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def decode_corpus_device_sharded(
    spec: PipelineSpec,
    mesh: Mesh,
    meta: Tuple,  # (b1, n_segments, mcus_per_segment, n_mcus, nhmb, nvmb,
    #               geom, frame_order, salvage)
    streams: jax.Array,      # (NI*B1, NW, 1024); NI % (data*space) == 0
    maps: Tuple[jax.Array, ...],   # (comp_map, dcslot, acslot), replicated
    local_seg_meta: jax.Array,     # (NI/(data*space), 3) shard-LOCAL last-
    #                                segment meta (identical on every shard:
    #                                bucket images share geometry)
    tables: Tuple[jax.Array, ...],  # (cbase, counts, symbols), leading NI
    qtables: Tuple[jax.Array, ...],  # per comp, leading NI axis
):
    """Distributed fully-on-device corpus decode (BASELINE config #4's
    full shape: corpus sharded across devices WITH device entropy).

    Images shard over the flattened (data, space) grid for the entropy
    stage -- restart segments of one image never cross devices, so the
    Huffman kernel runs collective-free.  Coefficients then all_gather
    over ``space``, and the pixel stage splits each image's
    MCU block rows over ``space`` while images stay sharded over
    ``data``.  With space=1 this degenerates to communication-free pure
    data parallelism.

    Returns (rgb, err): rgb (NI, Hpad, Wpad, 3) uint8 -- callers crop to
    (H, W); err (NI*B1*1024,) per-segment flags.
    """
    from jaxjpeg.ops import entropy_device

    (
        b1, n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom,
        frame_order, salvage,
    ) = meta
    space = mesh.shape[SPACE_AXIS]
    for hs, vs in geom:
        if (nvmb * vs) % space:
            raise ValueError(
                f"MCU rows ({nvmb}, x{vs} blocks) not divisible by the "
                f"space axis ({space}); use a smaller space axis"
            )

    def step(streams, maps, local_seg_meta, tables, qtables):
        comp_map, dcslot, acslot = maps
        cbase, counts, symbols = tables
        ni_loc = streams.shape[0] // b1  # images on this device
        imgmap = jnp.repeat(
            jnp.arange(ni_loc, dtype=jnp.int32), b1, total_repeat_length=ni_loc * b1
        )
        out, err = entropy_device.decode_segments_device_multi(
            streams, imgmap, comp_map, dcslot, acslot, local_seg_meta,
            cbase, counts, symbols,
        )
        if salvage:
            # Corrupt segments decode to zero coefficients; the damage
            # stays inside the restart boundary (on_error="zero").
            out = entropy_device.zero_flagged(out, err)
        # Every device in this data column collects the column's images
        # (space shards of the entropy work).
        outg = jax.lax.all_gather(out, SPACE_AXIS, axis=0, tiled=True)
        ni_col = ni_loc * space
        per_image = outg.reshape((ni_col, -1) + outg.shape[1:])
        comps = entropy_device.assemble_components(
            per_image, n_segments, mcus_per_segment, n_mcus, nhmb, nvmb,
            geom, frame_order,
        )
        sidx = jax.lax.axis_index(SPACE_AXIS)
        local = []
        for c in comps:
            rows = c.shape[1] // space
            local.append(
                jax.lax.dynamic_slice_in_dim(c, sidx * rows, rows, axis=1)
            )
        rgb = _local_decode_rgb(spec, tuple(local), qtables)
        return rgb, err

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P((DATA_AXIS, SPACE_AXIS)),
            P(),
            P(),
            P((DATA_AXIS, SPACE_AXIS)),
            P(DATA_AXIS),
        ),
        out_specs=(
            P(DATA_AXIS, SPACE_AXIS),
            P((DATA_AXIS, SPACE_AXIS)),
        ),
        check_vma=False,
    )(streams, maps, local_seg_meta, tables, qtables)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def decode_image_device_sharded_spec(
    spec: PipelineSpec,
    mesh: Mesh,
    assemble_args: Tuple,   # (n_segments, mcus_per_segment, n_mcus, nhmb,
    #                            nvmb, geom, frame_order)
    scan_cfg: Tuple,        # (sb, nw, spw, nws, t_last) -- SpecScanInput
    #                            statics
    windows: jax.Array,     # (BS, NWS, 1024) int32, replicated
    nbits: jax.Array,       # (1,) int32
    scan_maps: Tuple[jax.Array, ...],    # (dcslot_of_c, acslot_of_c)
    plan_tables: Tuple[jax.Array, ...],  # kernel_tables (seg_meta shard-safe)
    qtables: Tuple[jax.Array, ...],
):
    """DRI-less single-image distributed decode via the DEVICE index scan.

    The serial host scan never runs: every device executes the parallel
    index scan on the replicated window tensor, then
    gathers + decodes ONLY its own pseudo-segment shard; coefficient
    slabs all_gather exactly like the restart path, and the DC
    predictor bases are derived from the gathered coefficients (each
    device computes the identical exclusive cumsum -- no extra collective).
    Non-convergence surfaces as ``ok=False`` (replicated); the caller
    falls back to the host-scan path.

    Returns (rgb, err, ok): rgb (padH, padW, 3) sharded on rows over
    space; err (B2*1024,) segment flags; ok () bool.
    """
    from jaxjpeg.ops import entropy_device, specsync_device

    n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom, frame_order = (
        assemble_args
    )
    sb, nw, spw, nws, t_last = scan_cfg
    assert mcus_per_segment == 1
    data_size = mesh.shape[DATA_AXIS]
    space = mesh.shape[SPACE_AXIS]
    for hs, vs in geom:
        if (nvmb * vs) % space:
            raise ValueError(
                f"MCU rows ({nvmb}, x{vs} blocks) not divisible by the "
                f"space axis ({space}); use a smaller space axis"
            )
    per_batch = entropy_device.SEGMENTS_PER_BATCH
    b2 = -(-n_mcus // per_batch)
    b2 = -(-b2 // data_size) * data_size  # pad batches to the grid

    def step(windows, nbits, scan_maps, plan_tables, qtables):
        dcslot_c, acslot_c = scan_maps
        comp_map, dcslot, acslot, seg_meta, cbase, counts, symbols = (
            plan_tables
        )
        bitpos, ok, _stats = specsync_device.device_index_scan(
            windows, nbits, dcslot_c, acslot_c, cbase, counts, symbols,
            sb=sb, n_mcus=n_mcus,
        )
        seg_bits = jnp.diff(bitpos, append=nbits.astype(jnp.int32))
        ok = jnp.logical_and(ok, jnp.max(seg_bits) + 63 <= nw * 32)
        # This device's pseudo-segment shard: contiguous batches of 1024.
        bitpos = jnp.pad(bitpos, (0, b2 * per_batch - n_mcus))
        local_b = b2 // data_size
        loc = local_b * per_batch
        my = jax.lax.dynamic_slice_in_dim(
            bitpos, jax.lax.axis_index(DATA_AXIS) * loc, loc
        )
        streams = specsync_device.gather_entropy_streams(
            windows, my, nw=nw, spw=spw, nws=nws
        )
        seg_meta = _local_seg_meta(seg_meta, local_b)
        out, err = entropy_device.decode_segments_device(
            streams, comp_map, dcslot, acslot, seg_meta,
            cbase, counts, symbols,
        )
        out = jax.lax.all_gather(out, DATA_AXIS, axis=0, tiled=True)
        # err stays shard-local; the P(DATA_AXIS) out_spec concatenates
        # the shards back into the global flag vector.  DC bases come from
        # the gathered coefficients: the same exclusive cumsum on every
        # device, applied before assembly.
        dcb = specsync_device.dc_base_from_coefs(out, t_last)
        out = entropy_device.apply_dc_base(out, dcb, comp_map)
        comps = entropy_device.assemble_components(
            out, n_segments, 1, n_mcus, nhmb, nvmb, geom, frame_order,
        )
        rgb = _local_decode_rgb(spec, _space_slices(comps, space), qtables)
        return rgb, err, ok

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(SPACE_AXIS), P(DATA_AXIS), P()),
        check_vma=False,
    )(windows, nbits, scan_maps, plan_tables, qtables)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def decode_image_device_sharded(
    spec: PipelineSpec,
    mesh: Mesh,
    assemble_args: Tuple,   # (n_segments, mcus_per_segment, n_mcus, nhmb,
    #                            nvmb, geom, frame_order)
    streams: jax.Array,     # (B, NW, 1024) int32, B divisible by data axis
    plan_tables: Tuple[jax.Array, ...],  # DeviceScanPlan.kernel_tables
    qtables: Tuple[jax.Array, ...],
    dc_base=None,           # (B*1024, C) int32 for DRI-less pseudo
    #                         segments (build_plan_no_dri), else None
):
    """One image, fully on-device, distributed: restart-segment batches
    shard over the ``data`` axis (each device Huffman-decodes its share),
    coefficients are exchanged (all_gather), and the pixel
    pipeline splits MCU block rows over the ``space`` axis.  DRI-less
    streams work too: their index-scan DC bases shard with the streams
    and are applied per shard before the gather.

    This is the BASELINE.json config #5 shape: segments + block
    boundaries between devices. Returns (rgb, err): rgb (padH, padW, 3) sharded
    on rows over space; err (B*1024,) segment flags.
    """
    from jaxjpeg.ops import entropy_device

    n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom, frame_order = (
        assemble_args
    )
    space = mesh.shape[SPACE_AXIS]
    # Every component's block rows must split evenly over the space axis,
    # or the dynamic slices would silently drop bottom MCU rows and
    # misalign luma against chroma.
    for hs, vs in geom:
        if (nvmb * vs) % space:
            raise ValueError(
                f"MCU rows ({nvmb}, x{vs} blocks) not divisible by the "
                f"space axis ({space}); use a smaller space axis"
            )

    def step(streams, plan_tables, qtables, dc_base):
        comp_map, dcslot, acslot, seg_meta, cbase, counts, symbols = (
            plan_tables
        )
        seg_meta = _local_seg_meta(seg_meta, streams.shape[0])
        out, err = entropy_device.decode_segments_device(
            streams, comp_map, dcslot, acslot, seg_meta,
            cbase, counts, symbols,
        )
        if dc_base is not None:
            out = entropy_device.apply_dc_base(out, dc_base, comp_map)
        # Exchange coefficient slabs across the data axis.
        out = jax.lax.all_gather(out, DATA_AXIS, axis=0, tiled=True)
        err = jax.lax.all_gather(err, DATA_AXIS, axis=0, tiled=True)
        comps = entropy_device.assemble_components(
            out, n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom,
            frame_order,
        )
        rgb = _local_decode_rgb(spec, _space_slices(comps, space), qtables)
        return rgb, err

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS), P(), P(),
            P() if dc_base is None else P(DATA_AXIS),
        ),
        out_specs=(P(SPACE_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )(streams, plan_tables, qtables, dc_base)
