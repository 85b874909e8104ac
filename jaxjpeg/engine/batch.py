"""Batched throughput decode: many JPEGs -> one device program per bucket.

The throughput mode of BASELINE.json (config #4: an image corpus sharded
across chips).  Images are entropy-decoded on the host (native C++,
restart-parallel), grouped into *geometry buckets* -- same dimensions and
sampling structure compile to the same XLA program (SURVEY.md section 7,
hard part 4: bucket to bound recompiles) -- and each bucket decodes as one
batched device call, optionally shard_map'd over a (data, space) mesh.

Quantization tables may differ per image inside a bucket: they travel as a
batched (N, 1, 1, 8, 8) tensor and broadcast into the dequant multiply.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from jaxjpeg.engine.pipeline import PipelineSpec, decode_rgb
from jaxjpeg.host.parser import ParsedJpeg, parse
from jaxjpeg.utils.logging import get_logger

log = get_logger("engine")


def _bucket_key(spec: PipelineSpec) -> Tuple:
    # comp_samps matters too: equal sizes/decimations can still have
    # different sampling factors (e.g. 4:4:4 vs all-2x2 factors) and
    # therefore different MCU-aligned block grids.
    return (
        spec.width,
        spec.height,
        spec.comp_sizes,
        spec.comp_decs,
        spec.comp_samps,
    )


@dataclasses.dataclass
class _Bucket:
    spec: PipelineSpec
    indices: List[int]
    coefs: List[List[np.ndarray]]
    qtables: List[List[np.ndarray]]


def _entropy_decode(parsed: ParsedJpeg):
    from jaxjpeg.host import entropy, entropy_native

    if entropy_native.available():
        return entropy_native.decode_scan(parsed)
    return entropy.decode_scan(parsed)


def decode_batch(
    datas: Sequence[bytes],
    exact: bool = True,
    mesh=None,
    upsample: str = "nearest",
    entropy: str = "host",
) -> List[np.ndarray]:
    """Decode a corpus of JPEGs to RGB, batching same-geometry images.

    With ``mesh`` (a (data, space) jax Mesh, parallel/mesh.py), each
    bucket's batch is shard_map'd across the mesh; otherwise it runs as a
    single-device batched call.  ``entropy="device"`` runs the Huffman
    decode on the accelerator too (decode_batch_device; single-device).
    Returns RGB arrays in input order.
    """
    if entropy == "device":
        return decode_batch_device(
            datas, exact=exact, upsample=upsample, mesh=mesh
        )
    buckets: Dict[Tuple, _Bucket] = {}
    for i, data in enumerate(datas):
        parsed = parse(data)
        spec = PipelineSpec.from_header(parsed.header, exact=exact, upsample=upsample)
        result = _entropy_decode(parsed)
        hdr = parsed.header
        qts = [
            hdr.quant_for(c).values.astype(np.int32) for c in hdr.components
        ]
        b = buckets.setdefault(
            _bucket_key(spec), _Bucket(spec=spec, indices=[], coefs=[], qtables=[])
        )
        b.indices.append(i)
        b.coefs.append(result.coefs)
        b.qtables.append(qts)

    out: List[Optional[np.ndarray]] = [None] * len(datas)
    for bucket in buckets.values():
        rgb = _decode_bucket(bucket, mesh)
        for j, i in enumerate(bucket.indices):
            out[i] = rgb[j]
    return out  # type: ignore[return-value]


def _decode_bucket(bucket: _Bucket, mesh) -> np.ndarray:
    spec = bucket.spec
    n = len(bucket.indices)
    ncomps = spec.ncomps
    coefs = tuple(
        jnp.asarray(np.stack([c[ci] for c in bucket.coefs]))
        for ci in range(ncomps)
    )
    # (N, 1, 1, 8, 8): broadcasts against (N, vb, hb, 8, 8) in the dequant.
    qtables = tuple(
        jnp.asarray(
            np.stack([q[ci] for q in bucket.qtables])[:, None, None, :, :]
        )
        for ci in range(ncomps)
    )
    if mesh is None:
        rgb = decode_rgb(spec, coefs, qtables)
        return np.asarray(rgb)

    from jaxjpeg.parallel.mesh import DATA_AXIS, SPACE_AXIS
    from jaxjpeg.parallel.shard import decode_batch_sharded

    data_size = mesh.shape[DATA_AXIS]
    space = mesh.shape[SPACE_AXIS]
    for ci in range(ncomps):
        vb = coefs[ci].shape[1]
        if vb % space:
            raise ValueError(
                f"component {ci} block rows ({vb}) not divisible by the "
                f"space axis ({space}); use a smaller space axis"
            )
    pad = (-n) % data_size
    if pad:
        coefs = tuple(
            jnp.concatenate([c, jnp.repeat(c[-1:], pad, axis=0)]) for c in coefs
        )
        qtables = tuple(
            jnp.concatenate([q, jnp.repeat(q[-1:], pad, axis=0)]) for q in qtables
        )
    rgb, _ = decode_batch_sharded(spec, mesh, coefs, qtables)
    rgb = np.asarray(rgb)[:n, : spec.height, : spec.width]
    return rgb


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _decode_bucket_device(spec, meta, interpret, salvage, streams, tables, qtables):
    """One device program per bucket: entropy decode -> assembly -> pixel
    pipeline, with no host round-trips between stages.

    ``streams`` may arrive TRIMMED to the segments in use (see
    _trim_streams); the program pads them back to full batches.  Returns
    per-IMAGE error flags (max over the image's real segments), reduced on
    device so the host fetches NI ints instead of NI*1024 segment flags.
    """
    from jaxjpeg.ops import entropy_device

    ni, b1, n_segments, mps, n_mcus, nhmb, nvmb, geom, frame_order = meta
    pad = entropy_device.SEGMENTS_PER_BATCH - streams.shape[2]
    if pad:
        streams = jnp.pad(
            streams, ((0, 0), (0, 0), (0, pad)), constant_values=-1
        )
    out, err = entropy_device.decode_segments_device_multi(
        streams, *tables, interpret=interpret
    )
    if salvage:
        out = entropy_device.zero_flagged(out, err)
    per_image = out.reshape((ni, -1) + out.shape[1:])
    comps = entropy_device.assemble_components(
        per_image, n_segments, mps, n_mcus, nhmb, nvmb, geom, frame_order
    )
    rgb = decode_rgb.__wrapped__(spec, comps, qtables)
    err_img = err.reshape(ni, -1)[:, :n_segments].max(axis=1)
    return rgb, err_img


def decode_batch_device(
    datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    interpret: Optional[bool] = None,
    check_errors: bool = True,
    on_error: str = "raise",
    mesh=None,
) -> List[np.ndarray]:
    """Fully on-device corpus decode: per-image entropy bits -> RGB.

    Images bucket by (geometry, restart structure); each bucket runs ONE
    program: the multi-table entropy kernel over every image's stacked
    segment batches (per-image Huffman tables routed by segment batch),
    vmapped assembly, then the batched pixel pipeline.  The host only
    parses markers and packs destuffed words -- this is the serving path
    for corpora, with the per-image work the reference's CPU re-did every
    frame (xjpeg_decode_scan) all on the accelerator.

    With ``mesh`` (a (data, space) Mesh) each bucket distributes: images
    shard over the flattened device grid for the entropy stage,
    coefficient slabs are all_gathered, and the pixel stage splits MCU
    block rows over
    ``space`` (parallel/shard.py:decode_corpus_device_sharded) -- the
    full BASELINE config #4 shape.

    Falls back to the host-entropy ``decode_batch`` for images the device
    planner rejects (e.g. a no-restart stream too large per segment);
    each such image counts in ``device_entropy.FALLBACKS``.
    """
    from jaxjpeg.engine.device_entropy import note_fallback
    from jaxjpeg.errors import JpegFormatError, JpegUnsupportedError
    from jaxjpeg.host.segments import (
        build_corpus_plan,
        build_plan,
        plan_bucket_key,
    )

    out: List[Optional[np.ndarray]] = [None] * len(datas)
    buckets: Dict[Tuple, List[Tuple[int, object, object]]] = defaultdict(list)
    fallback: List[int] = []
    for i, data in enumerate(datas):
        parsed = parse(data)
        try:
            plan = build_plan(parsed)
        except JpegUnsupportedError as e:
            note_fallback("plan_rejected", e)
            fallback.append(i)
            continue
        spec = PipelineSpec.from_header(
            parsed.header, exact=exact, upsample=upsample
        )
        key = (_bucket_key(spec), spec.exact, spec.upsample, plan_bucket_key(plan))
        buckets[key].append((i, parsed, plan))

    for items in buckets.values():
        indices = [i for i, _, _ in items]
        if mesh is not None:
            # Image count must tile the chip grid: replicate the last
            # image's plan (its outputs are dropped below).  The padding
            # is WASTED entropy-stage work -- up to (n_chips-1)/n_chips
            # of the stage for a 1-image remainder bucket -- so callers
            # serving wide meshes should size buckets to multiples of
            # the grid; warn when a bucket wastes more than half.
            n_chips = int(np.prod(list(mesh.shape.values())))
            pad = (-len(items)) % n_chips
            if pad:
                (log.warning if pad > len(items) else log.debug)(
                    "mesh bucket pads %d image(s) to %d chips (%.0f%% of "
                    "the entropy stage is padding)",
                    len(items), n_chips * ((len(items) + pad) // n_chips),
                    100.0 * pad / (len(items) + pad),
                )
            items = list(items) + [items[-1]] * pad
        parsed0 = items[0][1]
        hdr = parsed0.header
        spec = PipelineSpec.from_header(hdr, exact=exact, upsample=upsample)
        corpus_plan = build_corpus_plan([p for _, _, p in items])
        geom = tuple(
            (hdr.components[ci].hsamp, hdr.components[ci].vsamp)
            for ci in hdr.scan.comp_idx
        )
        qtables = jnp.asarray(
            np.stack(
                [
                    np.stack(
                        [
                            p.header.quant_for(c).values.astype(np.int32)
                            for c in p.header.components
                        ]
                    )
                    for _, p, _ in items
                ]
            )
        )  # (NI, ncomps, 8, 8)
        ni = corpus_plan.n_images
        b1 = corpus_plan.batches_per_image
        meta = (
            ni, b1, corpus_plan.n_segments, corpus_plan.mcus_per_segment,
            corpus_plan.n_mcus, hdr.nhmb, hdr.nvmb, geom,
            hdr.scan.comp_idx,
        )
        qts = tuple(
            qtables[:, ci, None, None, :, :] for ci in range(spec.ncomps)
        )
        if mesh is not None:
            from jaxjpeg.parallel.shard import (
                decode_corpus_device_sharded,
            )

            n_chips = int(np.prod(list(mesh.shape.values())))
            ni_loc = ni // n_chips
            # Shard-local last-segment meta: every bucket image shares
            # (local batch, lane, steps); rebuild rows with LOCAL batch
            # indices (global indices are meaningless inside a shard).
            p0 = items[0][2]
            lb0, lane0, steps0 = (int(x) for x in p0.seg_meta)
            local_seg_meta = np.stack(
                [
                    np.array(
                        [j * b1 + lb0, lane0, steps0], dtype=np.int32
                    )
                    for j in range(ni_loc)
                ]
            )
            smeta = (
                b1, corpus_plan.n_segments, corpus_plan.mcus_per_segment,
                corpus_plan.n_mcus, hdr.nhmb, hdr.nvmb, geom,
                hdr.scan.comp_idx, on_error == "zero",
            )
            rgb, err = decode_corpus_device_sharded(
                spec, mesh, smeta,
                jnp.asarray(corpus_plan.streams),
                (
                    jnp.asarray(corpus_plan.comp_of_step),
                    jnp.asarray(corpus_plan.dc_slot_of_step),
                    jnp.asarray(corpus_plan.ac_slot_of_step),
                ),
                jnp.asarray(local_seg_meta),
                (
                    jnp.asarray(corpus_plan.cbase),
                    jnp.asarray(corpus_plan.counts),
                    jnp.asarray(corpus_plan.symbols),
                ),
                qts,
            )
            rgb = np.asarray(rgb)[:, : spec.height, : spec.width]
            if check_errors and on_error == "raise":
                flags = np.asarray(err).reshape(ni, -1)[
                    :, : corpus_plan.n_segments
                ]
                if flags.any():
                    bad_img, bad_seg = map(int, np.argwhere(flags)[0])
                    raise JpegFormatError(
                        f"device entropy decode failed: image "
                        f"{indices[bad_img]} restart segment {bad_seg}"
                    )
        else:
            rgb, err_img = _decode_bucket_device(
                spec, meta, interpret, on_error == "zero",
                jnp.asarray(_trim_streams(corpus_plan)),
                tuple(jnp.asarray(x) for x in corpus_plan.kernel_tables),
                qts,
            )
            rgb = np.asarray(rgb)
            if check_errors and on_error == "raise":
                flags = np.asarray(err_img)
                if flags.any():
                    bad_img = int(np.flatnonzero(flags)[0])
                    raise JpegFormatError(
                        f"device entropy decode failed: image "
                        f"{indices[bad_img]} (flags={int(flags[bad_img])})"
                    )
        for j, i in enumerate(indices):
            out[i] = rgb[j]

    if fallback:
        host = decode_batch(
            [datas[i] for i in fallback], exact=exact, upsample=upsample
        )
        for j, i in enumerate(fallback):
            out[i] = host[j]
    return out  # type: ignore[return-value]


def _trim_streams(corpus_plan) -> np.ndarray:
    """Trimmed upload view of a corpus plan's streams.

    With one segment batch per image, only the first n_segments of each
    1024-segment batch carry data (rounded up to 128); the rest are 0xFF
    padding the device program re-pads itself (_decode_bucket_device), so
    a 256-segment bucket uploads 4x fewer bytes.
    """
    if corpus_plan.batches_per_image != 1:
        return corpus_plan.streams  # partial fill only in the last batch
    used = -(-corpus_plan.n_segments // 128) * 128
    if used >= corpus_plan.streams.shape[2]:
        return corpus_plan.streams
    return np.ascontiguousarray(corpus_plan.streams[:, :, :used])


def decode_batch_device_resident(
    datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    check_errors: bool = True,
    on_error: str = "raise",
):
    """Fully on-device corpus decode with DEVICE-RESIDENT output.

    The serving surface for downstream consumers on the device (vision
    models, on-device preprocessing): pixels never cross the host link,
    exactly as the reference's render loop keeps frames on the GPU from
    decode to display (jpeg_gpu.c:1228-1461 never reads pixels back).

    All images must share one geometry/table bucket (the realistic
    serving-bucket shape; decode_batch_device handles mixed corpora).
    Returns (rgb, err_img): rgb (N, H, W, 3) uint8 ON DEVICE (cropped),
    err_img (N,) int32 per-image flags ON DEVICE (0 = clean).
    """
    from jaxjpeg.errors import JpegFormatError

    fn, args = bucket_program(datas, exact, upsample, on_error == "zero")
    spec = args[0]
    rgb, err_img = fn(*args)
    rgb = _crop_device(rgb, spec.height, spec.width)
    if check_errors and on_error == "raise":
        flags = np.asarray(err_img)
        if flags.any():
            bad = int(np.flatnonzero(flags)[0])
            raise JpegFormatError(
                f"device entropy decode failed: image {bad} "
                f"(flags={int(flags[bad])})"
            )
    return rgb, err_img


def bucket_program(
    datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    salvage: bool = False,
):
    """(fn, args) of the one device program that decodes a single-bucket
    corpus: ``fn(*args)`` returns (rgb (N, Hpad, Wpad, 3), err_img (N,))."""
    from jaxjpeg.host.segments import (
        build_corpus_plan,
        build_plan,
        plan_bucket_key,
    )

    parsed = [parse(d) for d in datas]
    plans = [build_plan(p) for p in parsed]
    key0 = plan_bucket_key(plans[0])
    if any(plan_bucket_key(p) != key0 for p in plans[1:]):
        raise ValueError(
            "decode_batch_device_resident needs one geometry bucket; "
            "use decode_batch_device for mixed corpora"
        )
    hdr = parsed[0].header
    spec = PipelineSpec.from_header(hdr, exact=exact, upsample=upsample)
    corpus_plan = build_corpus_plan(plans)
    geom = tuple(
        (hdr.components[ci].hsamp, hdr.components[ci].vsamp)
        for ci in hdr.scan.comp_idx
    )
    qtables = np.stack(
        [
            np.stack(
                [
                    p.header.quant_for(c).values.astype(np.int32)
                    for c in p.header.components
                ]
            )
            for p in parsed
        ]
    )
    qts = tuple(
        jnp.asarray(qtables[:, ci, None, None, :, :])
        for ci in range(spec.ncomps)
    )
    meta = (
        corpus_plan.n_images, corpus_plan.batches_per_image,
        corpus_plan.n_segments, corpus_plan.mcus_per_segment,
        corpus_plan.n_mcus, hdr.nhmb, hdr.nvmb, geom, hdr.scan.comp_idx,
    )
    args = (
        spec, meta, None, salvage,
        jnp.asarray(_trim_streams(corpus_plan)),
        tuple(jnp.asarray(x) for x in corpus_plan.kernel_tables),
        qts,
    )
    return _decode_bucket_device, args


@functools.partial(jax.jit, static_argnums=(1, 2))
def _crop_device(rgb, h, w):
    return rgb[:, :h, :w]
