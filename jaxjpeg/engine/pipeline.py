"""The jitted device pipeline: coefficient tensors -> pixels, one XLA program.

Replaces the reference's three GL passes + FBO plumbing (jpeg_gpu.c:759-1119)
with a single jitted function per (geometry, stage): dequant -> IDCT ->
block-to-plane -> chroma upsample -> color convert, all fused by XLA with no
host round-trip.  Geometry is static (JPEG dims vary -> one compile per
geometry bucket, cached by jit on the hashable PipelineSpec).

Every op accepts leading batch dimensions, so batched decode of
same-geometry images is the same program with ``coefs`` shaped
``(N, vb, hb, 8, 8)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from jaxjpeg.engine.stages import OutputStage
from jaxjpeg.info import JpegHeader
from jaxjpeg.ops import color as color_ops
from jaxjpeg.ops import idct as idct_ops
from jaxjpeg.ops import idct_islow


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static decode geometry (hashable -> one XLA program per spec)."""

    width: int
    height: int
    comp_sizes: Tuple[Tuple[int, int], ...]  # per comp (width, height) in samples
    comp_decs: Tuple[Tuple[int, int], ...]   # per comp (xdec, ydec)
    comp_samps: Optional[Tuple[Tuple[int, int], ...]] = None  # (hsamp, vsamp)
    exact: bool = True                        # islow+int color vs float fast path
    upsample: str = "nearest"                 # "nearest" (reference semantics,
    #   do_fancy_upsampling=FALSE) or "fancy" (libjpeg default, bit-exact
    #   vs libjpeg-turbo RGB for every supported subsampling)

    @classmethod
    def from_header(
        cls,
        header: JpegHeader,
        exact: bool = True,
        upsample: str = "nearest",
    ) -> "PipelineSpec":
        return cls(
            width=header.width,
            height=header.height,
            comp_sizes=tuple((c.width, c.height) for c in header.components),
            comp_decs=tuple((c.xdec, c.ydec) for c in header.components),
            comp_samps=tuple((c.hsamp, c.vsamp) for c in header.components),
            exact=exact,
            upsample=upsample,
        )

    @property
    def ncomps(self) -> int:
        return len(self.comp_sizes)


def _sample_planes(spec: PipelineSpec, coefs, qtables):
    """Per-component full (MCU-aligned) sample planes, uint8."""
    planes = []
    for ci in range(spec.ncomps):
        # Both paths emit the raster plane directly: the blocks->plane u8
        # transpose dominated the pipeline when done as a post-pass.
        if spec.exact:
            planes.append(
                idct_islow.dequant_idct_islow_plane(coefs[ci], qtables[ci])
            )
        else:
            planes.append(
                idct_ops.dequant_idct_float_plane(coefs[ci], qtables[ci])
            )
    return planes


@functools.partial(jax.jit, static_argnums=0)
def decode_yuv(spec: PipelineSpec, coefs, qtables):
    """YUV stage: per-component sample planes cropped to true comp dims."""
    planes = _sample_planes(spec, coefs, qtables)
    return tuple(
        p[..., : spec.comp_sizes[ci][1], : spec.comp_sizes[ci][0]]
        for ci, p in enumerate(planes)
    )


@functools.partial(jax.jit, static_argnums=0)
def decode_rgb(spec: PipelineSpec, coefs, qtables):
    """RGB stage: full decode to (..., H, W, 3) uint8.

    Grayscale replicates Y into all three channels (cf. grey.fs display).
    """
    planes = _sample_planes(spec, coefs, qtables)
    h, w = spec.height, spec.width
    if spec.ncomps == 1:
        y = planes[0][..., :h, :w]
        return jnp.broadcast_to(y[..., None], y.shape + (3,))
    up = []
    for ci, p in enumerate(planes):
        xdec, ydec = spec.comp_decs[ci]
        if spec.upsample == "fancy":
            # Padded-plane filters with the true edge clamped in place:
            # everything stays MCU-aligned.
            cw, ch = spec.comp_sizes[ci]
            p = color_ops.upsample_fancy_padded(p, xdec, ydec, cw, ch)
        else:
            p = color_ops.upsample_nearest(p, xdec, ydec)
        up.append(p[..., :h, :w])
    y, cb, cr = up
    if spec.exact:
        return color_ops.ycbcr_to_rgb_exact(y, cb, cr)
    return color_ops.ycbcr_to_rgb_float(y, cb, cr)


@functools.partial(jax.jit, static_argnums=0)
def decode_dct(spec: PipelineSpec, coefs, qtables):
    """DCT stage: dequantized coefficients, int32 (cf. the dct upload mode)."""
    return tuple(
        coefs[ci].astype(jnp.int32) * qtables[ci].astype(jnp.int32)
        for ci in range(spec.ncomps)
    )


def run(
    spec: PipelineSpec,
    stage: OutputStage,
    coefs: Sequence[jax.Array],
    qtables: Sequence[jax.Array],
):
    """Dispatch one decode through the device pipeline at the given cut."""
    coefs = tuple(coefs)
    qtables = tuple(qtables)
    if stage == OutputStage.QUANT:
        return coefs
    if stage == OutputStage.DCT:
        return decode_dct(spec, coefs, qtables)
    if stage == OutputStage.YUV:
        return decode_yuv(spec, coefs, qtables)
    if stage == OutputStage.RGB:
        return decode_rgb(spec, coefs, qtables)
    raise ValueError(f"stage {stage} not handled by the coefficient pipeline")
