"""Decoder backends behind one interface.

Analogue of the reference's vtbl abstraction
(jpeg_decode_ctx_vtbl, jpeg_wrap.h:35-51): the same decode surface --
``decode_header`` / ``decode(out=stage)`` / ``reset`` -- over multiple
interchangeable backends for differential testing:

* :class:`PilDecoder`   -- libjpeg-turbo via Pillow: the always-available
  pixel oracle (the LIBJPEG vtbl role, jpeg_wrap.c:246-252).
* :class:`HostDecoder`  -- our own full CPU path (the XJPEG role,
  jpeg_wrap.c:352-358): host entropy decode + numpy islow IDCT + exact
  integer color.  Every stage cut available.
* :class:`DeviceDecoder` -- host entropy decode + the jitted device pipeline
  (engine/pipeline.py).  Every stage cut available; pixel stages run on
  the accelerator.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from jaxjpeg.engine.stages import OutputStage
from jaxjpeg.errors import JpegError, JpegUnsupportedError
from jaxjpeg.host import entropy as host_entropy
from jaxjpeg.host.parser import ParsedJpeg, parse
from jaxjpeg.info import JpegHeader
from jaxjpeg.ops import color as color_ops
from jaxjpeg.ops import idct_islow
from jaxjpeg.utils.logging import get_logger

log = get_logger("engine")

StageArg = Union[OutputStage, str]


def _stage(out: StageArg) -> OutputStage:
    return out if isinstance(out, OutputStage) else OutputStage.from_name(out)


@dataclasses.dataclass
class YuvOutput:
    """YUV-stage result: per-component sample planes (true comp dims)."""

    planes: List[np.ndarray]


@dataclasses.dataclass
class CoefOutput:
    """QUANT/DCT-stage result: per-component (vb, hb, 8, 8) coefficients."""

    coefs: List[np.ndarray]


@dataclasses.dataclass
class PackOutput:
    """PACK-stage result: the reference's packed stream + per-block index."""

    pack: np.ndarray
    index: List[np.ndarray]


class Decoder:
    """Base decoder: owns the bitstream, parses lazily, decodes per stage.

    ``entropy`` selects the scan decoder: "native" (C++ restart-parallel,
    host/native/), "python" (reference implementation), or "auto" (native
    when the shared object is available).
    """

    name = "base"

    def __init__(self, data: bytes, validate: bool = True, entropy: str = "auto"):
        self.data = data
        self.validate = validate
        self.entropy = entropy
        self._parsed: Optional[ParsedJpeg] = None
        self._scan: Optional[host_entropy.ScanResult] = None
        self._scan_packed = False

    # -- header ------------------------------------------------------------
    def decode_header(self) -> JpegHeader:
        return self._parse().header

    def _parse(self) -> ParsedJpeg:
        if self._parsed is None:
            self._parsed = parse(self.data, validate=self.validate)
        return self._parsed

    # -- image -------------------------------------------------------------
    def decode(self, out: StageArg = OutputStage.RGB):
        raise NotImplementedError

    def reset(self) -> None:
        """Drop decoded state, keep the bitstream (cf. decode_reset)."""
        self._parsed = None
        self._scan = None

    # -- shared host entropy stage ------------------------------------------
    def _entropy(self, want_pack: bool = False) -> host_entropy.ScanResult:
        if self._scan is None or (want_pack and not self._scan_packed):
            use_native = False
            if self.entropy == "native":
                use_native = True
            elif self.entropy == "auto":
                from jaxjpeg.host import entropy_native

                use_native = entropy_native.available()
            if use_native:
                from jaxjpeg.host import entropy_native

                self._scan = entropy_native.decode_scan(
                    self._parse(), want_pack=want_pack,
                    validate=self.validate,
                )
            else:
                self._scan = host_entropy.decode_scan(
                    self._parse(), want_pack=want_pack, validate=self.validate
                )
            self._scan_packed = want_pack
        return self._scan

    def io_bytes(self, out: StageArg = OutputStage.RGB) -> dict:
        """Host<->device payload bytes for decode(out) in the current mode.

        The reference's central experiment variable: bytes shipped to the
        accelerator per stage cut (img.packed, jpeg_gpu.c:803,1287) --
        the pack upload mode exists to shrink exactly this number.
        ``upload`` covers the per-frame payload (coefficients, packed
        stream, or destuffed entropy words); ``download`` the stage's
        output.  Huffman/quant table tensors are one-time per stream and
        reported separately as ``tables``.
        """
        stage = _stage(out)
        hdr = self._parse().header
        coef_b = sum(c.vblocks * c.hblocks * 64 * 2 for c in hdr.components)
        down = {
            OutputStage.RGB: hdr.height * hdr.width * 3,
            OutputStage.YUV: sum(c.height * c.width for c in hdr.components),
            OutputStage.QUANT: coef_b,
            OutputStage.DCT: coef_b * 2,  # int32
            OutputStage.PACK: 0,          # host-only stage
        }[stage]
        tables = 64 * 4 * hdr.ncomps  # dequant tables
        mode = "host"
        if stage == OutputStage.PACK:
            upload = 0
            tables = 0
        elif getattr(self, "entropy", None) == "device":
            # Size the plan decode() actually ships: build_plan_auto routes
            # DRI-less streams through the index-scan pseudo-segment
            # builder (build_plan_no_dri), whose payload includes the
            # per-pseudo-segment DC predictor bases.
            from jaxjpeg.host.segments import build_plan_auto

            try:
                plan = build_plan_auto(self._parse())
            except Exception:
                upload = coef_b  # planner rejected: host-entropy fallback
            else:
                mode = "bits"
                upload = plan.streams.nbytes
                if plan.dc_base is not None:
                    upload += plan.dc_base.nbytes
                tables = (
                    sum(t.nbytes for t in plan.kernel_tables)
                    + 64 * 4 * hdr.ncomps
                )
        elif getattr(self, "upload", "coefs") == "pack":
            mode = "pack"
            scan = self._entropy(want_pack=True)
            idx_b = sum(i.nbytes for i in (scan.pack_index or []))
            upload = (len(scan.pack) * 2 if scan.pack is not None else 0) + idx_b
        else:
            upload = coef_b
        return {
            "upload": int(upload),
            "download": int(down),
            "tables": int(tables),
            "payload": mode,
        }

    def host_entropy(self, out: StageArg = "rgb"):
        """Run (and cache) the host entropy work that decode(out) will
        consume -- for benchmarking the host/device time split without
        duplicating the decode.  Returns None when decode(out) does its
        entropy on device or in an external library."""
        stage = _stage(out)
        return self._entropy(want_pack=(stage == OutputStage.PACK))

    def _coef_stage(self, stage: OutputStage):
        parsed = self._parse()
        result = self._entropy(want_pack=(stage == OutputStage.PACK))
        if stage == OutputStage.PACK:
            return PackOutput(pack=result.pack, index=result.pack_index)
        if stage == OutputStage.QUANT:
            return CoefOutput(coefs=[np.asarray(c) for c in result.coefs])
        if stage == OutputStage.DCT:
            hdr = parsed.header
            out = []
            for ci, comp in enumerate(hdr.components):
                q = hdr.quant_for(comp).values.astype(np.int32)
                out.append(result.coefs[ci].astype(np.int32) * q)
            return CoefOutput(coefs=out)
        raise ValueError(stage)


class HostDecoder(Decoder):
    """Full CPU decode path (our from-scratch 'xjpeg' equivalent)."""

    name = "host"

    def __init__(
        self,
        data: bytes,
        validate: bool = True,
        entropy: str = "auto",
        upsample: str = "nearest",
    ):
        super().__init__(data, validate=validate, entropy=entropy)
        self.upsample = upsample

    def io_bytes(self, out: StageArg = OutputStage.RGB) -> dict:
        return {"upload": 0, "download": 0, "tables": 0, "payload": "none"}

    def decode(self, out: StageArg = OutputStage.RGB):
        stage = _stage(out)
        if stage in (OutputStage.PACK, OutputStage.QUANT, OutputStage.DCT):
            return self._coef_stage(stage)
        hdr = self._parse().header
        result = self._entropy()
        full_planes = []
        for ci, comp in enumerate(hdr.components):
            q = hdr.quant_for(comp).values
            pix = idct_islow.dequant_idct_islow_pixels(result.coefs[ci], q, xp=np)
            full_planes.append(_np_blocks_to_plane(pix))
        if stage == OutputStage.YUV:
            return YuvOutput(
                planes=[
                    p[: c.height, : c.width]
                    for p, c in zip(full_planes, hdr.components)
                ]
            )
        assert stage == OutputStage.RGB
        h, w = hdr.height, hdr.width
        if hdr.ncomps == 1:
            y = full_planes[0][:h, :w]
            return np.repeat(y[..., None], 3, axis=-1)
        if self.upsample == "fancy":
            up = [
                color_ops.upsample_fancy(
                    p[: c.height, : c.width], c.xdec, c.ydec, xp=np
                )[:h, :w]
                for p, c in zip(full_planes, hdr.components)
            ]
        else:
            up = [
                color_ops.upsample_nearest(p, c.xdec, c.ydec, xp=np)[:h, :w]
                for p, c in zip(full_planes, hdr.components)
            ]
        return color_ops.ycbcr_to_rgb_exact(up[0], up[1], up[2], xp=np)


def _np_blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    vb, hb = blocks.shape[-4], blocks.shape[-3]
    x = np.swapaxes(blocks, -3, -2)
    return x.reshape(blocks.shape[:-4] + (vb * 8, hb * 8))


class DeviceDecoder(Decoder):
    """Device pipeline decoder.

    ``entropy="device"`` runs the Huffman decode itself on the device
    (restart-parallel decoder, engine/device_entropy.py) -- the host
    only parses markers and packs segment words.  Other entropy modes
    decode on the host (native C++ or Python) and upload coefficients.
    """

    name = "device"

    def __init__(
        self,
        data: bytes,
        validate: bool = True,
        entropy: str = "auto",
        exact: bool = True,
        upload: str = "coefs",
        upsample: str = "nearest",
        on_error: str = "raise",
    ):
        super().__init__(data, validate=validate, entropy=entropy)
        self.exact = exact
        self.upsample = upsample
        if upload not in ("coefs", "pack"):
            raise ValueError(f"upload must be 'coefs' or 'pack', got {upload!r}")
        self.upload = upload
        # "zero": salvage device-entropy decodes -- corrupt restart
        # segments become flat gray blocks instead of failing the image.
        self.on_error = on_error

    def host_entropy(self, out: StageArg = OutputStage.RGB):
        stage = _stage(out)
        if self.entropy == "device" and stage != OutputStage.PACK:
            return None  # Huffman runs on the device
        if stage == OutputStage.PACK or self.upload == "pack":
            return self._entropy(want_pack=True)
        return self._entropy()

    def decode(self, out: StageArg = OutputStage.RGB):
        from jaxjpeg.engine import pipeline

        stage = _stage(out)
        if self.entropy == "device" and stage != OutputStage.PACK:
            from jaxjpeg.engine.device_entropy import decode_image_device

            try:
                dev = decode_image_device(
                    self._parse(), stage=stage, exact=self.exact,
                    upsample=self.upsample, on_error=self.on_error,
                )
            except JpegUnsupportedError as e:
                # Same fallback contract as decode_batch_device: inputs the
                # device planner rejects (e.g. a no-restart stream whose one
                # segment exceeds the word budget) decode via host entropy
                # with identical output.
                from jaxjpeg.engine.device_entropy import note_fallback

                note_fallback("plan_rejected", e)
                dev = None
            if dev is not None:
                if stage in (OutputStage.QUANT, OutputStage.DCT):
                    return CoefOutput(coefs=[np.asarray(c) for c in dev])
                if stage == OutputStage.YUV:
                    return YuvOutput(planes=[np.asarray(p) for p in dev])
                return np.asarray(dev)
        if stage == OutputStage.PACK:
            return self._coef_stage(stage)
        hdr = self._parse().header
        spec = pipeline.PipelineSpec.from_header(
            hdr, exact=self.exact, upsample=self.upsample
        )
        qtables = tuple(
            hdr.quant_for(c).values.astype(np.int32) for c in hdr.components
        )
        if self.upload == "pack":
            # Minimal-upload path: ship the packed (run,value) stream and
            # expand it to dense coefficients on device (pack_device.py).
            from jaxjpeg.engine.device_entropy import expand_pack_device

            scan = self._entropy(want_pack=True)
            coefs = expand_pack_device(self._parse(), scan)
            if stage == OutputStage.QUANT:
                return CoefOutput(coefs=[np.asarray(c) for c in coefs])
            dev = pipeline.run(spec, stage, coefs, qtables)
            if stage == OutputStage.DCT:
                return CoefOutput(coefs=[np.asarray(c) for c in dev])
            if stage == OutputStage.YUV:
                return YuvOutput(planes=[np.asarray(p) for p in dev])
            return np.asarray(dev)
        result = self._entropy()
        coefs = tuple(np.ascontiguousarray(c) for c in result.coefs)
        dev = pipeline.run(spec, stage, coefs, qtables)
        if stage in (OutputStage.QUANT, OutputStage.DCT):
            return CoefOutput(coefs=[np.asarray(c) for c in dev])
        if stage == OutputStage.YUV:
            return YuvOutput(planes=[np.asarray(p) for p in dev])
        return np.asarray(dev)


class PilDecoder(Decoder):
    """libjpeg-turbo oracle backend.

    RGB via Pillow; QUANT/DCT and YUV via the ctypes shim over the system
    libjpeg (host/oracle_native.py), mirroring the reference vtbl's
    ``jpeg_read_coefficients`` / ``jpeg_read_raw_data`` cuts
    (jpeg_wrap.c:137-201).  PACK has no libjpeg analogue.
    """

    name = "pil"

    def io_bytes(self, out: StageArg = OutputStage.RGB) -> dict:
        return {"upload": 0, "download": 0, "tables": 0, "payload": "none"}

    def host_entropy(self, out: StageArg = "rgb"):
        return None  # libjpeg does its own entropy work inside decode()

    def decode(self, out: StageArg = OutputStage.RGB):
        from jaxjpeg.host import oracle_native
        from jaxjpeg.testing import oracle

        stage = _stage(out)
        if stage in (OutputStage.QUANT, OutputStage.DCT, OutputStage.YUV):
            if not oracle_native.available():
                raise JpegUnsupportedError(
                    "libjpeg oracle shim unavailable (no system libjpeg); "
                    f"PIL backend cannot serve the {stage.value} stage"
                )
            if stage == OutputStage.YUV:
                return YuvOutput(planes=oracle_native.libjpeg_raw_yuv(self.data))
            coefs, qts = oracle_native.libjpeg_coefficients(self.data)
            if stage == OutputStage.QUANT:
                return CoefOutput(coefs=coefs)
            # DCT = dequantized coefficients, int32 (same contract as
            # _coef_stage; libjpeg's own qtables do the dequant).
            dq = [
                c.astype(np.int32) * q.astype(np.int32).reshape(8, 8)
                for c, q in zip(coefs, qts)
            ]
            return CoefOutput(coefs=dq)
        if stage != OutputStage.RGB:
            raise JpegUnsupportedError(
                f"PIL oracle backend only provides rgb/yuv/quant/dct, "
                f"not {stage.value}"
            )
        hdr = self.decode_header()
        if hdr.ncomps == 1:
            y = oracle.pil_decode_gray(self.data)
            return np.repeat(y[..., None], 3, axis=-1)
        return oracle.pil_decode_rgb(self.data)


_BACKENDS = {
    "host": HostDecoder,
    "device": DeviceDecoder,
    "pil": PilDecoder,
    "libjpeg": PilDecoder,  # oracle alias, mirrors --impl libjpeg
    "xjpeg": HostDecoder,   # alias, mirrors --impl xjpeg
}


def get_decoder(data: bytes, impl: str = "device", **kwargs) -> Decoder:
    try:
        cls = _BACKENDS[impl]
    except KeyError:
        raise ValueError(
            f"unknown decoder impl {impl!r}; choose from {sorted(_BACKENDS)}"
        )
    return cls(data, **kwargs)


def decode_header(data: bytes) -> JpegHeader:
    return parse(data, headers_only=True).header


def decode(
    data: bytes, out: StageArg = OutputStage.RGB, impl: str = "device", **kwargs
):
    """One-shot decode convenience entry point."""
    return get_decoder(data, impl=impl, **kwargs).decode(out)
