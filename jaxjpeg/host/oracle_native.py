"""Independent libjpeg-turbo oracle over ctypes (QUANT / YUV / RGB cuts).

Mirrors the reference's libjpeg vtbl backend semantics
(/root/reference/src/jpeg_wrap.c:137-201): coefficients via
``jpeg_read_coefficients``, raw YCbCr via ``jpeg_read_raw_data`` with
pinned ``do_fancy_upsampling=FALSE`` + ``JDCT_ISLOW``, and RGB with the
islow DCT.  The shim links the *system* libjpeg-turbo, so differential
tests at these cuts compare against libjpeg itself, not our own encoder.

Buffer geometry (MCU-aligned block grids) is computed from our parser's
header; libjpeg re-validates the stream independently.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from jaxjpeg.errors import JpegFormatError
from jaxjpeg.host.native import build
from jaxjpeg.host.parser import parse
from jaxjpeg.utils.logging import get_logger

log = get_logger("engine")

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    path = build.oracle_object_path()
    if path is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.joracle_header.restype = ctypes.c_int
    lib.joracle_coefficients.restype = ctypes.c_int
    lib.joracle_raw_yuv.restype = ctypes.c_int
    lib.joracle_rgb.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _err_buf():
    return ctypes.create_string_buffer(256)


def _raise(rc, err):
    msg = err.value.decode(errors="replace") or f"rc={rc}"
    raise JpegFormatError(f"libjpeg oracle: {msg}")


def _ptr_array(arrays: List[np.ndarray], ctype):
    ptrs = (ctypes.POINTER(ctype) * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctype))
    return ptrs


def libjpeg_probe(data: bytes) -> Optional[str]:
    """Header-parse ``data`` with libjpeg; None if accepted, else message."""
    lib = _load()
    if lib is None:
        return "oracle unavailable"
    out = np.zeros(16, dtype=np.int32)
    err = _err_buf()
    rc = lib.joracle_header(
        data, ctypes.c_int64(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err,
    )
    if rc:
        return err.value.decode(errors="replace")
    return None


def libjpeg_coefficients(
    data: bytes,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """QUANT cut: per-component (vb, hb, 8, 8) int16 + 64-entry qtables."""
    lib = _load()
    if lib is None:
        raise JpegFormatError("libjpeg oracle unavailable")
    hdr = parse(data).header
    coefs = [
        np.zeros((c.vblocks, c.hblocks, 8, 8), dtype=np.int16)
        for c in hdr.components
    ]
    qts = [np.zeros(64, dtype=np.uint16) for _ in hdr.components]
    vb = np.array([c.vblocks for c in hdr.components], dtype=np.int32)
    hb = np.array([c.hblocks for c in hdr.components], dtype=np.int32)
    err = _err_buf()
    rc = lib.joracle_coefficients(
        data, ctypes.c_int64(len(data)), len(coefs),
        vb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _ptr_array(coefs, ctypes.c_int16),
        _ptr_array(qts, ctypes.c_uint16),
        err,
    )
    if rc:
        _raise(rc, err)
    return coefs, qts


def libjpeg_raw_yuv(data: bytes) -> List[np.ndarray]:
    """YUV cut: per-component uint8 planes trimmed to true dims."""
    lib = _load()
    if lib is None:
        raise JpegFormatError("libjpeg oracle unavailable")
    hdr = parse(data).header
    planes = [
        np.zeros((c.vblocks * 8, c.hblocks * 8), dtype=np.uint8)
        for c in hdr.components
    ]
    ph = np.array([p.shape[0] for p in planes], dtype=np.int32)
    pw = np.array([p.shape[1] for p in planes], dtype=np.int32)
    err = _err_buf()
    rc = lib.joracle_raw_yuv(
        data, ctypes.c_int64(len(data)), len(planes),
        ph.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _ptr_array(planes, ctypes.c_uint8),
        err,
    )
    if rc:
        _raise(rc, err)
    return [
        p[: c.height, : c.width] for p, c in zip(planes, hdr.components)
    ]


def libjpeg_rgb(data: bytes, fancy: bool = True) -> np.ndarray:
    """RGB cut with pinned islow DCT; ``fancy`` picks the upsampler."""
    lib = _load()
    if lib is None:
        raise JpegFormatError("libjpeg oracle unavailable")
    hdr = parse(data).header
    out = np.zeros((hdr.height, hdr.width, 3), dtype=np.uint8)
    err = _err_buf()
    rc = lib.joracle_rgb(
        data, ctypes.c_int64(len(data)), int(fancy),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(out.strides[0]), err,
    )
    if rc:
        _raise(rc, err)
    return out
