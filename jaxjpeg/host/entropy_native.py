"""ctypes binding for the native (C++) restart-parallel entropy decoder.

Drop-in replacement for the Python scan decoder (host/entropy.py) producing
identical dense coefficient tensors; selected automatically by the engine
when the shared object is available (built on demand, host/native/build.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from jaxjpeg.errors import JpegFormatError
from jaxjpeg.host.entropy import ScanResult
from jaxjpeg.host.parser import ParsedJpeg
from jaxjpeg.info import scan_to_frame_order
from jaxjpeg.utils.logging import get_logger

log = get_logger("entropy")

_ERROR_NAMES = {
    1: "bad Huffman table",
    2: "invalid DC Huffman code",
    3: "invalid AC Huffman code",
    4: "AC index outside block",
    5: "bad parameters",
    6: "pack stream capacity overflow",
}


class _ScanConfig(ctypes.Structure):
    _fields_ = [
        ("ncomps", ctypes.c_int32),
        ("nhmb", ctypes.c_int32),
        ("nvmb", ctypes.c_int32),
        ("restart_interval", ctypes.c_int32),
        ("hsamp", ctypes.c_int32 * 4),
        ("vsamp", ctypes.c_int32 * 4),
        ("dc_tbl", ctypes.c_int32 * 4),
        ("ac_tbl", ctypes.c_int32 * 4),
    ]


_lib = None
_lib_lock = threading.Lock()
_unavailable = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _unavailable
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _unavailable:
            return None
        from jaxjpeg.host.native.build import shared_object_path

        path = shared_object_path()
        if path is None:
            _unavailable = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.xjpeg_decode_scan.restype = ctypes.c_int32
        lib.xjpeg_decode_scan.argtypes = [
            ctypes.c_char_p,                      # data
            ctypes.c_int64,                       # len
            ctypes.POINTER(ctypes.c_int64),       # seg_starts
            ctypes.POINTER(ctypes.c_int64),       # seg_ends
            ctypes.c_int64,                       # nseg
            ctypes.c_char_p,                      # huff_counts (8*16)
            ctypes.c_char_p,                      # huff_symbols (8*256)
            ctypes.c_char_p,                      # huff_present (8)
            ctypes.POINTER(_ScanConfig),
            ctypes.POINTER(ctypes.c_void_p),      # coef_out pointers
            ctypes.c_int32,                       # n_threads
        ]
        lib.xjpeg_decode_scan_pack.restype = ctypes.c_int32
        lib.xjpeg_decode_scan_pack.argtypes = [
            ctypes.c_char_p,                      # data
            ctypes.c_int64,                       # len
            ctypes.POINTER(ctypes.c_int64),       # seg_starts
            ctypes.POINTER(ctypes.c_int64),       # seg_ends
            ctypes.c_int64,                       # nseg
            ctypes.c_char_p,                      # huff_counts
            ctypes.c_char_p,                      # huff_symbols
            ctypes.c_char_p,                      # huff_present
            ctypes.POINTER(_ScanConfig),
            ctypes.POINTER(ctypes.c_void_p),      # coef_out pointers
            ctypes.c_void_p,                      # pack_out u16
            ctypes.c_void_p,                      # entry_counts i32
            ctypes.c_void_p,                      # block_offsets i32
            ctypes.c_int64,                       # max_entries
            ctypes.c_int64,                       # blocks_per_seg
            ctypes.c_int32,                       # n_threads
        ]
        lib.xjpeg_pack_streams.restype = ctypes.c_int32
        lib.xjpeg_pack_streams.argtypes = [
            ctypes.c_char_p,                      # data
            ctypes.c_int64,                       # len
            ctypes.POINTER(ctypes.c_int64),       # seg_starts
            ctypes.POINTER(ctypes.c_int64),       # seg_ends
            ctypes.c_int64,                       # nseg
            ctypes.c_int64,                       # row_bytes
            ctypes.c_void_p,                      # mat (or NULL)
            ctypes.POINTER(ctypes.c_int64),       # out_max_destuffed (or NULL)
            ctypes.c_int32,                       # n_threads
        ]
        lib.xjpeg_index_scan.restype = ctypes.c_int32
        lib.xjpeg_index_scan.argtypes = [
            ctypes.c_char_p,                      # data
            ctypes.c_int64,                       # len
            ctypes.c_int64,                       # seg_start
            ctypes.c_int64,                       # seg_end
            ctypes.c_char_p,                      # huff_counts
            ctypes.c_char_p,                      # huff_symbols
            ctypes.c_char_p,                      # huff_present
            ctypes.POINTER(_ScanConfig),
            ctypes.c_int64,                       # interval (MCUs/pseudo-seg)
            ctypes.c_void_p,                      # out_bitpos i64
            ctypes.c_void_p,                      # out_dc i32
            ctypes.POINTER(ctypes.c_int64),       # out_end
        ]
        lib.xjpeg_pack_streams_bits.restype = ctypes.c_int32
        lib.xjpeg_pack_streams_bits.argtypes = [
            ctypes.c_char_p,                      # data
            ctypes.c_int64,                       # len
            ctypes.c_int64,                       # seg_start
            ctypes.c_int64,                       # seg_end
            ctypes.c_void_p,                      # bitpos i64
            ctypes.c_int64,                       # nseg
            ctypes.c_int64,                       # end_bit
            ctypes.c_int64,                       # row_bytes
            ctypes.c_void_p,                      # mat
            ctypes.c_int32,                       # n_threads
        ]
        lib.xjpeg_index_scan_pack.restype = ctypes.c_int32
        lib.xjpeg_index_scan_pack.argtypes = [
            ctypes.c_char_p,                      # data
            ctypes.c_int64,                       # len
            ctypes.c_int64,                       # seg_start
            ctypes.c_int64,                       # seg_end
            ctypes.c_char_p,                      # huff_counts
            ctypes.c_char_p,                      # huff_symbols
            ctypes.c_char_p,                      # huff_present
            ctypes.POINTER(_ScanConfig),
            ctypes.c_int64,                       # interval
            ctypes.c_void_p,                      # out_bitpos i64
            ctypes.c_void_p,                      # out_dc i32
            ctypes.POINTER(ctypes.c_int64),       # out_end
            ctypes.c_int64,                       # row_bytes
            ctypes.c_void_p,                      # mat
            ctypes.c_int32,                       # n_threads
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def default_threads() -> int:
    env = os.environ.get("JAXJPEG_HOST_THREADS")
    if env:
        return max(1, int(env))
    return min(os.cpu_count() or 1, 16)


def decode_scan(
    parsed: ParsedJpeg,
    n_threads: Optional[int] = None,
    want_pack: bool = False,
    validate: bool = False,
) -> ScanResult:
    """Native scan decode -> dense per-component coefficients."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    header = parsed.header
    scan = header.scan
    if scan is None:
        raise JpegFormatError("no scan to decode")
    if validate:
        # Structural check the python decoder performs under validate=True
        # (the C++ core reports only per-symbol ERR codes).
        interval_v = header.restart_interval or header.n_mcus
        expected = -(-header.n_mcus // interval_v)
        if len(parsed.segments) > expected:
            raise JpegFormatError("more restart segments than MCUs")
    if n_threads is None:
        n_threads = default_threads()

    counts = np.zeros((8, 16), dtype=np.uint8)
    symbols = np.zeros((8, 256), dtype=np.uint8)
    present = np.zeros(8, dtype=np.uint8)
    for slot, spec in enumerate(list(header.dc_tables) + list(header.ac_tables)):
        if spec is None:
            continue
        counts[slot] = spec.counts
        symbols[slot, : len(spec.symbols)] = spec.symbols
        present[slot] = 1

    cfg = _ScanConfig()
    cfg.ncomps = len(scan.comp_idx)
    cfg.nhmb = header.nhmb
    cfg.nvmb = header.nvmb
    cfg.restart_interval = header.restart_interval
    comps = [header.components[i] for i in scan.comp_idx]
    for ci, comp in enumerate(comps):
        cfg.hsamp[ci] = comp.hsamp
        cfg.vsamp[ci] = comp.vsamp
        cfg.dc_tbl[ci] = scan.dc_tbl[ci]
        cfg.ac_tbl[ci] = scan.ac_tbl[ci]

    coefs: List[np.ndarray] = [
        np.zeros((c.vblocks, c.hblocks, 8, 8), dtype=np.int16) for c in comps
    ]
    out_ptrs = (ctypes.c_void_p * 4)()
    for ci, arr in enumerate(coefs):
        out_ptrs[ci] = arr.ctypes.data_as(ctypes.c_void_p).value

    nseg = len(parsed.segments)
    # Keep the numpy arrays referenced until after the native call.
    starts_np = np.ascontiguousarray(parsed.segments[:, 0])
    ends_np = np.ascontiguousarray(parsed.segments[:, 1])
    seg_starts = starts_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    seg_ends = ends_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    if want_pack:
        # One extra entry per block covers the worst case (DC + 63 AC or
        # DC + ACs + EOB).
        interval = header.restart_interval or header.n_mcus
        bpm = sum(c.hsamp * c.vsamp for c in comps)
        blocks_per_seg = interval * bpm
        max_entries = blocks_per_seg * 65
        pack_out = np.zeros((nseg, max_entries), dtype=np.uint16)
        entry_counts = np.zeros(nseg, dtype=np.int32)
        block_offsets = np.zeros((nseg, blocks_per_seg), dtype=np.int32)
        rc = lib.xjpeg_decode_scan_pack(
            parsed.data, len(parsed.data), seg_starts, seg_ends, nseg,
            counts.tobytes(), symbols.tobytes(), present.tobytes(),
            ctypes.byref(cfg), out_ptrs,
            pack_out.ctypes.data_as(ctypes.c_void_p),
            entry_counts.ctypes.data_as(ctypes.c_void_p),
            block_offsets.ctypes.data_as(ctypes.c_void_p),
            max_entries, blocks_per_seg, n_threads,
        )
        if rc != 0:
            raise JpegFormatError(
                f"native entropy decode failed: {_ERROR_NAMES.get(rc, rc)}"
            )
        # Stitch per-segment streams into the reference's single global
        # stream (segments are already in scan order).
        bases = np.cumsum(entry_counts, dtype=np.int64) - entry_counts
        mask = (
            np.arange(max_entries, dtype=np.int64)[None, :]
            < entry_counts[:, None]
        )
        stream = pack_out[mask]
        # Global per-block indexes: within-segment offsets + segment base,
        # laid out per component exactly like the coefficient assembly.
        goff = block_offsets.astype(np.int64) + bases[:, None]
        goff = goff.reshape(nseg * interval, bpm)[: header.n_mcus]
        pack_index = []
        off = 0
        for c in comps:
            nb = c.hsamp * c.vsamp
            blk = goff[:, off : off + nb]
            off += nb
            blk = blk.reshape(header.nvmb, header.nhmb, c.vsamp, c.hsamp)
            blk = blk.transpose(0, 2, 1, 3).reshape(
                header.nvmb * c.vsamp, header.nhmb * c.hsamp
            )
            pack_index.append(blk.astype(np.int32))
        return ScanResult(
            coefs=scan_to_frame_order(coefs, scan.comp_idx),
            pack=stream.astype(np.uint16),
            pack_index=scan_to_frame_order(pack_index, scan.comp_idx),
        )

    rc = lib.xjpeg_decode_scan(
        parsed.data,
        len(parsed.data),
        seg_starts,
        seg_ends,
        nseg,
        counts.tobytes(),
        symbols.tobytes(),
        present.tobytes(),
        ctypes.byref(cfg),
        out_ptrs,
        n_threads,
    )
    if rc != 0:
        raise JpegFormatError(
            f"native entropy decode failed: {_ERROR_NAMES.get(rc, rc)}"
        )
    return ScanResult(coefs=scan_to_frame_order(coefs, scan.comp_idx))


def max_destuffed_len(
    data: bytes, starts: np.ndarray, ends: np.ndarray,
    n_threads: Optional[int] = None,
) -> int:
    """Max destuffed byte length over the restart segments (native pass)."""
    lib = _load()
    assert lib is not None
    out = ctypes.c_int64(0)
    rc = lib.xjpeg_pack_streams(
        data, len(data),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts), 0, None, ctypes.byref(out),
        n_threads if n_threads is not None else default_threads(),
    )
    if rc != 0:
        raise JpegFormatError(f"native pack failed: {_ERROR_NAMES.get(rc, rc)}")
    return int(out.value)


def pack_streams(
    data: bytes, starts: np.ndarray, ends: np.ndarray, mat: np.ndarray,
    n_threads: Optional[int] = None,
) -> int:
    """Destuff + 1-pad each segment into row si of ``mat`` (uint8, C-order).

    Returns the max destuffed segment length in bytes (the same value
    ``max_destuffed_len`` reports) so a caller packing into a pre-sized
    matrix in one pass can verify no row truncated.
    """
    lib = _load()
    assert lib is not None
    assert mat.dtype == np.uint8 and mat.flags.c_contiguous
    out = ctypes.c_int64(0)
    rc = lib.xjpeg_pack_streams(
        data, len(data),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts), mat.shape[1],
        mat.ctypes.data_as(ctypes.c_void_p), ctypes.byref(out),
        n_threads if n_threads is not None else default_threads(),
    )
    if rc != 0:
        raise JpegFormatError(f"native pack failed: {_ERROR_NAMES.get(rc, rc)}")
    return int(out.value)


def _tables_and_config(header, scan) -> tuple:
    """(counts, symbols, present, cfg) for the native calls, scan order."""
    counts = np.zeros((8, 16), dtype=np.uint8)
    symbols = np.zeros((8, 256), dtype=np.uint8)
    present = np.zeros(8, dtype=np.uint8)
    for slot, spec in enumerate(
        list(header.dc_tables) + list(header.ac_tables)
    ):
        if spec is None:
            continue
        counts[slot] = spec.counts
        symbols[slot, : len(spec.symbols)] = spec.symbols
        present[slot] = 1
    cfg = _ScanConfig()
    cfg.ncomps = len(scan.comp_idx)
    cfg.nhmb = header.nhmb
    cfg.nvmb = header.nvmb
    cfg.restart_interval = header.restart_interval
    comps = [header.components[i] for i in scan.comp_idx]
    for ci, comp in enumerate(comps):
        cfg.hsamp[ci] = comp.hsamp
        cfg.vsamp[ci] = comp.vsamp
        cfg.dc_tbl[ci] = scan.dc_tbl[ci]
        cfg.ac_tbl[ci] = scan.ac_tbl[ci]
    return counts, symbols, present, cfg


def index_scan(
    parsed: ParsedJpeg, interval: int
) -> tuple:
    """DRI-less pseudo-segmentation: Huffman-walk code lengths only.

    Returns (bitpos, dc_base, end_bit): destuffed-stream bit offset and
    per-component DC predictor entering each pseudo segment of
    ``interval`` MCUs, plus the scan's total bit length.  Serial (the
    stream is one dependency chain); the coefficient decode then runs
    restart-parallel on the device (xjpeg_host.cpp:xjpeg_index_scan).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    header = parsed.header
    scan = header.scan
    if scan is None:
        raise JpegFormatError("no scan to decode")
    if len(parsed.segments) != 1:
        raise ValueError("index_scan is for single-segment (no-DRI) streams")
    counts, symbols, present, cfg = _tables_and_config(header, scan)
    s0, e0 = parsed.segments[0]
    nseg = -(-header.n_mcus // interval)
    bitpos = np.zeros(nseg, dtype=np.int64)
    dc_base = np.zeros((nseg, cfg.ncomps), dtype=np.int32)
    end = ctypes.c_int64(0)
    rc = lib.xjpeg_index_scan(
        parsed.data, len(parsed.data), s0, e0,
        counts.tobytes(), symbols.tobytes(), present.tobytes(),
        ctypes.byref(cfg), interval,
        bitpos.ctypes.data_as(ctypes.c_void_p),
        dc_base.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(end),
    )
    if rc != 0:
        raise JpegFormatError(
            f"native index scan failed: {_ERROR_NAMES.get(rc, rc)}"
        )
    return bitpos, dc_base, int(end.value)


def index_scan_pack(
    parsed: ParsedJpeg, interval: int, mat: np.ndarray,
    n_threads: Optional[int] = None,
) -> tuple:
    """Fused index_scan + pack_streams_bits: one destuff pass per frame.

    ``mat`` rows (pinned width) receive the bit-aligned pseudo segments;
    returns (bitpos, dc_base, end_bit).  Raises JpegUnsupportedError-like
    JpegFormatError("pack stream capacity overflow") if a segment needs
    more than mat.shape[1] bytes -- the caller rebuilds without the pin.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    header = parsed.header
    scan = header.scan
    if scan is None:
        raise JpegFormatError("no scan to decode")
    if len(parsed.segments) != 1:
        raise ValueError("index_scan_pack is for single-segment streams")
    assert mat.dtype == np.uint8 and mat.flags.c_contiguous
    counts, symbols, present, cfg = _tables_and_config(header, scan)
    s0, e0 = parsed.segments[0]
    nseg = -(-header.n_mcus // interval)
    assert mat.shape[0] >= nseg
    bitpos = np.zeros(nseg, dtype=np.int64)
    dc_base = np.zeros((nseg, cfg.ncomps), dtype=np.int32)
    end = ctypes.c_int64(0)
    rc = lib.xjpeg_index_scan_pack(
        parsed.data, len(parsed.data), s0, e0,
        counts.tobytes(), symbols.tobytes(), present.tobytes(),
        ctypes.byref(cfg), interval,
        bitpos.ctypes.data_as(ctypes.c_void_p),
        dc_base.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(end), mat.shape[1],
        mat.ctypes.data_as(ctypes.c_void_p),
        n_threads if n_threads is not None else default_threads(),
    )
    if rc != 0:
        raise JpegFormatError(
            f"native fused scan+pack failed: {_ERROR_NAMES.get(rc, rc)}"
        )
    return bitpos, dc_base, int(end.value)


def pack_streams_bits(
    parsed: ParsedJpeg, bitpos: np.ndarray, end_bit: int, mat: np.ndarray,
    n_threads: Optional[int] = None,
) -> None:
    """Pack pseudo segments bit-aligned: row si of ``mat`` holds the
    destuffed bytes starting at bitpos[si], left-shifted to bit 0."""
    lib = _load()
    assert lib is not None
    assert mat.dtype == np.uint8 and mat.flags.c_contiguous
    s0, e0 = parsed.segments[0]
    rc = lib.xjpeg_pack_streams_bits(
        parsed.data, len(parsed.data), s0, e0,
        bitpos.ctypes.data_as(ctypes.c_void_p), len(bitpos),
        end_bit, mat.shape[1], mat.ctypes.data_as(ctypes.c_void_p),
        n_threads if n_threads is not None else default_threads(),
    )
    if rc != 0:
        raise JpegFormatError(
            f"native bit pack failed: {_ERROR_NAMES.get(rc, rc)}"
        )
