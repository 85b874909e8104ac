"""Host (CPU) entropy decode: restart segments -> dense coefficient tensors.

Python reference implementation of the scan decoder (the analogue of
``xjpeg_decode_scan``, xjpeg.c:449-632), restructured for the device engine:

* Restart segments are decoded independently (each resets the bit buffer
  and DC predictors, xjpeg.c:613-618), so this loop is trivially
  parallelisable and is the contract the native C++ decoder and the
  device decoder both implement.
* Output is a *dense per-component coefficient tensor* on the MCU-aligned
  block grid -- ``(vblocks, hblocks, 8, 8)`` int16, natural (raster) order
  -- ready for ``jax.device_put``.  No stacked texture layout.
* The PACK stage produces the reference's packed stream format
  (xjpeg.c:484-496, 513-518, 531-535): per block, a u16 ``DC & 0xfff``
  entry (absolute DC after prediction), then ``run<<12 | value&0xfff``
  per non-zero AC, then ``0x0000`` as EOB (omitted when the block fills
  to index 63), plus a per-block start-offset index.

A from-scratch implementation decoded with full-width Huffman LUTs
(huffman.py); nothing here is translated from the reference's C.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from jaxjpeg.errors import JpegFormatError
from jaxjpeg.host.huffman import HuffmanLut, huff_extend
from jaxjpeg.host.parser import ParsedJpeg
from jaxjpeg.info import JpegHeader, scan_to_frame_order
from jaxjpeg.ops.zigzag import ZIGZAG


def destuff(data: bytes) -> bytes:
    """Remove 0xFF00 byte stuffing from one entropy-coded segment.

    Vectorised: every 0x00 that follows a 0xFF is dropped
    (cf. XJPEG_FILL_BYTE, xjpeg.c:113-127).
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) == 0:
        return b""
    stuffed = np.flatnonzero((buf[:-1] == 0xFF) & (buf[1:] == 0x00)) + 1
    if len(stuffed) == 0:
        return data
    return np.delete(buf, stuffed).tobytes()


class BitReader:
    """MSB-first bit reader over destuffed bytes, 1-padded at the end.

    Same contract as the reference's bit buffer (XJPEG_FILL_BITS/PEEK/
    DECODE_BITS, xjpeg.c:129-161) minus the stuffing logic, which is done
    up front by :func:`destuff`.
    """

    __slots__ = ("buf", "pos", "acc", "nbits", "padded")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.padded = 0  # 1-padding bits appended past the real data

    def _fill(self, need: int) -> None:
        buf, pos, n = self.buf, self.pos, len(self.buf)
        acc, nbits = self.acc, self.nbits
        while nbits < need:
            if pos < n:
                acc = (acc << 8) | buf[pos]
                pos += 1
            else:
                acc = (acc << 8) | 0xFF
                self.padded += 8
            nbits += 8
        self.buf, self.pos, self.acc, self.nbits = buf, pos, acc, nbits

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill(16)
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int) -> None:
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill(n)
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def bits_consumed(self) -> int:
        return 8 * self.pos - self.nbits + self.padded


@dataclasses.dataclass
class ScanResult:
    """Entropy-decode products for one image.

    ``coefs``: per component, (vblocks, hblocks, 8, 8) int16 quantized
    coefficients in natural order (the QUANT stage cut).
    ``pack``/``pack_index``: the PACK stage cut (optional).
    """

    coefs: List[np.ndarray]
    pack: Optional[np.ndarray] = None          # (n_entries,) uint16
    pack_index: Optional[List[np.ndarray]] = None  # per comp (vblocks, hblocks) int32

    @property
    def packed(self) -> int:
        return 0 if self.pack is None else int(len(self.pack))


def _decode_segment(
    reader: BitReader,
    header: JpegHeader,
    luts: Sequence[Tuple[HuffmanLut, HuffmanLut]],
    mcu_range: Tuple[int, int],
    zz_out: List[np.ndarray],
    dc_pred: List[int],
    pack_out: Optional[List[int]],
    pack_index: Optional[List[np.ndarray]],
) -> None:
    """Decode MCUs [mcu_range) from one restart segment into zz_out.

    ``zz_out[c]`` is an (n_blocks_c, 64) int16 array in *zig-zag order*,
    indexed in component-raster block order.
    """
    scan = header.scan
    assert scan is not None
    nhmb = header.nhmb
    comps = [header.components[i] for i in scan.comp_idx]
    peek16 = reader.peek16
    get = reader.get
    skip = reader.skip

    for mcu in range(*mcu_range):
        mby, mbx = divmod(mcu, nhmb)
        for ci, comp in enumerate(comps):
            dc_lut, ac_lut = luts[ci]
            dc_sym, dc_len = dc_lut.symbol, dc_lut.length
            ac_sym, ac_len = ac_lut.symbol, ac_lut.length
            hs, vs = comp.hsamp, comp.vsamp
            hblocks = comp.hblocks
            out = zz_out[ci]
            for sby in range(vs):
                for sbx in range(hs):
                    block = out[(mby * vs + sby) * hblocks + (mbx * hs + sbx)]
                    # --- DC ---
                    w = peek16()
                    s = int(dc_sym[w])
                    ln = int(dc_len[w])
                    if ln == 0:
                        raise JpegFormatError("invalid DC Huffman code")
                    skip(ln)
                    if s > 15:
                        raise JpegFormatError(f"DC size {s} > 15")
                    diff = huff_extend(get(s), s) if s else 0
                    dc_pred[ci] += diff
                    block[0] = dc_pred[ci]
                    if pack_out is not None:
                        bi = (mby * vs + sby) * hblocks + (mbx * hs + sbx)
                        pack_index[ci].flat[bi] = len(pack_out)
                        pack_out.append(dc_pred[ci] & 0xFFF)
                    # --- AC ---
                    k = 0
                    while k < 63:
                        w = peek16()
                        rs = int(ac_sym[w])
                        ln = int(ac_len[w])
                        if ln == 0:
                            raise JpegFormatError("invalid AC Huffman code")
                        skip(ln)
                        if rs == 0:  # EOB
                            if pack_out is not None:
                                pack_out.append(0)
                            break
                        run = rs >> 4
                        size = rs & 0x0F
                        k += run + 1  # ZRL (run=15, size=0) advances 16 total
                        if size == 0:
                            if run != 15:
                                raise JpegFormatError(
                                    f"invalid AC symbol run={run} size=0"
                                )
                            if k > 63:
                                raise JpegFormatError("ZRL outside block")
                            if pack_out is not None:
                                pack_out.append(0xF000)
                            continue
                        if k > 63:
                            raise JpegFormatError("AC index outside block")
                        value = huff_extend(get(size), size)
                        block[k] = value
                        if pack_out is not None:
                            pack_out.append(((run & 0xF) << 12) | (value & 0xFFF))


def decode_scan(
    parsed: ParsedJpeg,
    want_pack: bool = False,
    validate: bool = True,
) -> ScanResult:
    """Entropy-decode the full scan to dense quantized coefficients."""
    header = parsed.header
    scan = header.scan
    if scan is None:
        raise JpegFormatError("no scan to decode")
    luts = [
        (
            _lut(header.dc_tables, scan.dc_tbl[i], "DC"),
            _lut(header.ac_tables, scan.ac_tbl[i], "AC"),
        )
        for i in range(len(scan.comp_idx))
    ]
    comps = [header.components[i] for i in scan.comp_idx]
    zz_out = [
        np.zeros((c.vblocks * c.hblocks, 64), dtype=np.int16) for c in comps
    ]
    pack_out: Optional[List[int]] = [] if want_pack else None
    pack_index = (
        [np.zeros((c.vblocks, c.hblocks), dtype=np.int32) for c in comps]
        if want_pack
        else None
    )

    interval = header.restart_interval or header.n_mcus
    dc_pred = [0] * len(comps)
    for seg_i, (start, end) in enumerate(parsed.segments):
        mcu_lo = seg_i * interval
        mcu_hi = min(mcu_lo + interval, header.n_mcus)
        if mcu_lo >= header.n_mcus:
            if validate:
                raise JpegFormatError("more restart segments than MCUs")
            break
        reader = BitReader(destuff(parsed.data[start:end]))
        dc_pred = [0] * len(comps)  # DC predictors reset per segment
        _decode_segment(
            reader, header, luts, (mcu_lo, mcu_hi), zz_out, dc_pred,
            pack_out, pack_index,
        )

    # One vectorised de-zig-zag over everything at the end.
    coefs = []
    for c, zz in zip(comps, zz_out):
        nat = np.zeros_like(zz)
        nat[:, ZIGZAG] = zz
        coefs.append(nat.reshape(c.vblocks, c.hblocks, 8, 8))
    pack_arr = (
        np.array(pack_out, dtype=np.uint16) if pack_out is not None else None
    )
    # Decode ran in scan order; the public contract is frame order.
    coefs = scan_to_frame_order(coefs, scan.comp_idx)
    if pack_index is not None:
        pack_index = scan_to_frame_order(pack_index, scan.comp_idx)
    return ScanResult(coefs=coefs, pack=pack_arr, pack_index=pack_index)


def _lut(tables, idx: int, kind: str) -> HuffmanLut:
    spec = tables[idx]
    if spec is None:
        raise JpegFormatError(f"scan references undefined {kind} table {idx}")
    return HuffmanLut.build(spec)
