"""JPEG marker parser: bytes -> JpegHeader + entropy-coded segment spans.

Host-side analogue of the reference's marker dispatch loop and segment
parsers (xjpeg.c:704-763 dispatch; DQT :219-256; DHT :258-345; SOF0
:350-410; DRI :412-420; SOS :634-695) rebuilt for the device engine: instead
of feeding a serial bit reader, parsing here produces (a) a static
``JpegHeader`` and (b) the byte spans of every restart segment in the
entropy-coded data.  Restart segments are the unit of parallel entropy
decode (SURVEY.md section 5), so finding their boundaries -- a cheap
byte-level scan, vectorised with numpy -- is a first-class parsing product
rather than a validation detail.

Supported subset mirrors the reference: SOF0 only, 8-bit, 1 or 3
components, sampling factors 1/2/4, single interleaved scan.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

from jaxjpeg.errors import JpegFormatError, JpegUnsupportedError
from jaxjpeg.info import (
    Component,
    HuffmanSpec,
    JpegHeader,
    QuantTable,
    ScanHeader,
    derive_geometry,
)
from jaxjpeg.ops.zigzag import zigzag_to_raster
from jaxjpeg.utils.logging import get_logger

log = get_logger("entropy")

# Marker bytes (second byte of the 0xFF xx pair).
M_SOF0 = 0xC0
M_SOF_OTHER = tuple(
    m for m in range(0xC1, 0xD0) if m not in (0xC4, 0xC8, 0xCC)
)  # SOF1..SOF15 minus DHT/JPG/DAC slots
M_DHT = 0xC4
M_DAC = 0xCC
M_RST0 = 0xD0
M_RST7 = 0xD7
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DQT = 0xDB
M_DNL = 0xDC
M_DRI = 0xDD
M_APP0 = 0xE0
M_COM = 0xFE


@dataclasses.dataclass(frozen=True)
class ParsedJpeg:
    """Parse result: header + location of the entropy-coded data.

    ``segments`` is an (nseg, 2) int64 array of (start, end) byte ranges,
    one row per restart segment of the single baseline scan, *excluding*
    the RSTn markers themselves.  For a stream without restarts there is
    exactly one row.  (An array, not tuples: consumers index it
    wholesale -- build_plan slices the columns straight into the native
    destuff/pack calls -- and a 1080p R=1 stream has ~8k rows.)
    """

    header: JpegHeader
    data: bytes
    segments: np.ndarray

    @property
    def entropy_bytes(self) -> int:
        if len(self.segments) == 0:
            return 0
        return int((self.segments[:, 1] - self.segments[:, 0]).sum())


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        if self.pos >= len(self.data):
            raise JpegFormatError("unexpected end of file")
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        if self.pos + 2 > len(self.data):
            raise JpegFormatError("unexpected end of file")
        v = struct.unpack_from(">H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise JpegFormatError("unexpected end of file")
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v


def _parse_dqt(r: _Reader, tables: list, validate: bool) -> None:
    """DQT: one or more tables per segment (cf. xjpeg.c:219-256)."""
    length = r.u16() - 2
    end = r.pos + length
    while r.pos < end:
        pq_tq = r.u8()
        pq, tq = pq_tq >> 4, pq_tq & 0x0F
        if tq > 3:
            raise JpegFormatError(f"DQT table id {tq} > 3")
        if pq > 1:
            raise JpegFormatError(f"DQT precision {pq} invalid")
        if pq:
            raw = np.frombuffer(r.take(128), dtype=">u2").astype(np.uint16)
        else:
            raw = np.frombuffer(r.take(64), dtype=np.uint8).astype(np.uint16)
        if validate and (raw == 0).any():
            raise JpegFormatError("DQT contains zero entries")
        tables[tq] = QuantTable(precision=pq, values=zigzag_to_raster(raw))
    if r.pos != end:
        raise JpegFormatError("DQT length mismatch")


def _parse_dht(r: _Reader, dc: list, ac: list, validate: bool) -> None:
    """DHT: one or more tables per segment (cf. xjpeg.c:258-345)."""
    length = r.u16() - 2
    end = r.pos + length
    while r.pos < end:
        tc_th = r.u8()
        tc, th = tc_th >> 4, tc_th & 0x0F
        if tc > 1:
            raise JpegFormatError(f"DHT class {tc} invalid (arithmetic?)")
        if th > 3:
            raise JpegFormatError(f"DHT table id {th} > 3")
        counts = np.frombuffer(r.take(16), dtype=np.uint8).copy()
        total = int(counts.sum())
        if total > 256:
            raise JpegFormatError("DHT has more than 256 symbols")
        symbols = np.frombuffer(r.take(total), dtype=np.uint8).copy()
        if validate:
            # Kraft inequality: the code space must not be over-subscribed.
            space = 0
            for i, n in enumerate(counts):
                space += int(n) << (16 - (i + 1))
            if space > (1 << 16):
                raise JpegFormatError("DHT code space over-subscribed")
        spec = HuffmanSpec(table_class=tc, counts=counts, symbols=symbols)
        (dc if tc == 0 else ac)[th] = spec
    if r.pos != end:
        raise JpegFormatError("DHT length mismatch")


def _parse_sof0(r: _Reader) -> Tuple[int, int, int, List[Component]]:
    """SOF0 frame header (cf. xjpeg.c:350-410)."""
    r.u16()  # length
    bits = r.u8()
    if bits != 8:
        raise JpegUnsupportedError(f"only 8-bit precision supported, got {bits}")
    height = r.u16()
    width = r.u16()
    if width == 0 or height == 0:
        raise JpegUnsupportedError("zero dimension (DNL streams unsupported)")
    ncomps = r.u8()
    if ncomps not in (1, 3):
        raise JpegUnsupportedError(f"only 1 or 3 components supported, got {ncomps}")
    comps = []
    seen_ids = set()
    for _ in range(ncomps):
        cid = r.u8()
        hv = r.u8()
        tq = r.u8()
        h, v = hv >> 4, hv & 0x0F
        if h not in (1, 2, 4) or v not in (1, 2, 4):
            raise JpegUnsupportedError(
                f"sampling factors must be 1, 2 or 4; got {h}x{v}"
            )  # factor 3 rejected like xjpeg.c:386,391
        if tq > 3:
            raise JpegFormatError(f"component quant index {tq} > 3")
        if cid in seen_ids:
            raise JpegFormatError(f"duplicate component id {cid}")
        seen_ids.add(cid)
        comps.append(Component(comp_id=cid, hsamp=h, vsamp=v, quant_idx=tq))
    if ncomps == 1:
        # T.81 A.2 / libjpeg (jdinput.c): a single-component scan is
        # NON-interleaved -- its MCU is one data unit and blocks cover a
        # ceil(w/8) x ceil(h/8) raster grid regardless of the declared
        # sampling factors (those only shape multi-component interleave).
        # Normalise to 1x1 so every downstream MCU computation follows
        # the non-interleaved rule.
        c = comps[0]
        comps = [
            Component(comp_id=c.comp_id, hsamp=1, vsamp=1, quant_idx=c.quant_idx)
        ]
    return bits, width, height, comps


def _parse_sos(r: _Reader, comps: List[Component], validate: bool) -> ScanHeader:
    """SOS scan header (cf. xjpeg.c:634-695). Baseline constraints enforced."""
    r.u16()  # length
    ns = r.u8()
    if ns != len(comps):
        raise JpegUnsupportedError(
            f"scan must cover all {len(comps)} components (got {ns}); "
            "non-interleaved multi-scan streams unsupported"
        )
    comp_idx, dc_tbl, ac_tbl = [], [], []
    for _ in range(ns):
        cs = r.u8()
        tda = r.u8()
        matches = [i for i, c in enumerate(comps) if c.comp_id == cs]
        if not matches:
            raise JpegFormatError(f"scan references unknown component id {cs}")
        comp_idx.append(matches[0])
        # Table slot ids index fixed 4-slot tuples (and, on the device
        # path, the kernel's (8, ...) table tensors) -- out-of-range ids
        # are structural corruption, rejected even with validate=False.
        td, ta = tda >> 4, tda & 0x0F
        if td > 3 or ta > 3:
            raise JpegFormatError(f"scan Huffman table id {td}/{ta} > 3")
        dc_tbl.append(td)
        ac_tbl.append(ta)
    # T.81 B.2.3 requires scan components in frame-header order.  We
    # accept permuted scans (strictly MORE tolerant than libjpeg, which
    # rejects them with "Invalid component ID in SOS" -- measured via
    # the ctypes oracle): the MCU interleave follows ``comp_idx`` and
    # every decoder emits its outputs reordered back to frame positions.
    # Duplicates stay hard errors (no meaningful decode exists).
    if len(set(comp_idx)) != len(comp_idx):
        raise JpegFormatError(f"duplicate component in scan: {comp_idx}")
    ss, se, ahl = r.u8(), r.u8(), r.u8()
    if (ss, se, ahl) != (0, 63, 0):
        raise JpegUnsupportedError(
            f"progressive/partial scan (Ss={ss} Se={se} AhAl={ahl:#x}) unsupported"
        )  # enforced like xjpeg.c:674-680
    return ScanHeader(
        comp_idx=tuple(comp_idx), dc_tbl=tuple(dc_tbl), ac_tbl=tuple(ac_tbl)
    )


def _scan_entropy_segments(
    data: bytes, start: int, expected_segments: Optional[int], validate: bool
) -> Tuple[np.ndarray, int]:
    """Split the entropy-coded data into restart segments.

    Fully vectorised byte scan: every 0xFF is either (a) stuffed
    (followed by 0x00, part of entropy data), (b) a fill byte (followed
    by 0xFF), (c) an RSTn separator, or (d) the terminating marker.
    Segment boundaries are the RSTn positions before the first
    terminating marker -- pure array arithmetic, no per-segment Python
    loop (a 1080p R=1 stream has ~8k segments; the loop form was ~60% of
    the whole parse).  Returns ((nseg, 2) int64 spans, position of the
    terminating marker).  The RSTn modulo-8 sequence check mirrors
    xjpeg.c:610-611.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    ff_pos = np.flatnonzero(buf[start:] == 0xFF) + start
    # Byte following each 0xFF (0 if at EOF -> treated as stuffed/truncated).
    nxt = np.zeros_like(ff_pos)
    in_range = ff_pos + 1 < len(buf)
    nxt[in_range] = buf[ff_pos[in_range] + 1]

    real = (nxt != 0x00) & (nxt != 0xFF)  # neither stuffed nor fill
    real_pos = ff_pos[real]
    real_m = nxt[real]
    is_rst = (real_m >= M_RST0) & (real_m <= M_RST7)
    non_rst = np.flatnonzero(~is_rst)
    if non_rst.size:
        t = int(non_rst[0])  # markers before the terminating one are RSTs
        end_pos = int(real_pos[t])
        final_end = end_pos
    else:
        t = int(real_pos.size)  # truncated: no terminating marker
        end_pos = len(data)
        final_end = len(data)
    rst_pos = real_pos[:t]
    if validate and t:
        seq = (real_m[:t] - M_RST0).astype(np.int64)
        expect = np.arange(t, dtype=np.int64) & 7
        bad = np.flatnonzero(seq != expect)
        if bad.size:
            b = int(bad[0])
            raise JpegFormatError(
                f"restart marker out of sequence: got RST{int(seq[b])}, "
                f"expected RST{b & 7}"
            )
    segments = np.empty((t + 1, 2), dtype=np.int64)
    segments[0, 0] = start
    segments[1:, 0] = rst_pos + 2
    segments[:-1, 1] = rst_pos
    segments[-1, 1] = final_end
    if expected_segments is not None and validate and len(segments) != expected_segments:
        raise JpegFormatError(
            f"expected {expected_segments} restart segments, found {len(segments)}"
        )
    return segments, end_pos


def parse(data: bytes, headers_only: bool = False, validate: bool = True) -> ParsedJpeg:
    """Parse a baseline JPEG stream.

    With ``headers_only`` the parse stops at SOS like the reference's
    ``xjpeg_decode_header`` (xjpeg.c:716-719, 765); the returned
    ``segments`` is then empty.
    """
    r = _Reader(data)
    if r.u8() != 0xFF or r.u8() != M_SOI:
        raise JpegFormatError("missing SOI marker")  # cf. xjpeg.c:779-781

    quant: list = [None, None, None, None]
    dc: list = [None, None, None, None]
    ac: list = [None, None, None, None]
    frame: Optional[Tuple[int, int, int, List[Component]]] = None
    restart_interval = 0
    scan: Optional[ScanHeader] = None
    segments = np.zeros((0, 2), dtype=np.int64)

    while True:
        b = r.u8()
        if b != 0xFF:
            raise JpegFormatError(f"expected marker, got byte {b:#x} at {r.pos - 1}")
        marker = r.u8()
        while marker == 0xFF:  # fill bytes before a marker are legal
            marker = r.u8()
        if marker == M_EOI:
            break
        if marker == M_SOI:
            raise JpegFormatError("duplicate SOI")
        if marker in M_SOF_OTHER:
            raise JpegUnsupportedError(
                f"SOF{marker - 0xC0}: only baseline sequential (SOF0) supported"
            )
        if marker == M_DAC:
            raise JpegUnsupportedError("arithmetic coding unsupported")
        if marker == M_DNL:
            raise JpegUnsupportedError("DNL unsupported")
        if marker == M_DQT:
            _parse_dqt(r, quant, validate)
        elif marker == M_DHT:
            _parse_dht(r, dc, ac, validate)
        elif marker == M_SOF0:
            if frame is not None:
                raise JpegFormatError("multiple SOF markers")  # cf. xjpeg.c:362
            frame = _parse_sof0(r)
        elif marker == M_DRI:
            r.u16()
            restart_interval = r.u16()
        elif marker == M_SOS:
            if frame is None:
                raise JpegFormatError("SOS before SOF")
            if scan is not None:
                raise JpegUnsupportedError("multiple scans unsupported")  # xjpeg.c:645
            scan = _parse_sos(r, frame[3], validate)
            if headers_only:
                break
            bits, width, height, comps0 = frame
            comps, nhmb, nvmb = derive_geometry(width, height, comps0)
            n_mcus = nhmb * nvmb
            expected = (
                -(-n_mcus // restart_interval) if restart_interval else 1
            )
            segments, end_pos = _scan_entropy_segments(
                data, r.pos, expected, validate
            )
            r.pos = end_pos
        else:
            # APPn / COM / anything else with a length: skip (xjpeg.c:757).
            length = r.u16()
            if length < 2:
                raise JpegFormatError("marker segment length < 2")
            r.take(length - 2)

    if frame is None:
        raise JpegFormatError("no frame (SOF0) found")
    if scan is None and not headers_only:
        raise JpegFormatError("no scan (SOS) found")

    bits, width, height, comps0 = frame
    comps, nhmb, nvmb = derive_geometry(width, height, comps0)
    if validate:
        for c in comps:
            if quant[c.quant_idx] is None:
                raise JpegFormatError(
                    f"component {c.comp_id} uses undefined quant table {c.quant_idx}"
                )
    header = JpegHeader(
        width=width,
        height=height,
        bits=bits,
        components=comps,
        quant_tables=tuple(quant),
        dc_tables=tuple(dc),
        ac_tables=tuple(ac),
        restart_interval=restart_interval,
        scan=scan,
        nhmb=nhmb,
        nvmb=nvmb,
    )
    return ParsedJpeg(header=header, data=data, segments=segments)
