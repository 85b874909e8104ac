"""From-scratch baseline JPEG *encoder* (test corpus generator).

The reference relies on whatever JPEG files the user supplies; our test
strategy (SURVEY.md section 4) needs bitstreams with controlled coverage:
every subsampling mode incl. 4:4:0 and 4:1:1 (which common encoders do not
emit), restart intervals, 16-bit quantization tables, and known ground-truth
quantized coefficients.  So the corpus generator is a real encoder:

* forward DCT via the orthonormal 8x8 DCT-II basis (float64),
* per-image *optimal* Huffman tables computed from symbol frequencies with
  the JPEG Annex K.2 algorithm (two-pass), so no standard tables are
  transcribed anywhere and decoders get exercised on non-default tables,
* interleaved single-scan emission with DC prediction, byte stuffing and
  restart markers.

``encode()`` returns both the bitstream and the exact quantized
coefficients it encoded -- the ground truth for QUANT-stage differential
tests (the analogue of the reference's --dump diffing, jpeg_gpu.c:641-700).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from jaxjpeg.info import ceil_div
from jaxjpeg.ops.zigzag import ZIGZAG

# Orthonormal 8-point DCT-II basis: JPEG FDCT is S = M @ x @ M.T on the
# level-shifted block; IDCT is x = M.T @ S @ M.
_N = 8
_M = np.zeros((8, 8), dtype=np.float64)
for _u in range(8):
    _c = np.sqrt(1.0 / 8.0) if _u == 0 else np.sqrt(2.0 / 8.0)
    for _n in range(8):
        _M[_u, _n] = _c * np.cos((2 * _n + 1) * _u * np.pi / 16.0)

# A reasonable default luminance/chrominance table pair (ITU T.81 Annex K.1
# example tables, scaled by quality elsewhere). These are spec-published
# example data, used only as encoder defaults.
DEFAULT_LUMA_Q = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.uint16,
)
DEFAULT_CHROMA_Q = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.uint16,
)


def quality_scale(table: np.ndarray, quality: int) -> np.ndarray:
    """IJG-style quality scaling of a quant table (public formula)."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    q = (table.astype(np.int64) * scale + 50) // 100
    return np.clip(q, 1, 65535).astype(np.uint16)


# --------------------------------------------------------------------------
# Optimal Huffman table construction (ITU T.81 Annex K.2, figures K.9-K.12).
# --------------------------------------------------------------------------


def gen_huffman_table(freq256: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build (counts[16], symbols) from symbol frequencies.

    Implements the spec's code-length derivation with the reserved
    pseudo-symbol 256 guaranteeing no code is all ones, followed by the
    16-bit length limiting adjustment.
    """
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = freq256
    freq[256] = 1
    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    while True:
        # v1: least nonzero frequency, largest symbol value on ties.
        nz = np.flatnonzero(freq > 0)
        if len(nz) < 2:
            break
        fvals = freq[nz]
        min1 = fvals.min()
        c1 = int(nz[fvals == min1].max())
        rest = nz[nz != c1]
        rvals = freq[rest]
        min2 = rvals.min()
        c2 = int(rest[rvals == min2].max())

        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] != -1:
            c1 = int(others[c1])
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] != -1:
            c2 = int(others[c2])
            codesize[c2] += 1

    # 1-indexed lengths.  Skewed statistics can make the tree deeper than
    # 32, so the table is sized to the deepest code before limiting.
    bits = np.zeros(max(33, int(codesize.max()) + 1), dtype=np.int64)
    for size in codesize:
        if size:
            bits[int(size)] += 1

    # Length-limit to 16 bits (Figure K.11).
    i = bits.size - 1
    while i > 16:
        if bits[i] > 0:
            # A shorter code to split: the search starts two levels up.
            j = i - 2
            while bits[j] <= 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        else:
            i -= 1
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved symbol's code

    # Sort symbols by (code size, symbol value), excluding symbol 256.
    syms: List[int] = []
    for size in range(1, int(codesize.max()) + 1):
        for v in range(256):
            if codesize[v] == size:
                syms.append(v)
    counts = bits[1:17].astype(np.uint8)
    assert int(counts.sum()) == len(syms)
    return counts, np.array(syms, dtype=np.uint8)


def _code_table(counts: np.ndarray, symbols: np.ndarray):
    """Canonical (code, length) per symbol value (spec Annex C), as two
    (256,) arrays."""
    code_of = np.zeros(256, dtype=np.int64)
    len_of = np.zeros(256, dtype=np.int64)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(int(counts[length - 1])):
            code_of[int(symbols[k])] = code
            len_of[int(symbols[k])] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _csize(v: np.ndarray) -> np.ndarray:
    """Magnitude category (number of amplitude bits) of each coefficient."""
    a = np.abs(v.astype(np.int64))
    size = np.zeros(a.shape, dtype=np.int64)
    while a.any():
        size += a > 0
        a >>= 1
    return size


def _scan_events(zz_scan, comp_of_block, seg_of_block):
    """Huffman events of an interleaved scan, in bitstream order.

    ``zz_scan`` (n_blocks, 64) zig-zag coefficients in scan order.
    Returns per event: block, is_dc, symbol, amplitude value and size --
    per block the DC diff, then per non-zero AC its ZRLs (runs of 16
    zeros) and (run, size) symbol, then EOB unless position 63 is coded.
    """
    n_blocks = zz_scan.shape[0]
    blocks = np.arange(n_blocks)
    # DC: prediction per component, reset at every restart segment.
    dc = zz_scan[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for ci in np.unique(comp_of_block):
        idx = np.flatnonzero(comp_of_block == ci)
        prev = np.concatenate([[0], dc[idx][:-1]])
        seg = seg_of_block[idx]
        prev[np.concatenate([[True], seg[1:] != seg[:-1]])] = 0
        diff[idx] = dc[idx] - prev
    # AC: non-zeros with their zero runs.
    nzb, nzi = np.nonzero(zz_scan[:, 1:])
    idx = nzi + 1
    first = np.concatenate([[True], nzb[1:] != nzb[:-1]])
    prev_idx = np.where(first, 0, np.concatenate([[0], idx[:-1]]))
    run = idx - prev_idx - 1
    n_zrl = run // 16
    val = zz_scan[nzb, idx].astype(np.int64)
    ac_size = _csize(val)
    zrl_of = np.repeat(np.arange(idx.size), n_zrl)
    zrl_j = np.arange(zrl_of.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
    last = np.zeros(n_blocks, dtype=np.int64)
    last[nzb] = idx  # nonzero order is ascending: the last write wins
    eob = np.flatnonzero(last < 63)

    dc_size = _csize(diff)
    n_zrl_total = zrl_of.size
    block = np.concatenate([blocks, nzb[zrl_of], nzb, eob])
    order_key = np.concatenate([
        np.full(n_blocks, -1), idx[zrl_of] * 16 + zrl_j, idx * 16 + 15,
        np.full(eob.size, 64 * 16),
    ])
    is_dc = np.concatenate([
        np.ones(n_blocks, bool), np.zeros(n_zrl_total + idx.size + eob.size, bool)
    ])
    sym = np.concatenate([
        dc_size, np.full(n_zrl_total, 0xF0), ((run % 16) << 4) | ac_size,
        np.zeros(eob.size, np.int64),
    ])
    value = np.concatenate([
        diff, np.zeros(n_zrl_total, np.int64), val, np.zeros(eob.size, np.int64)
    ])
    size = np.concatenate([
        dc_size, np.zeros(n_zrl_total, np.int64), ac_size,
        np.zeros(eob.size, np.int64),
    ])
    order = np.lexsort((order_key, block))
    return block[order], is_dc[order], sym[order], value[order], size[order]


def _pack_bits(values, lengths, chunk: int = 1 << 22) -> np.ndarray:
    """Concatenate (value, length) bit fields (length <= 32) MSB-first
    into bytes.  The fields are disjoint, so OR-ing them into 32-bit
    words is a sum: one bincount per chunk of fields."""
    values = values.astype(np.uint64)
    lengths = lengths.astype(np.int64)
    ends = np.cumsum(lengths)
    total = int(ends[-1]) if ends.size else 0
    n_words = total // 32 + 2
    words = np.zeros(n_words, dtype=np.float64)
    for lo in range(0, values.size, chunk):
        v = values[lo : lo + chunk]
        ln = lengths[lo : lo + chunk]
        off = ends[lo : lo + chunk] - ln
        w = off >> 5
        shift = 64 - (off & 31) - ln      # place the field in a 64-bit window
        window = v << shift.astype(np.uint64)
        hi = (window >> np.uint64(32)).astype(np.float64)
        lo_part = (window & np.uint64(0xFFFFFFFF)).astype(np.float64)
        words += np.bincount(w, weights=hi, minlength=n_words)
        words += np.bincount(w + 1, weights=lo_part, minlength=n_words)
    return words.astype(np.uint32).astype(">u4").tobytes()[: -(-total // 8)]


def _stuff(data: np.ndarray) -> np.ndarray:
    """Byte stuffing: a 0x00 after every 0xFF (spec F.1.2.3)."""
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0)


# --------------------------------------------------------------------------
# Image-domain helpers.
# --------------------------------------------------------------------------


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF RGB -> YCbCr, float64 in, uint8 out."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return np.clip(
        np.round(np.stack([y, cb, cr], axis=-1)), 0, 255
    ).astype(np.uint8)


def _downsample(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Box-average downsample a (H, W) plane to (out_h, out_w)."""
    h, w = plane.shape
    fy = ceil_div(h, out_h)
    fx = ceil_div(w, out_w)
    padded = np.pad(
        plane.astype(np.float64),
        ((0, out_h * fy - h), (0, out_w * fx - w)),
        mode="edge",
    )
    return (
        padded.reshape(out_h, fy, out_w, fx).mean(axis=(1, 3))
    )


def _to_blocks(plane: np.ndarray, vblocks: int, hblocks: int) -> np.ndarray:
    """Pad (H, W) to the MCU-aligned block grid and split into 8x8 blocks."""
    h, w = plane.shape
    padded = np.pad(
        plane,
        ((0, vblocks * 8 - h), (0, hblocks * 8 - w)),
        mode="edge",
    )
    return (
        padded.reshape(vblocks, 8, hblocks, 8).transpose(0, 2, 1, 3)
    )  # (vb, hb, 8, 8)


def fdct_quantize(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Level shift, forward DCT, quantize. blocks: (..., 8, 8) -> int32."""
    x = blocks.astype(np.float64) - 128.0
    s = np.einsum("ui,...ij,vj->...uv", _M, x, _M)
    return np.round(s / qtable.astype(np.float64)).astype(np.int32)


# --------------------------------------------------------------------------
# Encoder.
# --------------------------------------------------------------------------

SAMPLING: Dict[str, Sequence[Tuple[int, int]]] = {
    "4:4:4": [(1, 1), (1, 1), (1, 1)],
    "4:2:2": [(2, 1), (1, 1), (1, 1)],
    "4:2:0": [(2, 2), (1, 1), (1, 1)],
    "4:4:0": [(1, 2), (1, 1), (1, 1)],
    "4:1:1": [(4, 1), (1, 1), (1, 1)],
    "mono": [(1, 1)],
    # Legal but unusual: every component 2x2 (no subsampling, 12-block
    # MCUs).  All-zero decimations make it indistinguishable from 4:4:4 by
    # decimation alone -- regression fixture for sampling-factor handling.
    "4:4:4-2x2": [(2, 2), (2, 2), (2, 2)],
    # vsamp=4 corners (the parser accepts 1/2/4 on both axes like the
    # reference, xjpeg.c:386,391; no common encoder emits these).
    "h1v4": [(1, 4), (1, 1), (1, 1)],
    "h4v4": [(4, 4), (1, 1), (1, 1)],
    "h2v4": [(2, 4), (1, 1), (1, 1)],
}


@dataclasses.dataclass
class EncodeResult:
    data: bytes
    # Ground truth: per component, quantized coefficients on the MCU-aligned
    # block grid, natural (raster) order, (vblocks, hblocks, 8, 8) int32.
    coefs: List[np.ndarray]
    qtables: List[np.ndarray]  # per component, (8, 8) uint16


def encode(
    image: np.ndarray,
    subsampling: str = "4:2:0",
    quality: int = 85,
    restart_interval: int = 0,
    force_16bit_qt: bool = False,
    qtables: Optional[Sequence[np.ndarray]] = None,
    scan_order: Optional[Sequence[int]] = None,
) -> EncodeResult:
    """Encode an RGB (H, W, 3) or grayscale (H, W) uint8 image.

    ``scan_order`` permutes the SOS component order (and therefore the
    MCU interleave) -- a T.81 B.2.3 violation; libjpeg rejects such
    streams but our decoders accept and reorder.  Fixture for that
    tolerance.  Ground-truth ``coefs`` stay in frame order.
    """
    if image.ndim == 2:
        subsampling = "mono"
        planes = [image]
    else:
        assert image.ndim == 3 and image.shape[2] == 3
        if subsampling == "mono":
            planes = [rgb_to_ycbcr(image)[..., 0]]
        else:
            ycc = rgb_to_ycbcr(image)
            planes = [ycc[..., 0], ycc[..., 1], ycc[..., 2]]

    samp = SAMPLING[subsampling]
    ncomps = len(planes)
    height, width = planes[0].shape
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    nhmb = ceil_div(width, 8 * hmax)
    nvmb = ceil_div(height, 8 * vmax)

    if qtables is None:
        ql = quality_scale(DEFAULT_LUMA_Q, quality)
        qc = quality_scale(DEFAULT_CHROMA_Q, quality)
        if force_16bit_qt:
            # Push entries past 255 so DQT must use 16-bit precision.
            ql = np.clip(ql.astype(np.int64) + 300, 1, 65535).astype(np.uint16)
            qc = np.clip(qc.astype(np.int64) + 300, 1, 65535).astype(np.uint16)
        qtabs = [ql] + [qc] * (ncomps - 1)
    else:
        qtabs = [q.astype(np.uint16) for q in qtables]
        assert len(qtabs) == ncomps

    # Per-component geometry + quantized coefficients.
    comp_coefs: List[np.ndarray] = []
    for ci, plane in enumerate(planes):
        hs, vs = samp[ci]
        cw = ceil_div(width * hs, hmax)
        ch = ceil_div(height * vs, vmax)
        sub = (
            plane.astype(np.float64)
            if (cw, ch) == (width, height)
            else _downsample(plane, ch, cw)
        )
        blocks = _to_blocks(sub, nvmb * vs, nhmb * hs)
        comp_coefs.append(fdct_quantize(blocks, qtabs[ci]))

    # Zig-zag ordered views for symbol generation.
    zz = [
        c.reshape(c.shape[0], c.shape[1], 64)[:, :, ZIGZAG] for c in comp_coefs
    ]

    n_mcus = nhmb * nvmb
    interval = restart_interval or 0
    if scan_order is None:
        scan_order = tuple(range(ncomps))
    assert sorted(scan_order) == list(range(ncomps))

    # Blocks in scan order: per MCU, components in scan order, sub-blocks
    # row-major.
    per_mcu = []
    comp_in_mcu = []
    for ci in scan_order:
        hs, vs = samp[ci]
        c = zz[ci].reshape(nvmb, vs, nhmb, hs, 64).transpose(0, 2, 1, 3, 4)
        per_mcu.append(c.reshape(n_mcus, vs * hs, 64))
        comp_in_mcu += [ci] * (vs * hs)
    bpm = len(comp_in_mcu)
    zz_scan = np.concatenate(per_mcu, axis=1).reshape(n_mcus * bpm, 64)
    comp_of_block = np.tile(np.asarray(comp_in_mcu), n_mcus)
    mcu_of_block = np.repeat(np.arange(n_mcus), bpm)
    seg_of_block = mcu_of_block // interval if interval else mcu_of_block * 0
    block, is_dc, sym, value, size = _scan_events(
        zz_scan, comp_of_block, seg_of_block
    )

    # Pass 1: symbol statistics. Luma uses table id 0, chroma id 1.
    ntabs = 1 if ncomps == 1 else 2
    tab_of = np.asarray([0] + [1] * (ncomps - 1))
    tab = tab_of[comp_of_block[block]]
    dc_tables, ac_tables = [], []
    for t in range(ntabs):
        for tables, kind in ((dc_tables, is_dc), (ac_tables, ~is_dc)):
            freq = np.bincount(sym[kind & (tab == t)], minlength=256)
            tables.append(gen_huffman_table(freq))

    # Pass 2: the bitstream.  Per event (code << size) | amplitude bits;
    # every restart segment ends 1-padded to a byte, then RSTn.
    fields = np.zeros(sym.size, dtype=np.int64)
    nbits = np.zeros(sym.size, dtype=np.int64)
    for t in range(ntabs):
        for tables, kind in ((dc_tables, is_dc), (ac_tables, ~is_dc)):
            code_of, len_of = _code_table(*tables[t])
            m = kind & (tab == t)
            fields[m] = code_of[sym[m]]
            nbits[m] = len_of[sym[m]]
    amp = np.where(value >= 0, value, value + (1 << size) - 1)
    fields = (fields << size) | np.where(size > 0, amp, 0)
    nbits = nbits + size
    # 1-padding fields closing each segment to a byte boundary.
    seg_of_event = seg_of_block[block]
    n_seg = int(seg_of_block[-1]) + 1
    seg_bits = np.bincount(seg_of_event, weights=nbits, minlength=n_seg)
    pad = (-seg_bits.astype(np.int64)) % 8
    last_event = np.searchsorted(seg_of_event, np.arange(n_seg), side="right")
    fields = np.insert(fields, last_event, (1 << pad) - 1)
    nbits = np.insert(nbits, last_event, pad)
    stream = np.frombuffer(_pack_bits(fields, nbits), dtype=np.uint8)
    seg_bytes = ((seg_bits.astype(np.int64) + pad) // 8)
    seg_start = np.cumsum(seg_bytes) - seg_bytes
    # Stuff, then place RSTn (0xFF, 0xD0 + n % 8) before segments 1.. .
    ff_before = np.concatenate([[0], np.cumsum(stream == 0xFF)])
    stream = _stuff(stream)
    pos = seg_start[1:] + ff_before[seg_start[1:]]
    rst = 0xD0 + (np.arange(n_seg - 1) & 7)
    stream = np.insert(
        stream, np.repeat(pos, 2),
        np.stack([np.full(n_seg - 1, 0xFF), rst], axis=1).reshape(-1),
    )

    # ---- Assemble the file ----
    out = bytearray()

    def marker(m: int, payload: bytes = b"") -> None:
        out.append(0xFF)
        out.append(m)
        if payload or m not in (0xD8, 0xD9):
            length = len(payload) + 2
            out.extend(length.to_bytes(2, "big"))
            out.extend(payload)

    marker(0xD8)  # SOI
    # APP0 JFIF
    marker(
        0xE0,
        b"JFIF\x00" + bytes([1, 1, 0]) + (1).to_bytes(2, "big") * 2 + b"\x00\x00",
    )
    # DQT (one segment per table)
    uniq_q: List[np.ndarray] = []
    q_id: List[int] = []
    for q in qtabs:
        for i, u in enumerate(uniq_q):
            if np.array_equal(u, q):
                q_id.append(i)
                break
        else:
            q_id.append(len(uniq_q))
            uniq_q.append(q)
    for qi, q in enumerate(uniq_q):
        prec = 1 if int(q.max()) > 255 else 0
        zzq = q.reshape(64)[ZIGZAG]
        body = bytes([(prec << 4) | qi])
        body += zzq.astype(">u2").tobytes() if prec else zzq.astype(np.uint8).tobytes()
        marker(0xDB, body)
    # SOF0
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([ncomps])
    for ci in range(ncomps):
        hs, vs = samp[ci]
        sof += bytes([ci + 1, (hs << 4) | vs, q_id[ci]])
    marker(0xC0, sof)
    # DHT
    for t, (counts, symbols) in enumerate(dc_tables):
        marker(0xC4, bytes([t]) + counts.tobytes() + symbols.tobytes())
    for t, (counts, symbols) in enumerate(ac_tables):
        marker(0xC4, bytes([0x10 | t]) + counts.tobytes() + symbols.tobytes())
    # DRI
    if interval:
        marker(0xDD, interval.to_bytes(2, "big"))
    # SOS
    sos = bytes([ncomps])
    for ci in scan_order:
        t = tab_of[ci]
        sos += bytes([ci + 1, (t << 4) | t])
    sos += bytes([0, 63, 0])
    marker(0xDA, sos)
    out.extend(stream.astype(np.uint8).tobytes())
    marker(0xD9)  # EOI

    return EncodeResult(data=bytes(out), coefs=comp_coefs, qtables=qtabs)
