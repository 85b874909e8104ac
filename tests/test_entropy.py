"""Entropy decode differential tests: our host decoder vs ground truth.

The QUANT-stage cut is compared against (a) the exact coefficients our own
encoder wrote and (b) float-IDCT reconstructions vs Pillow/libjpeg-turbo
pixels (PSNR-bounded), mirroring the reference's dual-backend strategy
(SURVEY.md section 4).
"""

import numpy as np
import pytest

from jaxjpeg.host.entropy import decode_scan, destuff
from jaxjpeg.host.parser import parse
from jaxjpeg.info import Subsampling
from jaxjpeg.testing import corpus, oracle

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


def test_destuff():
    assert destuff(b"\x12\xff\x00\x34") == b"\x12\xff\x34"
    assert destuff(b"\xff\x00\xff\x00") == b"\xff\xff"
    assert destuff(b"abc") == b"abc"
    assert destuff(b"") == b""


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("restart", [0, 7])
def test_decode_matches_encoder_ground_truth(mode, restart):
    img = corpus.synthetic_rgb(41, 67, seed=3)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=80, restart_interval=restart)
    parsed = parse(enc.data)
    result = decode_scan(parsed)
    assert len(result.coefs) == len(enc.coefs)
    for got, want in zip(result.coefs, enc.coefs):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want.astype(np.int16))


@pytest.mark.parametrize("restart", [0, 3])
def test_16bit_quant_tables(restart):
    img = corpus.synthetic_gray(33, 50, seed=5)
    enc = corpus.own_jpeg(img, quality=10, restart_interval=restart, force_16bit_qt=True)
    parsed = parse(enc.data)
    assert parsed.header.quant_tables[0].precision == 1
    result = decode_scan(parsed)
    np.testing.assert_array_equal(result.coefs[0], enc.coefs[0].astype(np.int16))


def _islow_plane(parsed, result, ci):
    from jaxjpeg.ops import idct_islow

    comp = parsed.header.components[ci]
    q = parsed.header.quant_for(comp).values
    pix = idct_islow.dequant_idct_islow_pixels(result.coefs[ci], q, xp=np)
    by, bx = pix.shape[:2]
    plane = pix.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
    return plane[: comp.height, : comp.width]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_decode_pil_encoded_bit_exact_luma(optimize, subsampling):
    """Our entropy decode + islow IDCT is bit-exact vs libjpeg-turbo (luma)."""
    img = corpus.synthetic_rgb(64, 80, seed=7)
    data = corpus.pil_jpeg(img, quality=90, subsampling=subsampling, optimize=optimize)
    parsed = parse(data)
    result = decode_scan(parsed)
    golden = oracle.pil_decode_ycbcr(data)[..., 0]
    np.testing.assert_array_equal(_islow_plane(parsed, result, 0), golden)


def test_decode_pil_444_bit_exact_all_planes():
    """4:4:4 has no upsampling: every YCbCr plane must be bit-exact."""
    img = corpus.synthetic_rgb(48, 56, seed=9)
    data = corpus.pil_jpeg(img, quality=92, subsampling="4:4:4")
    parsed = parse(data)
    result = decode_scan(parsed)
    golden = oracle.pil_decode_ycbcr(data)
    for ci in range(3):
        np.testing.assert_array_equal(
            _islow_plane(parsed, result, ci), golden[..., ci]
        )


def test_decode_pil_gray_with_restarts_bit_exact():
    img = corpus.synthetic_gray(56, 72, seed=11)
    data = corpus.pil_jpeg(img, quality=85, restart_marker_blocks=4)
    parsed = parse(data)
    assert parsed.header.restart_interval == 4
    assert len(parsed.segments) > 1
    result = decode_scan(parsed)
    golden = oracle.pil_decode_gray(data)
    np.testing.assert_array_equal(_islow_plane(parsed, result, 0), golden)


def test_float_idct_close_to_islow():
    """The float fast path stays within 1 LSB of islow on real data."""
    img = corpus.synthetic_gray(40, 40, seed=13)
    data = corpus.pil_jpeg(img, quality=85)
    parsed = parse(data)
    result = decode_scan(parsed)
    comp = parsed.header.components[0]
    q = parsed.header.quant_for(comp).values
    ref = oracle.reference_idct_pixels(result.coefs[0], q)
    got = _islow_plane(parsed, result, 0)
    by, bx = ref.shape[:2]
    refp = ref.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[
        : comp.height, : comp.width
    ]
    assert np.abs(refp.astype(np.int32) - got.astype(np.int32)).max() <= 1


def test_pack_stream_format():
    """PACK stage: reference stream format (xjpeg.c:484-535 semantics)."""
    img = corpus.synthetic_gray(24, 24, seed=2)
    enc = corpus.own_jpeg(img, quality=70)
    parsed = parse(enc.data)
    result = decode_scan(parsed, want_pack=True)
    assert result.pack is not None
    idx = result.pack_index[0]
    coefs = result.coefs[0]
    # Walk the stream per block and reconstruct; must equal the dense coefs.
    from jaxjpeg.ops.zigzag import ZIGZAG

    vb, hb = idx.shape
    for by in range(vb):
        for bx in range(hb):
            p = int(idx[by, bx])
            zz = np.zeros(64, dtype=np.int32)
            dc = int(result.pack[p])
            dc = dc - 0x1000 if dc & 0x800 else dc  # 12-bit two's complement
            zz[0] = dc
            p += 1
            k = 0
            while k < 63:
                entry = int(result.pack[p])
                p += 1
                if entry == 0:
                    break
                run = entry >> 12
                val = entry & 0xFFF
                val = val - 0x1000 if val & 0x800 else val
                k += run + 1
                zz[k] = val
            nat = np.zeros(64, dtype=np.int32)
            nat[ZIGZAG] = zz
            np.testing.assert_array_equal(
                nat.reshape(8, 8), coefs[by, bx].astype(np.int32)
            )


def test_header_parse_subsampling():
    for mode, expect in [
        ("4:4:4", Subsampling.S444),
        ("4:2:2", Subsampling.S422),
        ("4:2:0", Subsampling.S420),
        ("4:4:0", Subsampling.S440),
        ("4:1:1", Subsampling.S411),
    ]:
        img = corpus.synthetic_rgb(32, 32, seed=1)
        enc = corpus.own_jpeg(img, subsampling=mode)
        hdr = parse(enc.data, headers_only=True).header
        assert hdr.subsampling == expect, mode
    gray = corpus.own_jpeg(corpus.synthetic_gray(16, 16))
    assert parse(gray.data).header.subsampling == Subsampling.MONO
