"""Device entropy decoder tests on CPU: the Triton kernel in interpret
mode and the plain jax.numpy version.

Differential against the host decoders across subsampling modes, restart
intervals and encoders; plus the full on-device decode path through the
public API.
"""

import numpy as np
import pytest

from jaxjpeg import decode
from jaxjpeg.host import entropy
from jaxjpeg.host.parser import parse
from jaxjpeg.engine.device_entropy import entropy_decode_device
from jaxjpeg.errors import JpegFormatError
from jaxjpeg.testing import corpus

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


def _check(enc_data, **kw):
    parsed = parse(enc_data)
    ref = entropy.decode_scan(parsed)
    res = entropy_decode_device(parsed, interpret=True, **kw)
    for a, b in zip(res.coefs, ref.coefs):
        np.testing.assert_array_equal(np.asarray(a), b.astype(np.int16))


@pytest.mark.parametrize("mode", ALL_MODES)
def test_device_entropy_matches_host(mode):
    img = corpus.synthetic_rgb(32, 48, seed=3)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=80, restart_interval=1)
    _check(enc.data)


@pytest.mark.parametrize("restart", [1, 2, 5])
def test_device_entropy_restart_intervals(restart):
    img = corpus.synthetic_gray(40, 56, seed=4)
    enc = corpus.own_jpeg(img, quality=75, restart_interval=restart)
    _check(enc.data)


def test_device_entropy_no_restart_single_segment():
    """A stream without DRI is one big segment (device still handles it)."""
    img = corpus.synthetic_gray(24, 24, seed=5)
    enc = corpus.own_jpeg(img, quality=85)
    _check(enc.data)


def test_device_entropy_pil_encoded():
    img = corpus.synthetic_rgb(48, 64, seed=6)
    data = corpus.pil_jpeg(
        img, quality=90, subsampling="4:2:0", optimize=True, restart_marker_blocks=2
    )
    _check(data)


def test_full_device_decode_rgb_via_api():
    img = corpus.synthetic_gray(48, 48, seed=7)
    data = corpus.pil_jpeg(img, quality=88, restart_marker_blocks=3)
    a = decode(data, out="rgb", impl="device", entropy="device")
    b = decode(data, out="rgb", impl="host")
    np.testing.assert_array_equal(a, b)


def test_full_device_decode_yuv_420():
    img = corpus.synthetic_rgb(32, 32, seed=8)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=80, restart_interval=1)
    a = decode(enc.data, out="yuv", impl="device", entropy="device")
    b = decode(enc.data, out="yuv", impl="host")
    for pa, pb in zip(a.planes, b.planes):
        np.testing.assert_array_equal(pa, pb)


def test_device_entropy_corrupt_stream_flags_error():
    img = corpus.synthetic_gray(32, 32, seed=9)
    enc = corpus.own_jpeg(img, quality=85, restart_interval=1)
    data = bytearray(enc.data)
    parsed = parse(bytes(data))
    s, e = parsed.segments[0]
    data[s:e] = bytes([0b10101010] * (e - s))
    parsed2 = parse(bytes(data), validate=False)
    with pytest.raises(JpegFormatError):
        entropy_decode_device(parsed2, interpret=True)


def test_unrolled_write_position_invariant():
    """AC symbol i of a block writes zig-zag position k >= i+1, k <= 63:
    k advances by run+1 >= 1 per coded symbol.  The pack expander's
    segmented cumsum of run+1 relies on it; assert it over a real scan's
    pack streams."""
    img = corpus.synthetic_rgb(64, 64, seed=12)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=95)
    parsed = parse(enc.data)
    res = entropy.decode_scan(parsed, want_pack=True)
    pack = np.asarray(res.pack, dtype=np.uint16)
    starts = [int(v) for idx in res.pack_index for v in np.asarray(idx).reshape(-1)]
    starts = sorted(starts) + [len(pack)]
    for s0, s1 in zip(starts, starts[1:]):
        k = 0
        # entries after the DC entry; 0x0000 is EOB
        for i, entry in enumerate(pack[s0 + 1 : s1]):
            if entry == 0:
                break
            run = int(entry) >> 12
            k += run + 1
            assert k >= i + 1
            assert k <= 63


def test_device_entropy_invalid_codeword_flags_error():
    """A bit window beyond the table's last canonical code must flag
    ERR_BAD_CODE (the rank sum saturates at the last symbol, so invalid
    windows need the explicit limit check, not just overrun detection)."""
    img = corpus.synthetic_gray(16, 16, seed=2)
    enc = corpus.own_jpeg(img, quality=85, restart_interval=1)
    parsed = parse(enc.data)
    data = bytearray(parsed.data)
    s0, e0 = parsed.segments[0]
    # All-ones bits (0xFF with 0x00 stuffing) exceed every codeword of the
    # (incomplete) standard tables.
    patch = (b"\xff\x00" * ((e0 - s0) // 2 + 1))[: e0 - s0]
    data[s0:e0] = patch
    corrupted = parse(bytes(data))
    with pytest.raises(JpegFormatError):
        entropy_decode_device(corrupted, interpret=True)


def test_device_entropy_salvage_zero():
    """on_error='zero' keeps the damage inside the restart boundary: the
    corrupt segment's blocks decode to zero coefficients, every other
    segment matches the clean decode exactly."""
    img = corpus.synthetic_gray(16, 48, seed=3)
    enc = corpus.own_jpeg(img, quality=85, restart_interval=1)
    parsed = parse(enc.data)
    clean = entropy_decode_device(parsed, interpret=True)
    data = bytearray(parsed.data)
    s1, e1 = parsed.segments[1]  # corrupt the SECOND segment only
    data[s1:e1] = (b"\xff\x00" * ((e1 - s1) // 2 + 1))[: e1 - s1]
    corrupted = parse(bytes(data))
    res = entropy_decode_device(corrupted, interpret=True, on_error="zero")
    got = np.asarray(res.coefs[0])
    ref = np.asarray(clean.coefs[0])
    # Grayscale MCU = one block; segment 1 is block (0, 1) of the 2x6 grid.
    assert (got[0, 1] == 0).all()
    mask = np.ones(got.shape, bool)
    mask[0, 1] = False
    np.testing.assert_array_equal(got[mask], ref[mask])


def test_salvage_keeps_valid_short_last_segment():
    """A valid image whose MCU count is not a multiple of the restart
    interval must not lose its (short) last segment to salvage zeroing --
    the kernel suppresses the padded tail's spurious flags."""
    img = corpus.synthetic_gray(40, 56, seed=5)      # 5x7 = 35 MCUs
    enc = corpus.own_jpeg(img, quality=85, restart_interval=2)  # last seg: 1 MCU
    parsed = parse(enc.data)
    clean = entropy_decode_device(parsed, interpret=True)
    salvaged = entropy_decode_device(parsed, interpret=True, on_error="zero")
    np.testing.assert_array_equal(
        np.asarray(salvaged.coefs[0]), np.asarray(clean.coefs[0])
    )


def test_corruption_in_last_segment_detected():
    """Errors in the final restart segment raise like any other (the old
    blanket exemption for the last segment hid real corruption)."""
    img = corpus.synthetic_gray(40, 56, seed=6)
    enc = corpus.own_jpeg(img, quality=85, restart_interval=2)
    parsed = parse(enc.data)
    data = bytearray(parsed.data)
    s_last, e_last = parsed.segments[-1]
    data[s_last:e_last] = (b"\xff\x00" * ((e_last - s_last) // 2 + 1))[: e_last - s_last]
    corrupted = parse(bytes(data))
    with pytest.raises(JpegFormatError):
        entropy_decode_device(corrupted, interpret=True)


@pytest.mark.parametrize("restart", [0, 1, 8])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_kernel_and_plain_match_host(mode, restart):
    """The Triton kernel (interpret mode) and the plain jax.numpy version
    decode the same coefficients as the host decoder, with restart
    markers (R=1, R=8) and without (R=0: the device index scan finds the
    MCU starts), and neither falls back to the host."""
    from jaxjpeg.engine.device_entropy import FALLBACKS

    img = corpus.synthetic_rgb(40, 56, seed=11)
    enc = corpus.own_jpeg(
        img, subsampling=mode, quality=80, restart_interval=restart
    )
    parsed = parse(enc.data)
    ref = entropy.decode_scan(parsed)
    before = sum(FALLBACKS.values())
    for interpret in (True, None):
        res = entropy_decode_device(parsed, interpret=interpret)
        for a, b in zip(res.coefs, ref.coefs):
            np.testing.assert_array_equal(np.asarray(a), b.astype(np.int16))
        if restart == 0:
            assert res.specsync_stats is not None
    assert sum(FALLBACKS.values()) == before


@pytest.mark.parametrize(
    "geom,nvmb,nhmb,mps",
    [
        (((2, 2), (1, 1), (1, 1)), 5, 7, 1),    # 4:2:0
        (((1, 1), (1, 1), (1, 1)), 9, 31, 3),   # 4:4:4, 3 MCUs/segment
        (((1, 1),), 16, 65, 1),                 # mono, 2 batches
        (((4, 1), (1, 1), (1, 1)), 3, 11, 2),   # 4:1:1
        (((1, 2), (1, 1), (1, 1)), 8, 8, 1),    # 4:4:0
    ],
)
def test_assemble_matches_block_loop(geom, nvmb, nhmb, mps):
    """MCU-major decoder output -> (vb, hb, 8, 8) planes equals placing
    every block by the scan order definition (T.81 A.2.3)."""
    from jaxjpeg.ops import entropy_device as edev

    bpm = sum(hs * vs for hs, vs in geom)
    n_mcus = nvmb * nhmb
    nseg = -(-n_mcus // mps)
    n_slots = -(-nseg // 1024) * 1024
    rng = np.random.default_rng(41)
    out = rng.integers(-1024, 1024, size=(n_slots, mps * bpm, 64), dtype=np.int16)
    got = edev.assemble_components(out, nseg, mps, n_mcus, nhmb, nvmb, geom)
    blocks = out[:nseg].reshape(nseg * mps, bpm, 64)
    for ci, (hs, vs) in enumerate(geom):
        ref = np.zeros((nvmb * vs, nhmb * hs, 8, 8), np.int16)
        off = sum(h * v for h, v in geom[:ci])
        for m in range(n_mcus):
            my, mx = divmod(m, nhmb)
            for j in range(hs * vs):
                sy, sx = divmod(j, hs)
                ref[my * vs + sy, mx * hs + sx] = blocks[m, off + j].reshape(8, 8)
        np.testing.assert_array_equal(np.asarray(got[ci]), ref)
