"""Out-of-order SOS scans and vsamp=4 sampling corners.

T.81 B.2.3 requires scan components in frame-header order, but real-world
spec-violating streams permute them and libjpeg-family decoders (the
reference's oracle path, jpeg_wrap.c) accept them by honoring scan order.
All three entropy decoders must decode the permuted MCU interleave and
emit FRAME-ordered outputs.

vsamp=4 geometries (1x4, 4x4, 2x4) are accepted by the parser like the
reference (xjpeg.c:386,391) but emitted by no common encoder.
"""

import numpy as np
import pytest

from jaxjpeg import decode
from jaxjpeg.engine.device_entropy import entropy_decode_device
from jaxjpeg.errors import JpegFormatError
from jaxjpeg.host import entropy, entropy_native
from jaxjpeg.host.parser import parse
from jaxjpeg.testing import corpus

PERMS = [(2, 0, 1), (1, 0, 2), (2, 1, 0)]


def _enc(mode, restart, order, seed=11, h=41, w=53):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    return corpus.own_jpeg(
        img, subsampling=mode, quality=82,
        restart_interval=restart, scan_order=order,
    )


@pytest.mark.parametrize("order", PERMS)
@pytest.mark.parametrize("mode,restart", [("4:4:4", 0), ("4:2:0", 2)])
def test_host_decode_out_of_order_scan(order, mode, restart):
    enc = _enc(mode, restart, order)
    parsed = parse(enc.data)
    assert tuple(parsed.header.scan.comp_idx) == order
    res = entropy.decode_scan(parsed)
    for got, want in zip(res.coefs, enc.coefs):
        np.testing.assert_array_equal(got, want.astype(np.int16))


@pytest.mark.parametrize("want_pack", [False, True])
def test_native_decode_out_of_order_scan(want_pack):
    enc = _enc("4:2:0", 3, (2, 0, 1))
    parsed = parse(enc.data)
    res = entropy_native.decode_scan(parsed, want_pack=want_pack)
    for got, want in zip(res.coefs, enc.coefs):
        np.testing.assert_array_equal(got, want.astype(np.int16))
    if want_pack:
        ref = entropy.decode_scan(parsed, want_pack=True)
        np.testing.assert_array_equal(res.pack, ref.pack)
        for a, b in zip(res.pack_index, ref.pack_index):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,restart", [("4:4:4", 2), ("4:2:0", 1)])
def test_device_decode_out_of_order_scan(mode, restart):
    enc = _enc(mode, restart, (2, 0, 1), h=32, w=48)
    parsed = parse(enc.data)
    res = entropy_decode_device(parsed, interpret=True)
    for got, want in zip(res.coefs, enc.coefs):
        np.testing.assert_array_equal(np.asarray(got), want.astype(np.int16))


def test_out_of_order_rgb_cross_impl():
    """Full RGB decode agrees between host and device impls on a permuted scan."""
    enc = _enc("4:2:0", 2, (1, 2, 0), h=40, w=48)
    a = decode(enc.data, out="rgb", impl="host")
    b = decode(enc.data, out="rgb", impl="device")
    np.testing.assert_array_equal(a, b)


def test_out_of_order_tolerance_exceeds_libjpeg():
    """Documented divergence: libjpeg REJECTS permuted SOS scans
    ("Invalid component ID ... in SOS" -- measured via the ctypes oracle);
    we accept them and reorder to frame positions.  Strictly more
    tolerant, never silently different on streams libjpeg accepts."""
    from jaxjpeg.host import oracle_native

    enc = _enc("4:4:4", 0, (2, 0, 1), h=33, w=47)
    if oracle_native.available():
        msg = oracle_native.libjpeg_probe(enc.data)
        assert msg is not None and "SOS" in msg
    got = decode(enc.data, out="rgb", impl="host")
    assert got.shape == (33, 47, 3)


def test_duplicate_scan_component_rejected():
    enc = _enc("4:4:4", 0, None)
    data = bytearray(enc.data)
    # Find the SOS marker and duplicate component 1's id over component 2.
    i = data.find(b"\xff\xda")
    assert i >= 0
    # SOS payload: len(2) ncomps(1) then (id, tables)*3.
    data[i + 5 + 2 * 2] = data[i + 5]  # comp 2 id := comp 0 id
    with pytest.raises(JpegFormatError, match="duplicate"):
        parse(bytes(data))


VSAMP4_MODES = ["h1v4", "h4v4", "h2v4"]


@pytest.mark.parametrize("mode", VSAMP4_MODES)
def test_vsamp4_host_ground_truth(mode):
    img = corpus.synthetic_rgb(40, 48, seed=13)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=80, restart_interval=2)
    parsed = parse(enc.data)
    comp0 = parsed.header.components[0]
    assert comp0.vsamp == 4
    res = entropy.decode_scan(parsed)
    for got, want in zip(res.coefs, enc.coefs):
        np.testing.assert_array_equal(got, want.astype(np.int16))


@pytest.mark.parametrize("mode", VSAMP4_MODES)
def test_vsamp4_native_matches_host(mode):
    img = corpus.synthetic_rgb(40, 48, seed=14)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=78, restart_interval=0)
    parsed = parse(enc.data)
    a = entropy_native.decode_scan(parsed)
    b = entropy.decode_scan(parsed)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", VSAMP4_MODES)
def test_vsamp4_device_matches_host(mode):
    img = corpus.synthetic_rgb(40, 48, seed=15)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=80, restart_interval=1)
    parsed = parse(enc.data)
    ref = entropy.decode_scan(parsed)
    res = entropy_decode_device(parsed, interpret=True)
    for got, want in zip(res.coefs, ref.coefs):
        np.testing.assert_array_equal(np.asarray(got), want.astype(np.int16))


@pytest.mark.parametrize("mode", ["h1v4", "h4v4"])
def test_vsamp4_rgb_cross_impl(mode):
    """Full RGB through the general pixel path: host == device."""
    img = corpus.synthetic_rgb(40, 48, seed=16)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=82, restart_interval=2)
    a = decode(enc.data, out="rgb", impl="host")
    b = decode(enc.data, out="rgb", impl="device")
    np.testing.assert_array_equal(a, b)
