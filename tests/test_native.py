"""Native (C++) entropy decoder: differential vs the Python reference."""

import numpy as np
import pytest

from jaxjpeg.host import entropy, entropy_native
from jaxjpeg.host.parser import parse
from jaxjpeg.testing import corpus

pytestmark = pytest.mark.skipif(
    not entropy_native.available(), reason="native decoder not built"
)

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("restart", [0, 3])
def test_native_matches_python(mode, restart):
    img = corpus.synthetic_rgb(41, 67, seed=3)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=80, restart_interval=restart)
    parsed = parse(enc.data)
    py = entropy.decode_scan(parsed)
    nat = entropy_native.decode_scan(parsed)
    for a, b in zip(py.coefs, nat.coefs):
        np.testing.assert_array_equal(a, b)


def test_native_16bit_qt_and_threads():
    img = corpus.synthetic_gray(64, 96, seed=5)
    enc = corpus.own_jpeg(img, quality=10, restart_interval=2, force_16bit_qt=True)
    parsed = parse(enc.data)
    py = entropy.decode_scan(parsed)
    for nt in (1, 4):
        nat = entropy_native.decode_scan(parsed, n_threads=nt)
        np.testing.assert_array_equal(py.coefs[0], nat.coefs[0])


def test_native_pil_encoded_optimized():
    img = corpus.synthetic_rgb(80, 64, seed=8)
    data = corpus.pil_jpeg(img, quality=92, subsampling="4:2:0", optimize=True,
                           restart_marker_blocks=2)
    parsed = parse(data)
    py = entropy.decode_scan(parsed)
    nat = entropy_native.decode_scan(parsed)
    for a, b in zip(py.coefs, nat.coefs):
        np.testing.assert_array_equal(a, b)


def test_engine_uses_native_by_default():
    from jaxjpeg import decode

    img = corpus.synthetic_gray(32, 32, seed=1)
    data = corpus.pil_jpeg(img, quality=85)
    a = decode(data, out="rgb", impl="device", entropy="native")
    b = decode(data, out="rgb", impl="device", entropy="python")
    np.testing.assert_array_equal(a, b)


def test_native_rejects_corrupt_stream():
    from jaxjpeg.errors import JpegFormatError

    img = corpus.synthetic_gray(32, 32, seed=1)
    enc = corpus.own_jpeg(img, quality=85)
    data = bytearray(enc.data)
    parsed = parse(bytes(data))
    # Corrupt entropy data badly enough and decode must fail cleanly
    # (invalid code) or succeed with garbage -- never crash.
    s, e = parsed.segments[0]
    data[s : e] = bytes([0b10101010] * (e - s))
    try:
        entropy_native.decode_scan(parse(bytes(data), validate=False))
    except JpegFormatError:
        pass


def test_native_pack_streams_matches_numpy():
    """The C++ destuff+pack and the numpy fallback build identical streams."""
    from unittest import mock

    from jaxjpeg.host import entropy_native, segments
    from jaxjpeg.host.parser import parse

    if not entropy_native.available():
        pytest.skip("native library unavailable")
    img = corpus.synthetic_rgb(96, 128, seed=9)
    data = corpus.pil_jpeg(
        img, quality=90, subsampling="4:2:0", restart_marker_blocks=1
    )
    parsed = parse(data)
    plan_native = segments.build_plan(parsed)
    with mock.patch.object(entropy_native, "available", return_value=False):
        plan_numpy = segments.build_plan(parsed)
    np.testing.assert_array_equal(plan_native.streams, plan_numpy.streams)
    assert plan_native.nw == plan_numpy.nw


def test_native_pack_stream_matches_python():
    """Native (run,value) pack emission is byte-identical to the python
    reference, including per-block index arrays."""
    from jaxjpeg.host import entropy, entropy_native
    from jaxjpeg.host.parser import parse

    if not entropy_native.available():
        pytest.skip("native library unavailable")
    for mode, kw in [("4:2:0", dict(restart_marker_blocks=2)), ("4:4:4", {})]:
        img = corpus.synthetic_rgb(64, 96, seed=13)
        data = corpus.pil_jpeg(img, quality=88, subsampling=mode, **kw)
        parsed = parse(data)
        ref = entropy.decode_scan(parsed, want_pack=True)
        got = entropy_native.decode_scan(parsed, want_pack=True)
        np.testing.assert_array_equal(got.pack, ref.pack)
        for a, b in zip(got.pack_index, ref.pack_index):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.coefs, ref.coefs):
            np.testing.assert_array_equal(a, b)


def test_build_plan_pinned_nw():
    """The serving loop's pinned-nw fast path: one-pass pack, identical
    plan, clean rejection when a segment would truncate."""
    from unittest import mock

    from jaxjpeg.errors import JpegUnsupportedError
    from jaxjpeg.host import segments
    from jaxjpeg.host.parser import parse

    img = corpus.synthetic_rgb(80, 120, seed=11)
    data = corpus.pil_jpeg(
        img, quality=90, subsampling="4:2:0", restart_marker_blocks=2
    )
    parsed = parse(data)
    ref = segments.build_plan(parsed)
    for native in (True, False):
        with mock.patch.object(
            entropy_native, "available", return_value=native
        ):
            pinned = segments.build_plan(parsed, nw=ref.nw)
            np.testing.assert_array_equal(pinned.streams, ref.streams)
            assert pinned.nw == ref.nw
            # Wider pin: valid, 0xFF-padded wider rows.
            wide = segments.build_plan(parsed, nw=ref.nw + 3)
            assert wide.nw == ref.nw + 3
            with pytest.raises(JpegUnsupportedError):
                segments.build_plan(parsed, nw=max(1, ref.nw - 3))
