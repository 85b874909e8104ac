"""DRI-less device entropy: the native index scan + pseudo-segment path.

Most real-world JPEGs carry no restart markers; round 1 decoded those on
device as ONE segment (1 of 1024 lanes active) or fell back to host.  The
index scan (xjpeg_host.cpp:xjpeg_index_scan) Huffman-walks code lengths
only to find bit offsets + DC predictors at every MCU, and the kernel
then decodes the pseudo-segments restart-parallel, bit-identical.
"""

import numpy as np
import pytest

from jaxjpeg import decode
from jaxjpeg.engine.device_entropy import entropy_decode_device
from jaxjpeg.errors import JpegFormatError
from jaxjpeg.host import entropy, entropy_native, segments
from jaxjpeg.host.parser import parse
from jaxjpeg.testing import corpus

pytestmark = pytest.mark.skipif(
    not entropy_native.available(), reason="native library unavailable"
)


def _assert_device_eq_host(data):
    parsed = parse(data)
    assert parsed.header.restart_interval == 0
    res = entropy_decode_device(parsed, interpret=True)
    ref = entropy.decode_scan(parsed)
    for a, b in zip(res.coefs, ref.coefs):
        np.testing.assert_array_equal(np.asarray(a), b.astype(np.int16))


def test_plan_auto_picks_index_scan():
    img = corpus.synthetic_gray(24, 40, seed=5)
    enc = corpus.own_jpeg(img, quality=85)
    parsed = parse(enc.data)
    plan = segments.build_plan_auto(parsed)
    assert plan.dc_base is not None
    assert plan.n_segments == parsed.header.n_mcus  # one MCU per pseudo-seg
    assert plan.mcus_per_segment == 1


def test_pinned_nw_fused_plan_identical():
    """The serving loop's pinned-nw plan (ONE fused native scan+pack pass,
    xjpeg_index_scan_pack) is byte-identical to the two-pass build, and
    an undersized pin raises instead of truncating (build_plan parity)."""
    from jaxjpeg.errors import JpegUnsupportedError

    d = corpus.pil_jpeg(
        corpus.synthetic_rgb(56, 72, seed=9), quality=92, subsampling="4:2:0"
    )
    parsed = parse(d)
    p0 = segments.build_plan_no_dri(parsed)
    p1 = segments.build_plan_auto(parsed, nw=p0.nw)
    np.testing.assert_array_equal(p0.streams, p1.streams)
    np.testing.assert_array_equal(p0.dc_base, p1.dc_base)
    assert (p0.n_segments, p0.nw) == (p1.n_segments, p1.nw)
    with pytest.raises(JpegUnsupportedError):
        segments.build_plan_no_dri(parsed, nw=2)


@pytest.mark.parametrize("mode,q", [("4:2:0", 95), ("4:4:4", 60), ("4:1:1", 85)])
def test_no_dri_device_matches_host_own_encoder(mode, q):
    """q=95 noise produces 0xFF stuffing: exercises destuffed-bit offsets."""
    img = corpus.synthetic_rgb(40, 48, seed=6)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=q)
    _assert_device_eq_host(enc.data)


def test_no_dri_device_matches_host_foreign_stream():
    d = corpus.pil_jpeg(
        corpus.synthetic_rgb(48, 64, seed=7), quality=90, subsampling="4:2:2"
    )
    _assert_device_eq_host(d)


def test_no_dri_full_rgb_via_api():
    img = corpus.synthetic_gray(48, 48, seed=8)
    data = corpus.pil_jpeg(img, quality=88)  # no restart markers
    a = decode(data, out="rgb", impl="device", entropy="device")
    b = decode(data, out="rgb", impl="host")
    np.testing.assert_array_equal(a, b)


def test_no_dri_out_of_order_scan():
    enc = corpus.own_jpeg(
        corpus.synthetic_rgb(32, 40, seed=9),
        subsampling="4:2:0", quality=82, scan_order=(2, 0, 1),
    )
    _assert_device_eq_host(enc.data)


def test_no_dri_corrupt_stream_raises_at_scan():
    """The index scan validates while walking: corruption in a DRI-less
    stream fails host-side (there is no restart boundary to salvage)."""
    img = corpus.synthetic_gray(32, 32, seed=10)
    enc = corpus.own_jpeg(img, quality=85)
    parsed = parse(enc.data)
    s, e = parsed.segments[0]
    data = bytearray(enc.data)
    data[s + (e - s) // 2] ^= 0xFF
    # Either the scan flags an invalid code, or (rarely) the flip decodes
    # as valid symbols and the total MCU walk still succeeds -- in that
    # case the device output must still equal host output on the same
    # corrupted stream.
    try:
        _assert_device_eq_host(bytes(data))
    except JpegFormatError:
        pass


def test_index_scan_dc_bases_match_host_prediction():
    img = corpus.synthetic_rgb(24, 32, seed=11)
    enc = corpus.own_jpeg(img, subsampling="4:4:4", quality=85)
    parsed = parse(enc.data)
    bitpos, dc_base, end_bit = entropy_native.index_scan(parsed, 3)
    ref = entropy.decode_scan(parsed)
    # DC predictor entering pseudo-segment j equals the (j*3-1)-th MCU's
    # last decoded DC value per component (cumulative sums match decode).
    assert bitpos[0] == 0 and (dc_base[0] == 0).all()
    assert (np.diff(bitpos) > 0).all()
    assert end_bit > bitpos[-1]
    nhmb = parsed.header.nhmb
    for j in range(1, len(bitpos)):
        last_mcu = j * 3 - 1
        mby, mbx = divmod(last_mcu, nhmb)
        for ci in range(3):
            want = ref.coefs[ci][mby, mbx, 0, 0]
            assert dc_base[j, ci] == want, (j, ci)
