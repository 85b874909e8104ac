"""End-to-end decoder backend tests: host + device pipeline vs oracles.

The dual-backend differential strategy of the reference (--impl libjpeg vs
--impl xjpeg behind one vtbl, jpeg_gpu.c:546-557) applied three ways:
PIL oracle vs HostDecoder vs DeviceDecoder, across every stage cut.
"""

import numpy as np
import pytest

from jaxjpeg import OutputStage, decode, get_decoder
from jaxjpeg.testing import corpus, oracle

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


def test_gray_rgb_bit_exact_vs_pil():
    img = corpus.synthetic_gray(64, 48, seed=1)
    data = corpus.pil_jpeg(img, quality=88)
    got_host = decode(data, out="rgb", impl="host")
    got_dev = decode(data, out="rgb", impl="device")
    golden = decode(data, out="rgb", impl="pil")
    np.testing.assert_array_equal(got_host, golden)
    np.testing.assert_array_equal(got_dev, golden)


def test_yuv_stage_bit_exact_vs_pil_444():
    img = corpus.synthetic_rgb(40, 56, seed=2)
    data = corpus.pil_jpeg(img, quality=90, subsampling="4:4:4")
    golden = oracle.pil_decode_ycbcr(data)
    for impl in ("host", "device"):
        out = decode(data, out="yuv", impl=impl)
        for ci in range(3):
            np.testing.assert_array_equal(out.planes[ci], golden[..., ci])


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2"])
def test_rgb_subsampled_psnr_vs_pil(subsampling):
    """Subsampled RGB: nearest vs fancy upsampling -> PSNR-bounded only."""
    img = corpus.synthetic_rgb(72, 96, seed=3)
    data = corpus.pil_jpeg(img, quality=90, subsampling=subsampling)
    golden = decode(data, out="rgb", impl="pil")
    for impl in ("host", "device"):
        got = decode(data, out="rgb", impl=impl)
        assert got.shape == golden.shape
        assert oracle.psnr(got, golden) > 30.0, impl


def test_host_and_device_rgb_identical():
    """Host (numpy) and device (jnp) exact paths must agree bit for bit."""
    for mode in ALL_MODES:
        img = corpus.synthetic_rgb(33, 41, seed=4)
        enc = corpus.own_jpeg(img, subsampling=mode, quality=75)
        host = decode(enc.data, out="rgb", impl="host")
        dev = decode(enc.data, out="rgb", impl="device")
        np.testing.assert_array_equal(host, dev, err_msg=mode)


@pytest.mark.parametrize("stage", ["quant", "dct"])
def test_coef_stages_match(stage):
    img = corpus.synthetic_rgb(32, 32, seed=5)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=80)
    host = decode(enc.data, out=stage, impl="host")
    dev = decode(enc.data, out=stage, impl="device")
    for a, b in zip(host.coefs, dev.coefs):
        np.testing.assert_array_equal(a, b)


def test_pack_stage_available():
    img = corpus.synthetic_gray(24, 24, seed=6)
    enc = corpus.own_jpeg(img, quality=80)
    out = decode(enc.data, out="pack", impl="device")
    assert out.pack is not None and len(out.pack) > 0
    assert out.index[0].shape == (3, 3)


def test_decoder_reuse_and_reset():
    img = corpus.synthetic_gray(16, 16, seed=7)
    data = corpus.pil_jpeg(img, quality=85)
    dec = get_decoder(data, impl="device")
    hdr = dec.decode_header()
    assert (hdr.width, hdr.height) == (16, 16)
    a = dec.decode("rgb")
    dec.reset()
    b = dec.decode("rgb")
    np.testing.assert_array_equal(a, b)


def test_fast_path_close_to_exact():
    img = corpus.synthetic_rgb(48, 48, seed=8)
    data = corpus.pil_jpeg(img, quality=90, subsampling="4:2:0")
    exact = decode(data, out="rgb", impl="device", exact=True)
    fast = decode(data, out="rgb", impl="device", exact=False)
    assert oracle.psnr(exact, fast) > 45.0
    # float IDCT (+-1) and float color (+-1) roundings can compound.
    assert np.abs(exact.astype(int) - fast.astype(int)).max() <= 4


def test_unsupported_inputs_raise():
    from jaxjpeg.errors import JpegFormatError, JpegUnsupportedError

    with pytest.raises(JpegFormatError):
        decode(b"\x00\x01\x02", impl="host")
    # Progressive JPEG must be rejected cleanly.
    import io
    from PIL import Image

    img = corpus.synthetic_rgb(32, 32, seed=9)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", progressive=True)
    with pytest.raises(JpegUnsupportedError):
        decode(buf.getvalue(), impl="host")


@pytest.mark.parametrize("hw", [(1, 1), (17, 31), (9, 200), (8, 8)])
def test_edge_sizes_device_vs_host(hw):
    """Odd and tiny dimensions decode identically through both engines
    (partial MCUs on both axes, single-sample images)."""
    h, w = hw
    enc = corpus.own_jpeg(
        corpus.synthetic_rgb(h, w, seed=1), subsampling="4:2:0", quality=85
    )
    a = decode(enc.data, impl="device")
    b = decode(enc.data, impl="host")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (h, w, 3)


def test_16bit_quant_tables_device_vs_host():
    enc = corpus.own_jpeg(
        corpus.synthetic_rgb(40, 56, seed=2), subsampling="4:2:0",
        quality=6, force_16bit_qt=True, restart_interval=2,
    )
    a = decode(enc.data, impl="device")
    b = decode(enc.data, impl="host")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [1, 100])
def test_extreme_quality_device_vs_host(q):
    enc = corpus.own_jpeg(
        corpus.synthetic_rgb(32, 48, seed=3), subsampling="4:2:2",
        quality=q, restart_interval=1,
    )
    a = decode(enc.data, impl="device")
    b = decode(enc.data, impl="host")
    np.testing.assert_array_equal(a, b)


def test_all_2x2_sampling_factors():
    """A legal frame with 2x2 sampling on every component has all-zero
    decimations (indistinguishable from 4:4:4 by decimation alone); the
    device must decode it from its sampling factors, like the host."""
    enc = corpus.own_jpeg(
        corpus.synthetic_rgb(40, 56, seed=4), subsampling="4:4:4-2x2",
        quality=85, restart_interval=1,
    )
    a = decode(enc.data, impl="device")
    b = decode(enc.data, impl="host")
    np.testing.assert_array_equal(a, b)
    c = decode(enc.data, impl="device", entropy="device")
    np.testing.assert_array_equal(c, b)


def _patch_first(data: bytes, marker: int, offset: int, old: int, new: int) -> bytes:
    """Patch one byte at `offset` past the first marker's length field."""
    i = data.index(bytes([0xFF, marker]))
    pos = i + 4 + offset  # skip FF xx + 2-byte length
    assert data[pos] == old, (hex(data[pos]), hex(old))
    return data[:pos] + bytes([new]) + data[pos + 1 :]


def test_scan_huffman_slot_out_of_range_rejected():
    """Td/Ta > 3 is structural corruption (indexes 4-slot tables and the
    device kernel's (8, ...) tensors): rejected even with validate off."""
    import pytest

    from jaxjpeg.errors import JpegFormatError
    from jaxjpeg.host.parser import parse

    img = corpus.synthetic_gray(16, 16, seed=3)
    data = corpus.pil_jpeg(img, quality=85)
    # SOS payload: ns, then (cs, tda) pairs; patch component 0's tda.
    bad = _patch_first(data, 0xDA, 2, 0x00, 0x44)
    with pytest.raises(JpegFormatError):
        parse(bad, validate=False)


def test_scan_component_order_permutation_accepted():
    """T.81 B.2.3 violation: permuted SOS order is ACCEPTED (and
    reordered to frame positions) -- see tests/test_scan_order.py for
    the full differential coverage.  Note the entropy stream here was
    encoded in frame order, so the permuted header misdescribes the
    interleave for same-sampling components; the parse itself must
    succeed and record the scan order."""
    from jaxjpeg.host.parser import parse

    img = corpus.synthetic_rgb(16, 16, seed=3)
    data = corpus.pil_jpeg(img, quality=85, subsampling="4:4:4")
    i = data.index(bytes([0xFF, 0xDA]))
    pos = i + 5  # ns byte consumed; component entries start here
    ns = data[i + 4]
    assert ns == 3
    entries = [data[pos + 2 * k : pos + 2 * k + 2] for k in range(3)]
    swapped = entries[1] + entries[0] + entries[2]
    permuted = data[:pos] + swapped + data[pos + 6 :]
    parsed = parse(permuted)
    assert tuple(parsed.header.scan.comp_idx) == (1, 0, 2)


def test_gray_with_sampling_factors_decodes_non_interleaved():
    """A 1-component frame's declared sampling factors do not change the
    (non-interleaved) data ordering -- T.81 A.2 / libjpeg jdinput.c.
    Patching a grayscale SOF from 1x1 to 2x2 factors must decode to the
    same pixels."""
    img = corpus.synthetic_gray(40, 24, seed=9)
    data = corpus.pil_jpeg(img, quality=85, restart_marker_blocks=2)
    ref = decode(data, out="rgb", impl="host")
    # SOF0 payload: bits, h(2), w(2), ncomps, then (cid, hv, tq).
    bad = _patch_first(data, 0xC0, 7, 0x11, 0x22)
    got = decode(bad, out="rgb", impl="host")
    np.testing.assert_array_equal(got, ref)
    got_py = decode(bad, out="rgb", impl="host", entropy="python")
    np.testing.assert_array_equal(got_py, ref)


def test_io_bytes_accounting():
    """Bytes-shipped per stage cut (the reference's img.packed variable):
    pack upload < coef upload for sparse content; device-entropy ships
    the destuffed words; host/pil impls ship nothing."""
    from jaxjpeg.engine.decoder import get_decoder

    img = corpus.synthetic_gray(64, 64, seed=21)
    enc = corpus.own_jpeg(img, quality=50, restart_interval=1)

    dec = get_decoder(enc.data, impl="device")
    io_coefs = dec.io_bytes("rgb")
    assert io_coefs["payload"] == "host"
    vb = hb = 8
    assert io_coefs["upload"] == vb * hb * 64 * 2
    assert io_coefs["download"] == 64 * 64 * 3
    assert dec.io_bytes("quant")["download"] == io_coefs["upload"]
    assert dec.io_bytes("dct")["download"] == 2 * io_coefs["upload"]

    dec_pack = get_decoder(enc.data, impl="device", upload="pack")
    io_pack = dec_pack.io_bytes("rgb")
    assert io_pack["payload"] == "pack"
    assert 0 < io_pack["upload"] < io_coefs["upload"]

    dec_dev = get_decoder(enc.data, impl="device", entropy="device")
    io_dev = dec_dev.io_bytes("rgb")
    assert io_dev["payload"] == "bits"
    assert io_dev["upload"] > 0

    assert get_decoder(enc.data, impl="host").io_bytes("rgb")["upload"] == 0
    assert get_decoder(enc.data, impl="pil").io_bytes("rgb")["upload"] == 0


def test_io_bytes_device_no_dri():
    """entropy="device" io_bytes sizes the plan decode() actually ships:
    a DRI-less stream routes through build_plan_auto -> build_plan_no_dri
    (index-scan pseudo segments), so the reported upload must be that
    plan's streams plus the per-pseudo-segment DC bases -- not the
    single-mega-segment plan build_plan would size."""
    from jaxjpeg.engine.decoder import get_decoder
    from jaxjpeg.host import entropy_native
    from jaxjpeg.host.parser import parse
    from jaxjpeg.host.segments import build_plan_auto

    if not entropy_native.available():
        pytest.skip("native index scan unavailable")
    img = corpus.synthetic_gray(64, 64, seed=22)
    data = corpus.pil_jpeg(img, quality=85)  # no restart markers
    plan = build_plan_auto(parse(data))
    assert plan.dc_base is not None  # really the pseudo-segment path
    io = get_decoder(data, impl="device", entropy="device").io_bytes("rgb")
    assert io["payload"] == "bits"
    assert io["upload"] == plan.streams.nbytes + plan.dc_base.nbytes
