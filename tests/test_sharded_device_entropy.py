"""Distributed fully-on-device decode: segments over data, rows over space."""

import numpy as np
import pytest

from jaxjpeg import decode
from jaxjpeg.engine.device_entropy import decode_image_device_sharded
from jaxjpeg.host.parser import parse
from jaxjpeg.parallel.mesh import make_mesh
from jaxjpeg.testing import corpus


@pytest.mark.parametrize("space", [1, 2])
@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_device_decode_matches_host(space, upsample):
    img = corpus.synthetic_rgb(128, 128, seed=11)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=85, restart_interval=1)
    parsed = parse(enc.data)
    mesh = make_mesh(8, space=space)
    rgb = decode_image_device_sharded(parsed, mesh, upsample=upsample)
    ref = decode(enc.data, out="rgb", impl="host", upsample=upsample)
    np.testing.assert_array_equal(rgb, ref)


def test_sharded_device_decode_gray():
    img = corpus.synthetic_gray(64, 96, seed=12)
    enc = corpus.own_jpeg(img, quality=80, restart_interval=2)
    parsed = parse(enc.data)
    mesh = make_mesh(8, space=2)
    rgb = decode_image_device_sharded(parsed, mesh)
    ref = decode(enc.data, out="rgb", impl="host")
    np.testing.assert_array_equal(rgb, ref)


def test_sharded_multibatch_short_last_segment():
    """The short last segment's tail-flag suppression must work when its
    batch lands on a data shard > 0 (seg_meta batch index is global; the
    kernel sees shard-local indices -- parallel/shard.py remaps).

    3x683 = 2049 MCU blocks at restart_interval=2 -> 1025 segments in two
    kernel batches, last segment short (1 MCU); data axis 2 puts it on
    shard 1.  Before the remap this raised JpegFormatError on a valid
    image.
    """
    img = corpus.synthetic_gray(24, 5464, seed=13)
    data = corpus.pil_jpeg(img, quality=85, restart_marker_blocks=2)
    parsed = parse(data)
    assert parsed.header.n_mcus == 2049
    mesh = make_mesh(2, space=1)
    rgb = decode_image_device_sharded(parsed, mesh)
    ref = decode(data, out="rgb", impl="host")
    np.testing.assert_array_equal(rgb, ref)


@pytest.mark.parametrize("space", [1, 2])
def test_sharded_corpus_device_decode_matches_host(space):
    """decode_batch(mesh=..., entropy='device'): the full BASELINE
    config #4 shape -- distinct images (per-image optimized tables),
    entropy sharded over the chip grid, pixel rows over space."""
    from jaxjpeg.engine.batch import decode_batch

    datas = [
        corpus.pil_jpeg(
            corpus.synthetic_rgb(64, 64, seed=200 + i),
            quality=85,
            subsampling="4:2:0",
            optimize=True,
            restart_marker_blocks=1,
        )
        for i in range(6)  # not a multiple of 8 chips: exercises padding
    ]
    mesh = make_mesh(8, space=space)
    got = decode_batch(datas, mesh=mesh, entropy="device")
    want = decode_batch(datas, entropy="host")
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_corpus_device_decode_gray_general_path():
    from jaxjpeg.engine.batch import decode_batch

    datas = [
        corpus.pil_jpeg(
            corpus.synthetic_gray(48, 64, seed=300 + i),
            quality=80,
            restart_marker_blocks=1,
        )
        for i in range(4)
    ]
    mesh = make_mesh(4, space=2)
    got = decode_batch(datas, mesh=mesh, entropy="device")
    want = decode_batch(datas, entropy="host")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_device_decode_no_dri():
    """A DRI-less stream decodes distributed too: the index-scan pseudo
    segments shard over data and their DC bases are applied per shard."""
    from jaxjpeg.host import entropy_native

    if not entropy_native.available():
        pytest.skip("native library unavailable")
    img = corpus.synthetic_rgb(96, 128, seed=14)
    data = corpus.pil_jpeg(img, quality=88, subsampling="4:2:0")  # no DRI
    parsed = parse(data)
    assert parsed.header.restart_interval == 0
    mesh = make_mesh(8, space=2)
    rgb = decode_image_device_sharded(parsed, mesh)
    ref = decode(data, out="rgb", impl="host")
    np.testing.assert_array_equal(rgb, ref)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
def test_sharded_spec_decode_dri_less_matches_host(upsample):
    """DRI-less distributed decode via the replicated DEVICE index scan
    (parallel/shard.py:decode_image_device_sharded_spec): no serial host
    scan anywhere, pixels bit-identical to the host pipeline."""
    img = corpus.synthetic_rgb(128, 128, seed=14)
    data = corpus.pil_jpeg(img, quality=85, subsampling="4:2:0")
    parsed = parse(data)
    assert parsed.header.restart_interval == 0
    mesh = make_mesh(8, space=2)
    rgb = decode_image_device_sharded(parsed, mesh, upsample=upsample)
    ref = decode(data, out="rgb", impl="host", upsample=upsample)
    np.testing.assert_array_equal(rgb, ref)


def test_sharded_spec_falls_back_to_host_scan(monkeypatch):
    """Forced non-eligibility must route the DRI-less sharded decode
    through the serial-scan path with identical pixels."""
    from jaxjpeg.engine import device_entropy as de
    from jaxjpeg.errors import JpegUnsupportedError

    img = corpus.synthetic_rgb(64, 96, seed=15)
    data = corpus.pil_jpeg(img, quality=85, subsampling="4:2:0")
    parsed = parse(data)
    mesh = make_mesh(4, space=1)

    def raise_unsupported(parsed, **kw):
        raise JpegUnsupportedError("forced")

    monkeypatch.setattr(de, "build_spec_scan_input", raise_unsupported)
    rgb = decode_image_device_sharded(parsed, mesh)
    ref = decode(data, out="rgb", impl="host")
    np.testing.assert_array_equal(rgb, ref)
