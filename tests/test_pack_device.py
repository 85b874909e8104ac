"""PACK-mode device expander tests."""

import numpy as np
import pytest

from jaxjpeg import decode
from jaxjpeg.host.entropy import decode_scan
from jaxjpeg.host.pack_plan import build_pack_plan
from jaxjpeg.host.parser import parse
from jaxjpeg.engine.device_entropy import expand_pack_device
from jaxjpeg.testing import corpus

ALL_MODES = ["mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]


@pytest.mark.parametrize("mode", ALL_MODES)
def test_pack_expand_matches_host(mode):
    img = corpus.synthetic_rgb(32, 48, seed=4)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=80)
    parsed = parse(enc.data)
    scan = decode_scan(parsed, want_pack=True)
    coefs = expand_pack_device(parsed, scan)
    for a, b in zip(coefs, scan.coefs):
        np.testing.assert_array_equal(np.asarray(a), b.astype(np.int16))


def test_pack_expand_no_restarts_large_blocks():
    """Pack path needs no restart markers (host did the Huffman work)."""
    img = corpus.synthetic_gray(64, 80, seed=5)
    data = corpus.pil_jpeg(img, quality=90)
    parsed = parse(data)
    scan = decode_scan(parsed, want_pack=True)
    coefs = expand_pack_device(parsed, scan)
    np.testing.assert_array_equal(
        np.asarray(coefs[0]), scan.coefs[0].astype(np.int16)
    )


def test_pack_upload_rgb_via_api():
    img = corpus.synthetic_rgb(40, 40, seed=6)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=85)
    a = decode(enc.data, out="rgb", impl="device", upload="pack")
    b = decode(enc.data, out="rgb", impl="host")
    np.testing.assert_array_equal(a, b)


def test_pack_plan_upload_size():
    """Pack upload carries ~2 bytes/symbol, far less than dense coefs."""
    img = corpus.synthetic_gray(64, 64, seed=7)
    data = corpus.pil_jpeg(img, quality=85)
    parsed = parse(data)
    scan = decode_scan(parsed, want_pack=True)
    plan = build_pack_plan(parsed, scan)
    dense_bytes = sum(c.size * 2 for c in scan.coefs)
    n_coefs = sum(c.size for c in scan.coefs)
    assert plan.packed_entries * 2 < dense_bytes
    assert plan.packed_entries < n_coefs  # only non-zero symbols travel
