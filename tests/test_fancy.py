"""Fancy (triangle) upsampling: bit-exact RGB parity vs libjpeg-turbo.

With ``upsample="fancy"`` the decoder reproduces libjpeg's default RGB
output exactly -- the strongest differential statement available, covering
entropy decode + islow IDCT + fancy upsample + integer color convert.
"""

import numpy as np
import pytest

from jaxjpeg import decode
from jaxjpeg.testing import corpus, oracle


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("impl", ["host", "device"])
def test_fancy_rgb_bit_exact_vs_pil(subsampling, impl):
    img = corpus.synthetic_rgb(67, 93, seed=5)  # odd dims on purpose
    data = corpus.pil_jpeg(img, quality=88, subsampling=subsampling)
    got = decode(data, out="rgb", impl=impl, upsample="fancy")
    golden = oracle.pil_decode_rgb(data)
    np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("mode", ["4:4:0", "4:1:1"])
@pytest.mark.parametrize("impl", ["host", "device"])
def test_fancy_rgb_bit_exact_own_encoder(mode, impl):
    """Direct libjpeg-oracle coverage of the 4:4:0 (h1v2) and 4:1:1
    (h4v1) fancy paths on BOTH impls: libjpeg has no fancy kernel for
    these ratios (jdmaster falls back to h1v2-fancy resp. replication),
    and so must we, bit for bit."""
    img = corpus.synthetic_rgb(40, 72, seed=6)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=85)
    got = decode(enc.data, out="rgb", impl=impl, upsample="fancy")
    golden = oracle.pil_decode_rgb(enc.data)
    np.testing.assert_array_equal(got, golden)


def test_fancy_device_entropy_path():
    img = corpus.synthetic_rgb(48, 48, seed=7)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=85, restart_interval=1)
    got = decode(enc.data, out="rgb", impl="device", entropy="device", upsample="fancy")
    golden = oracle.pil_decode_rgb(enc.data)
    np.testing.assert_array_equal(got, golden)


def test_fancy_batched():
    """Fancy upsampling with a leading batch dim (pipeline is batch-safe)."""
    import jax.numpy as jnp

    from jaxjpeg.engine import pipeline
    from jaxjpeg.host.entropy import decode_scan
    from jaxjpeg.host.parser import parse

    img = corpus.synthetic_rgb(32, 48, seed=8)
    data = corpus.pil_jpeg(img, quality=90, subsampling="4:2:0")
    parsed = parse(data)
    res = decode_scan(parsed)
    hdr = parsed.header
    spec = pipeline.PipelineSpec.from_header(hdr, exact=True, upsample="fancy")
    coefs = tuple(
        jnp.asarray(np.broadcast_to(c, (3,) + c.shape).copy()) for c in res.coefs
    )
    qts = tuple(
        jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
        for c in hdr.components
    )
    rgb = np.asarray(pipeline.decode_rgb(spec, coefs, qts))
    golden = oracle.pil_decode_rgb(data)
    for i in range(3):
        np.testing.assert_array_equal(rgb[i], golden)
