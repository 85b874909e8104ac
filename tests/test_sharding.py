"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jaxjpeg import decode
from jaxjpeg.engine.pipeline import PipelineSpec
from jaxjpeg.host.entropy import decode_scan
from jaxjpeg.host.parser import parse
from jaxjpeg.parallel.mesh import make_mesh
from jaxjpeg.parallel.shard import decode_batch_sharded
from jaxjpeg.testing import corpus


def _batched_inputs(mode, h, w, batch, seed=0):
    img = corpus.synthetic_rgb(h, w, seed=seed)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=85)
    parsed = parse(enc.data)
    result = decode_scan(parsed)
    hdr = parsed.header
    coefs = tuple(
        jnp.asarray(np.broadcast_to(c, (batch,) + c.shape).copy())
        for c in result.coefs
    )
    qts = tuple(
        jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
        for c in hdr.components
    )
    return enc, hdr, coefs, qts


def test_eight_devices_available():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("space", [1, 2, 4])
def test_sharded_decode_matches_single_device(space):
    enc, hdr, coefs, qts = _batched_inputs("4:2:0", 128, 128, batch=8 // space)
    spec = PipelineSpec.from_header(hdr, exact=True)
    mesh = make_mesh(8, space=space)
    rgb, checksum = decode_batch_sharded(spec, mesh, coefs, qts)
    ref = decode(enc.data, out="rgb", impl="device")
    got = np.asarray(rgb)
    for i in range(got.shape[0]):
        np.testing.assert_array_equal(
            got[i][: hdr.height, : hdr.width], ref
        )
    assert int(checksum) == int(got.astype(np.uint64).sum())


def test_sharded_mono():
    enc, hdr, coefs, qts = _batched_inputs("mono", 64, 64, batch=4)
    spec = PipelineSpec.from_header(hdr, exact=True)
    mesh = make_mesh(8, space=2)
    rgb, _ = decode_batch_sharded(spec, mesh, coefs, qts)
    ref = decode(enc.data, out="rgb", impl="host")
    np.testing.assert_array_equal(
        np.asarray(rgb)[0][: hdr.height, : hdr.width], ref
    )


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2", "4:4:0"])
def test_sharded_fancy_halo_matches_single_device(space, mode):
    """Fancy upsampling across shards: the 1-row ppermute halo exchange
    must reproduce the unsharded filter bit-for-bit (incl. odd heights)."""
    h, w = 125, 67  # odd dims: true-size clamps cross the padding
    img = corpus.synthetic_rgb(h, w, seed=21)
    enc = corpus.own_jpeg(img, subsampling=mode, quality=85)
    parsed = parse(enc.data)
    hdr = parsed.header
    # The luma block rows must divide the space axis.
    if hdr.components[0].vblocks % space:
        pytest.skip("geometry does not divide this space axis")
    result = decode_scan(parsed)
    coefs = tuple(
        jnp.asarray(np.broadcast_to(c, (8 // space,) + c.shape).copy())
        for c in result.coefs
    )
    qts = tuple(
        jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
        for c in hdr.components
    )
    spec = PipelineSpec.from_header(hdr, exact=True, upsample="fancy")
    mesh = make_mesh(8, space=space)
    rgb, _ = decode_batch_sharded(spec, mesh, coefs, qts)
    ref = decode(enc.data, out="rgb", impl="device", upsample="fancy")
    got = np.asarray(rgb)[0][:h, :w]
    np.testing.assert_array_equal(got, ref)


def test_graft_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (2, 256, 256, 3)
    assert out.dtype == jnp.uint8


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
    ge.dryrun_multichip(4)
    ge.dryrun_multichip(1)
