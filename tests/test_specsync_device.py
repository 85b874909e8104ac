"""Device parallel index scan (ops/specsync_device.py) on CPU: the Triton
kernel in interpret mode and the plain jax.numpy version.

The DRI-less serving path's parallel boundary finder must be bit-exact
against the serial native scan (the prototype's contract,
host/specsync.py) and fall back to it transparently when it cannot
converge.  The compiled kernel is checked on the GPU by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from jaxjpeg.engine import device_entropy
from jaxjpeg.engine.device_entropy import entropy_decode_device
from jaxjpeg.errors import JpegUnsupportedError
from jaxjpeg.host import entropy_native
from jaxjpeg.host import segments as seg_mod
from jaxjpeg.host.parser import parse
from jaxjpeg.ops import specsync_device as sd
from jaxjpeg.testing import corpus


def _scan_args(inp):
    return (
        jnp.asarray(inp.windows),
        jnp.asarray(np.array([inp.n_bits], np.int32)),
        jnp.asarray(inp.dcslot_of_c),
        jnp.asarray(inp.acslot_of_c),
        jnp.asarray(inp.cbase),
        jnp.asarray(inp.counts),
        jnp.asarray(inp.symbols),
    )


@pytest.mark.parametrize("interpret", [True, None])
@pytest.mark.parametrize(
    "mode,q", [("4:2:0", 85), ("4:4:4", 92), (None, 75)]
)
def test_device_index_scan_matches_native(mode, q, interpret):
    """Converged device bitpos == the serial native index scan, bit for
    bit, across subsampling modes and a forced-small subsequence size
    (more rounds of the fixed point)."""
    if not entropy_native.available():
        pytest.skip("native library unavailable")
    if mode is None:
        img = corpus.synthetic_gray(56, 72, seed=9)
        data = corpus.pil_jpeg(img, quality=q)
    else:
        img = corpus.synthetic_rgb(56, 72, seed=9)
        data = corpus.pil_jpeg(img, quality=q, subsampling=mode)
    parsed = parse(data)
    inp = seg_mod.build_spec_scan_input(parsed, subseq_bytes=32)
    bitpos, ok, stats = sd.device_index_scan(
        *_scan_args(inp),
        sb=inp.subseq_bytes, n_mcus=inp.n_mcus, interpret=interpret,
    )
    assert bool(ok), np.asarray(stats)
    ref_bitpos, _, _ = entropy_native.index_scan(parsed, 1)
    np.testing.assert_array_equal(
        np.asarray(bitpos), ref_bitpos.astype(np.int32)
    )


@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2"])
def test_spec_engine_path_matches_serial(mode):
    """entropy_decode_device's device-specsync path (DC bases derived from
    the decode itself) == the serial host-scan path, coefficient-exact."""
    img = corpus.synthetic_rgb(48, 64, seed=3)
    data = corpus.pil_jpeg(img, quality=85, subsampling=mode)
    parsed = parse(data)
    a = entropy_decode_device(parsed, interpret=True)
    b = entropy_decode_device(parsed, interpret=True, specsync=False)
    assert a.specsync_stats is not None  # the spec path actually ran
    assert b.specsync_stats is None
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_spec_path_skipped_for_restart_streams():
    img = corpus.synthetic_rgb(48, 48, seed=7)
    data = corpus.pil_jpeg(
        img, quality=85, subsampling="4:2:0", restart_marker_blocks=1
    )
    parsed = parse(data)
    res = entropy_decode_device(parsed, interpret=True)
    assert res.specsync_stats is None


def test_spec_overflow_falls_back_to_serial(monkeypatch):
    """A scan that finds fewer MCU starts than the frame needs is not ok
    (here the scan input claims more MCUs than the stream holds); the
    engine must transparently decode via the serial scan instead, and
    count the fallback."""
    img = corpus.synthetic_rgb(48, 64, seed=3)
    data = corpus.pil_jpeg(img, quality=85, subsampling="4:2:0")
    parsed = parse(data)
    real_build = seg_mod.build_spec_scan_input

    def too_many_mcus(parsed, **kw):
        inp = real_build(parsed, **kw)
        inp.n_mcus += 4
        return inp

    monkeypatch.setattr(
        device_entropy, "build_spec_scan_input", too_many_mcus
    )
    before = device_entropy.FALLBACKS["scan_not_converged"]
    a = entropy_decode_device(parsed, interpret=True)
    assert a.specsync_stats is None  # fell back
    assert device_entropy.FALLBACKS["scan_not_converged"] == before + 1
    b = entropy_decode_device(parsed, interpret=True, specsync=False)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_spec_unsupported_size_falls_back(monkeypatch):
    img = corpus.synthetic_rgb(48, 64, seed=3)
    data = corpus.pil_jpeg(img, quality=85, subsampling="4:2:0")
    parsed = parse(data)

    def raise_unsupported(parsed, **kw):
        raise JpegUnsupportedError("forced")

    monkeypatch.setattr(
        device_entropy, "build_spec_scan_input", raise_unsupported
    )
    a = entropy_decode_device(parsed, interpret=True)
    assert a.specsync_stats is None
    b = entropy_decode_device(parsed, interpret=True, specsync=False)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_full_rgb_decode_via_spec_path():
    """Public API: DRI-less entropy='device' (now the spec path) == the
    host pipeline's RGB, end to end."""
    import jaxjpeg as jt

    img = corpus.synthetic_rgb(41, 67, seed=11)  # odd dims on purpose
    data = corpus.pil_jpeg(img, quality=88, subsampling="4:2:0")
    dev = jt.decode(data, impl="device", entropy="device")
    host = jt.decode(data, impl="host")
    np.testing.assert_array_equal(dev, host)


def test_gather_streams_pad_past_full_word_grid():
    """Words past the window grid read as 1-bits even when the stream
    fills the grid exactly (the bit reader's padding contract)."""
    spw, nws, nw = 2, 5, 3
    words = np.arange(1024 * spw, dtype=np.int32) + 7  # a full grid
    padded = np.concatenate([words, np.full(nws, -1, np.int32)])
    rows = np.lib.stride_tricks.sliding_window_view(padded, nws)[::spw][:1024]
    windows = jnp.asarray(rows.T.reshape(1, nws, 1024))
    last = 1024 * spw - 1
    bitpos = jnp.asarray(np.array([0, last * 32], np.int32))
    got = np.asarray(sd.gather_entropy_streams(
        windows, bitpos, nw=nw, spw=spw, nws=nws
    ))
    np.testing.assert_array_equal(got[0, :, 0], words[:nw])
    np.testing.assert_array_equal(got[0, :, 1], [words[last], -1, -1])
