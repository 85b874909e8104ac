"""Speculative parallel index scan (host/specsync.py) vs the native scan.

The fixed point of the Jacobi entry-state iteration is the serial decode
by construction; these tests assert bit-exact bitpos/dc_base/end_bit
parity with entropy_native.index_scan across subsampling modes, quality
extremes, subsequence sizes and the grayscale single-component layout.
"""

import numpy as np
import pytest

from jaxjpeg.host import entropy_native
from jaxjpeg.host.parser import parse
from jaxjpeg.host.specsync import spec_index_scan
from jaxjpeg.testing import corpus

pytestmark = pytest.mark.skipif(
    not entropy_native.available(), reason="native scan is the ground truth"
)


def _assert_exact(dat, subseq_bytes=32, max_rounds=64):
    par = parse(dat)
    bitpos, dc_base, end_bit = entropy_native.index_scan(par, 1)
    res = spec_index_scan(
        par, subseq_bytes=subseq_bytes, max_rounds=max_rounds
    )
    assert res is not None and res.converged
    np.testing.assert_array_equal(res.bitpos, bitpos)
    np.testing.assert_array_equal(res.dc_base, dc_base)
    assert res.end_bit == end_bit
    return res


@pytest.mark.parametrize("sub", ["4:4:4", "4:2:2", "4:2:0"])
def test_specsync_exact_subsampling(sub):
    img = corpus.synthetic_rgb(96, 136, seed=3)
    _assert_exact(corpus.pil_jpeg(img, quality=80, subsampling=sub))


@pytest.mark.parametrize("q", [30, 95])
def test_specsync_exact_quality_extremes(q):
    img = corpus.synthetic_rgb(80, 120, seed=7)
    _assert_exact(corpus.pil_jpeg(img, quality=q, subsampling="4:2:0"))


def test_specsync_exact_gray():
    img = corpus.synthetic_gray(72, 96, seed=5)
    _assert_exact(corpus.pil_jpeg(img, quality=85))


@pytest.mark.parametrize("sb", [16, 64, 512])
def test_specsync_subsequence_sizes(sb):
    """Small sizes stress sync distance; 512 leaves only a handful of
    subsequences (the near-serial degenerate)."""
    img = corpus.synthetic_rgb(64, 88, seed=11)
    _assert_exact(
        corpus.pil_jpeg(img, quality=75, subsampling="4:2:0"),
        subseq_bytes=sb,
    )


def test_specsync_nonconvergence_returns_none():
    """max_rounds=1 cannot reach the fixed point on a multi-subsequence
    stream (round 1 still changes entries) -> None, the fallback signal;
    never a wrong answer."""
    img = corpus.synthetic_rgb(96, 136, seed=3)
    par = parse(corpus.pil_jpeg(img, quality=80, subsampling="4:2:0"))
    assert spec_index_scan(par, subseq_bytes=16, max_rounds=1) is None
