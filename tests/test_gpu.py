"""The compiled Triton kernels on the GPU (skipped without one).

Run on the card with ``JAXJPEG_TEST_PLATFORM=gpu python -m pytest -m chip
tests/``.
"""

import numpy as np
import pytest

from jaxjpeg.engine.device_entropy import FALLBACKS, entropy_decode_device
from jaxjpeg.host import entropy
from jaxjpeg.host.parser import parse
from jaxjpeg.ops import route
from jaxjpeg.testing import corpus


@pytest.mark.chip
@pytest.mark.parametrize("restart", [1, 8, 0])
@pytest.mark.parametrize("mode", ["mono", "4:2:0", "4:2:2"])
def test_compiled_kernels_match_host(gpu, mode, restart):
    assert route.route(platform=gpu.platform) == route.KERNEL
    enc = corpus.own_jpeg(
        corpus.synthetic_rgb(72, 104, seed=21), subsampling=mode,
        quality=85, restart_interval=restart,
    )
    parsed = parse(enc.data)
    ref = entropy.decode_scan(parsed)
    before = sum(FALLBACKS.values())
    res = entropy_decode_device(parsed)
    for a, b in zip(res.coefs, ref.coefs):
        np.testing.assert_array_equal(np.asarray(a), b.astype(np.int16))
    assert sum(FALLBACKS.values()) == before
    assert restart or res.specsync_stats is not None
