import numpy as np

from jaxjpeg.ops.zigzag import ZIGZAG, DEZIGZAG, raster_to_zigzag, zigzag_to_raster

# First and last entries of the standard zig-zag order (ITU T.81 fig. 5).
_KNOWN_PREFIX = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5]
_KNOWN_SUFFIX = [53, 60, 61, 54, 47, 55, 62, 63]


def test_zigzag_is_permutation():
    assert sorted(ZIGZAG.tolist()) == list(range(64))


def test_zigzag_known_values():
    assert ZIGZAG[:16].tolist() == _KNOWN_PREFIX
    assert ZIGZAG[-8:].tolist() == _KNOWN_SUFFIX


def test_zigzag_inverse():
    assert (DEZIGZAG[ZIGZAG] == np.arange(64)).all()


def test_round_trip():
    rng = np.random.default_rng(0)
    x = rng.integers(-1024, 1024, size=(5, 8, 8), dtype=np.int32)
    assert (zigzag_to_raster(raster_to_zigzag(x)) == x).all()
