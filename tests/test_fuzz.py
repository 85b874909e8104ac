"""Garbage-in robustness: arbitrary bytes must raise JpegError (or decode),
never crash with anything else.  Mirrors the reference's validation-gate
role (GLJ_ENABLE_VALIDATION) as a hard API contract."""

import numpy as np
import pytest

import jaxjpeg as jt
from jaxjpeg.errors import JpegError
from jaxjpeg.testing import corpus


def _attempt(data: bytes) -> None:
    try:
        jt.decode(data, impl="host")
    except JpegError:
        pass


def test_random_bytes():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 16, 256, 4096):
        for _ in range(8):
            _attempt(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())


def test_truncations_of_valid_stream():
    img = corpus.synthetic_rgb(24, 32, seed=1)
    enc = corpus.own_jpeg(img, subsampling="4:2:0", quality=85, restart_interval=1)
    data = enc.data
    rng = np.random.default_rng(1)
    for cut in sorted(set(int(x) for x in rng.integers(1, len(data), size=24))):
        _attempt(data[:cut])


def test_bitflips_of_valid_stream():
    img = corpus.synthetic_gray(24, 24, seed=2)
    enc = corpus.own_jpeg(img, quality=85)
    rng = np.random.default_rng(2)
    for _ in range(24):
        buf = bytearray(enc.data)
        pos = int(rng.integers(2, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        _attempt(bytes(buf))


def test_bitflips_vsamp4_stream():
    """vsamp=4 geometry (parser-accepted corner no common encoder emits):
    corrupted streams must fail cleanly through the general path too."""
    img = corpus.synthetic_rgb(24, 24, seed=3)
    enc = corpus.own_jpeg(img, subsampling="h2v4", quality=85, restart_interval=1)
    rng = np.random.default_rng(3)
    for _ in range(16):
        buf = bytearray(enc.data)
        pos = int(rng.integers(2, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        _attempt(bytes(buf))


def test_bitflips_device_entropy_no_dri():
    """DRI-less device path: the index scan validates while walking, so a
    corrupted no-restart stream must raise JpegError (or decode), never
    crash -- through the device planner and kernel plumbing."""
    img = corpus.synthetic_gray(24, 24, seed=4)
    enc = corpus.own_jpeg(img, quality=85)
    rng = np.random.default_rng(4)
    for _ in range(10):
        buf = bytearray(enc.data)
        pos = int(rng.integers(2, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            jt.decode(bytes(buf), impl="device", entropy="device")
        except JpegError:
            pass
