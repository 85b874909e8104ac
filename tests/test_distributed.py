"""Multi-host glue, exercised in its single-process degenerate form on the
8-device CPU mesh (real pods only add initialize_from_env at startup)."""

import numpy as np
import pytest

from jaxjpeg.engine.batch import decode_batch
from jaxjpeg.parallel import distributed
from jaxjpeg.testing import corpus


def _corpus(n=8):
    datas = []
    for i in range(n):
        img = corpus.synthetic_rgb(32, 48, seed=i)
        datas.append(corpus.pil_jpeg(img, quality=80 + i % 3, subsampling="4:2:0"))
    return datas


def test_initialize_from_env_single_process():
    assert distributed.initialize_from_env() is False


def test_local_shard_covers_all():
    sl = distributed.local_shard(10)
    assert (sl.start, sl.stop) == (0, 10)  # single process owns everything


def test_decode_batch_distributed_matches_plain():
    datas = _corpus(8)
    ref = decode_batch(datas)
    got = distributed.decode_batch_distributed(datas)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_decode_batch_distributed_space_axis():
    datas = _corpus(4)
    ref = decode_batch(datas)
    got = distributed.decode_batch_distributed(datas, space=2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_decode_batch_distributed_rejects_mixed_geometry():
    datas = _corpus(2)
    img = corpus.synthetic_rgb(64, 64, seed=9)
    datas.append(corpus.pil_jpeg(img, quality=85, subsampling="4:2:0"))
    with pytest.raises(ValueError):
        distributed.decode_batch_distributed(datas)
