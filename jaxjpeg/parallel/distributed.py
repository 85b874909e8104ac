"""Multi-host decode: jax.distributed glue + per-host input distribution.

The reference is a single-process, single-GPU program whose only transport
is PCIe texture upload (SURVEY.md section 5).  Across hosts the
equivalent stack is:

* the host network carries the *inputs*: each host parses and
  entropy-decodes (or stream-packs) only its local shard of the corpus --
  compressed bits never cross hosts;
* the device interconnect carries the *collectives*: the (data, space)
  mesh spans all hosts' devices, and `jax.make_array_from_process_local_data`
  assembles the global batch from per-host shards without any host
  gathering the whole corpus;
* the decode step itself is the same shard_map program as single-host
  (parallel/shard.py) -- XLA places the psum/all_gather/ppermute.

Single-process runs degrade to the plain mesh path, so everything here is
exercised by the CPU-mesh test suite; multi-host runs only add
``initialize_from_env()`` at startup.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import jax
import numpy as np

from jaxjpeg.parallel.mesh import DATA_AXIS, SPACE_AXIS, make_mesh
from jaxjpeg.utils.logging import get_logger

log = get_logger("parallel")


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed for a multi-host run.

    Arguments default to the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns True if distributed mode was initialized, False for
    single-process runs (no coordinator configured).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None and num_processes is None:
        log.debug("no coordinator configured; single-process mode")
        return False
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    elif os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None:
        kwargs["process_id"] = process_id
    elif os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    log.info(
        "distributed: process %d/%d, %d local + %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def local_shard(n_items: int) -> slice:
    """This host's contiguous shard of an n_items corpus (round-robin-free,
    contiguous so neighbouring images stay on one host)."""
    p, np_ = jax.process_index(), jax.process_count()
    lo = n_items * p // np_
    hi = n_items * (p + 1) // np_
    return slice(lo, hi)


def decode_batch_distributed(
    local_datas: Sequence[bytes],
    exact: bool = True,
    upsample: str = "nearest",
    space: int = 1,
) -> List[np.ndarray]:
    """Decode this host's shard of a same-geometry corpus on the global mesh.

    Every host calls this with ITS OWN images (use ``local_shard`` to split
    a global list).  Hosts entropy-decode locally (DCN never carries
    pixels), the global batch assembles from process-local shards, and one
    shard_map program decodes it across all devices.  Returns this host's
    RGB arrays in local order.

    All hosts must pass the same number of images per local device and the
    same geometry (one bucket); heterogeneous corpora should be bucketed
    by the caller (engine/batch.py bucketing) before distribution.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jaxjpeg.engine.batch import _entropy_decode
    from jaxjpeg.engine.pipeline import PipelineSpec
    from jaxjpeg.host.parser import parse
    from jaxjpeg.parallel.shard import decode_batch_sharded

    if not local_datas:
        return []
    parsed = [parse(d) for d in local_datas]
    spec = PipelineSpec.from_header(
        parsed[0].header, exact=exact, upsample=upsample
    )
    for p_ in parsed[1:]:
        s2 = PipelineSpec.from_header(p_.header, exact=exact, upsample=upsample)
        if s2 != spec:
            raise ValueError(
                "decode_batch_distributed requires one geometry bucket; "
                "bucket the corpus first (engine/batch.py)"
            )
    results = [_entropy_decode(p_) for p_ in parsed]
    qts = [
        np.stack(
            [p_.header.quant_for(c).values.astype(np.int32)
             for c in p_.header.components]
        )
        for p_ in parsed
    ]

    mesh = make_mesh(space=space)
    n_local = len(local_datas)
    n_global = n_local * jax.process_count()
    coefs_sharding = NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))
    q_sharding = NamedSharding(mesh, P(DATA_AXIS))

    ncomps = spec.ncomps
    coefs = tuple(
        jax.make_array_from_process_local_data(
            coefs_sharding,
            np.stack([r.coefs[ci] for r in results]),
            (n_global,) + results[0].coefs[ci].shape,
        )
        for ci in range(ncomps)
    )
    qtables = tuple(
        jax.make_array_from_process_local_data(
            q_sharding,
            np.stack([q[ci] for q in qts])[:, None, None, :, :],
            (n_global, 1, 1, 8, 8),
        )
        for ci in range(ncomps)
    )
    rgb, _ = decode_batch_sharded(spec, mesh, coefs, qtables)
    # Each host reads back only its addressable (local) shards; with a
    # space axis each image arrives as row slices to reassemble.
    h, w = spec.height, spec.width
    out: List[Optional[np.ndarray]] = [None] * n_local
    base = n_local * jax.process_index()
    rows: dict = {}
    for shard in rgb.addressable_shards:
        arr = np.asarray(shard.data)
        i0 = shard.index[0].start or 0
        r0 = shard.index[1].start or 0
        for j in range(arr.shape[0]):
            gidx = i0 + j
            if base <= gidx < base + n_local:
                rows.setdefault(gidx, {})[r0] = arr[j]
    for gidx, parts in rows.items():
        img = (
            parts[0]
            if len(parts) == 1
            else np.concatenate([parts[k] for k in sorted(parts)], axis=0)
        )
        out[gidx - base] = img[:h, :w]
    return out  # type: ignore[return-value]
