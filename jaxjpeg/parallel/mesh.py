"""Device mesh helpers.

The decode engine distributes along two axes (SURVEY.md sections 5, 7):

* ``data``  -- whole images (batched throughput mode; the DP axis),
* ``space`` -- MCU rows within an image (spatial sharding; the SP/CP
  analogue -- the reference's per-fragment parallelism, lifted to chips).

The reference is single-process/single-GPU; its only transport is PCIe
upload (update_buffer/update_texture, jpeg_gpu.c:211-254).  Here the mesh
axes ride the device interconnect (NVLink between the GPUs of a host),
with jax.sharding placing the collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(
    n_devices: Optional[int] = None,
    space: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, space) mesh over the available devices.

    ``space`` devices cooperate on one image (MCU-row sharding); the rest
    of the devices form the data axis.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if n_devices % space != 0:
        raise ValueError(f"{n_devices} devices not divisible by space={space}")
    grid = devices.reshape(n_devices // space, space)
    return Mesh(grid, (DATA_AXIS, SPACE_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Images over data, MCU block rows over space: (N, vb, hb, 8, 8)."""
    return NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
