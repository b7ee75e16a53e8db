"""Device mesh helpers.

The reference has no distribution at all (one process, three threads,
SURVEY.md section 2); scale-out here rides a ``jax.sharding.Mesh`` with two
named axes:

* ``space``  — shards the *search/candidate* dimension (matcher angles, NDT
  spatial blocks): the tensor-parallel analog.
* ``batch``  — shards *independent work items* (particles, constraints,
  scans): the data-parallel analog.

All collectives (psum/all_gather/argmin reductions) are expressed inside
``shard_map`` bodies, so XLA runs them device to device (NCCL over NVLink
on one GPU host) and never through the host.  Every card of a host
reaches every other at the same rate, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

SPACE_AXIS = "space"
BATCH_AXIS = "batch"


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (space, batch) as close to square as possible."""
    best = (n, 1)
    for s in range(1, int(np.sqrt(n)) + 1):
        if n % s == 0:
            best = (n // s, s)
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Create the standard 2-D (space, batch) mesh."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        shape = _factor(n)
    assert shape[0] * shape[1] == n, (shape, n)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, (SPACE_AXIS, BATCH_AXIS))


def single_axis_mesh(n_devices: Optional[int] = None, axis: str = SPACE_AXIS,
                     devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))
