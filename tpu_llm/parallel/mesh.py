"""Device-mesh construction.

The reference is strictly single-core (``README.md:21``); scaling here is
pure JAX SPMD: a named ``Mesh`` with a ``data`` axis (independent decode
streams / batch) and a ``model`` axis (tensor parallelism over ICI), per
SURVEY.md §2.3. Multi-host initialization goes through
``jax.distributed.initialize`` before building the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    model: Optional[int] = None,
    pipe: int = 1,
    expert: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (pipe, data, expert, model) mesh. ``model`` defaults to all
    remaining devices. The GPUs of one host are joined all to all by
    NVLink, so the mesh follows the algorithm alone: devices are taken in
    id order, model axis innermost, pipe outermost — stage handoffs are
    the rarest collective, so across hosts they are the ones that cross
    the network while TP stays inside a host.

    ``expert`` is the expert-parallel axis for the MoE layers' stacked
    experts (size 1 by default — a size-1 axis is free)."""
    devs = list(devices if devices is not None else jax.devices())
    if model is None:
        model = len(devs) // (data * pipe * expert)
    if pipe * data * expert * model > len(devs):
        raise ValueError(
            f"mesh {pipe}x{data}x{expert}x{model} exceeds {len(devs)} devices"
        )
    grid = np.asarray(devs[: pipe * data * expert * model]).reshape(
        pipe, data, expert, model
    )
    return Mesh(grid, axis_names=("pipe", "data", "expert", "model"))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)
