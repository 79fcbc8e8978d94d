"""Device mesh construction for the `streams` data-parallel axis."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


STREAMS_AXIS = "streams"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the given) devices on the `streams` axis.

    A codec has a single natural parallel axis — independent streams/blocks —
    so the mesh is 1-D regardless of the physical topology (the GPUs of a
    host are joined all to all over NVLink, so no device order is
    preferred). Multi-host runs use the same global 1-D mesh over all
    processes' devices (jax.distributed must be initialized first).
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, axis_names=(STREAMS_AXIS,))
