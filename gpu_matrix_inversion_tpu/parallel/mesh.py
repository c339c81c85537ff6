"""Device-mesh helpers.

The replacement for the reference's hardcoded device selection
(``platforms[0]/devices[0]``, matrix_inversion_FP32.cpp:293, :337): meshes
are first-class, sized by request, and can be pinned to a platform (the test
suite builds 8-way CPU meshes via ``xla_force_host_platform_device_count``).
The cards of one host are joined all to all, so a mesh's shape follows the
algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh

from gpu_matrix_inversion_tpu.utils.platform import default_platform


def default_platform_devices():
    """Devices of the platform computations land on by default (honors a
    pinned ``jax_default_device``, given as a device or a platform
    string)."""
    return jax.devices(default_platform())


def make_device_mesh(shape: Sequence[int] | int,
                     axis_names: Tuple[str, ...] = ("x",),
                     platform: Optional[str] = None) -> Mesh:
    """Build a ``jax.sharding.Mesh`` of the requested shape.

    Args:
      shape: total devices (int) or per-axis sizes.
      axis_names: mesh axis names (e.g. ``("dp", "tp")``).
      platform: pin to a platform (``"cpu"``/``"gpu"``); defaults to the
        default platform. A request for more devices than that platform
        has raises -- a mesh never moves to another platform unasked.
    """
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    devices = (jax.devices(platform) if platform is not None
               else default_platform_devices())
    if len(devices) < n:
        raise ValueError(
            f"mesh of {n} devices requested but only {len(devices)} "
            f"available (platform={platform or default_platform()})")
    arr = np.asarray(devices[:n]).reshape(shape)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} mesh dims need {len(shape)} axis "
                         f"names, got {axis_names}")
    return Mesh(arr, axis_names)
