"""Where a computation runs, and which route that platform gets.

The one place that decides between the compiled GPU kernels and the plain
jnp routes:

- on CUDA (JAX platform ``"gpu"``) the hand-written Pallas kernels compile
  through Triton;
- on the CPU the plain jnp routes run.

The Pallas interpreter is never chosen here: it runs only where a caller
passes ``interpret=True`` explicitly (the CPU tests of the kernels).
"""

from __future__ import annotations

import jax
import numpy as np

GPU = "gpu"


def default_platform() -> str:
    """Platform computations land on by default.

    Honors a pinned ``jax_default_device``, which JAX accepts as a device
    or as a platform string (``"cpu"``, ``"cpu:0"``)."""
    default = getattr(jax.config, "jax_default_device", None)
    if isinstance(default, str):
        return default.split(":", 1)[0]
    if default is not None:
        return default.platform
    return jax.default_backend()


def platform_of(x=None) -> str:
    """Platform of a concrete array's devices; the default platform for
    host data and for tracers (whose devices are not known at trace time)."""
    if isinstance(x, jax.Array) and not isinstance(x, jax.core.Tracer):
        try:
            return next(iter(x.devices())).platform
        except (AttributeError, RuntimeError, StopIteration):
            pass
    return default_platform()


def mesh_platform(mesh) -> str:
    """Platform of a mesh's devices (a mesh never mixes platforms)."""
    return np.ravel(mesh.devices)[0].platform


def compiled_kernels(platform: str) -> bool:
    """True where the hand-written kernels compile (CUDA through Triton)."""
    return platform == GPU
