"""Tests of the one module that decides the platform and its route
(utils/platform.py)."""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_matrix_inversion_tpu.utils import platform as P


def test_default_platform_follows_pinned_device():
    """The suite pins the CPU as default device; a platform string is
    honored too."""
    assert P.default_platform() == "cpu"
    prev = jax.config.jax_default_device
    try:
        jax.config.update("jax_default_device", "cpu")
        assert P.default_platform() == "cpu"
    finally:
        jax.config.update("jax_default_device", prev)


def test_platform_of_arrays_and_tracers():
    """Concrete arrays report their devices' platform; host data and
    tracers report the default platform."""
    x = jax.device_put(jnp.ones((2, 2)), jax.devices("cpu")[3])
    assert P.platform_of(x) == "cpu"
    assert P.platform_of(np.ones((2, 2))) == "cpu"
    assert P.platform_of(None) == "cpu"
    seen = []
    jax.jit(lambda t: seen.append(P.platform_of(t)) or t)(x)
    assert seen == ["cpu"]
    with mock.patch.object(P, "default_platform", return_value="gpu"):
        assert P.platform_of(np.ones((2, 2))) == "gpu"   # host data
        assert P.platform_of(x) == "cpu"                 # committed array


@pytest.mark.parametrize("platform,compiled",
                         [("gpu", True), ("cpu", False), ("", False)])
def test_compiled_kernels_only_on_cuda(platform, compiled):
    """Only CUDA devices compile the hand-written kernels; every other
    platform takes the plain jnp routes (never the interpreter)."""
    assert P.compiled_kernels(platform) is compiled


def test_mesh_platform():
    from gpu_matrix_inversion_tpu.parallel import make_device_mesh
    mesh = make_device_mesh((2, 2), ("dp", "tp"), platform="cpu")
    assert P.mesh_platform(mesh) == "cpu"
