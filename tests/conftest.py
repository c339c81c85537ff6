"""Test config: run on CPU with 8 virtual devices (SURVEY.md section 4).

Multi-device sharding tests run against a virtual CPU mesh via
``xla_force_host_platform_device_count`` -- no accelerator required. x64 is
enabled so the FP64 API paths (reference matrix_inversion_FP64 /
no_pivots parity) are exercised with real double precision.

``JAX_PLATFORMS`` defaults to ``cpu``; the on-card tests
(``tests/test_gpu_oracle.py``, marker ``gpu``) run with
``JAX_PLATFORMS=cuda,cpu`` and put their data on the card explicitly, while
the default device stays the CPU for every other test.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])
