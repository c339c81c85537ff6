"""On-card oracles: the compiled kernels and routes on a CUDA device.

The CPU suite runs the Triton kernel only in the Pallas interpreter; these
tests run it compiled (and the jnp routes on the card) against the jnp spec
and numpy. They skip where no CUDA device exists -- the decision is made in
the ``gpu`` fixture, never at import, so every worker collects the same
tests. Run them on the card on their own (each card takes one JAX
process)::

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu_oracle.py -m gpu -v
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_matrix_inversion_tpu.utils.generators import (hollow_random_matrix,
                                                       well_conditioned_matrix)
from gpu_matrix_inversion_tpu.utils.residual import relative_residual

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA device (JAX_PLATFORMS=cuda,cpu)")
    return devs[0]


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("n", [16, 37, 128])
def test_gpu_fused_matches_spec(gpu, n, pivot):
    """Compiled kernel vs the jnp spec (both on the card)."""
    from gpu_matrix_inversion_tpu.ops.fused import fused_inverse
    from gpu_matrix_inversion_tpu.ops.gauss_jordan import gauss_jordan_inverse

    gen = hollow_random_matrix if pivot else well_conditioned_matrix
    a = np.stack([gen(n, seed=10 * n + s) for s in range(8)])
    x = jax.device_put(a, gpu)
    inv, ok = fused_inverse(x, pivot=pivot)
    ref, ok_ref = gauss_jordan_inverse(x, pivot=pivot)
    assert bool(np.all(np.asarray(ok))) and bool(np.all(np.asarray(ok_ref)))
    for i in range(8):
        assert relative_residual(a[i], np.asarray(inv)[i]) < 1e-5
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(np.asarray(inv), np.asarray(ref),
                               atol=1e-4 * scale)


def test_gpu_fused_flags_and_bf16(gpu):
    """Singular and NaN members flagged; bf16 in, bf16 out."""
    from gpu_matrix_inversion_tpu.ops.fused import fused_inverse

    good = hollow_random_matrix(64, seed=3)
    nan = good.copy()
    nan[1, 2] = np.nan
    batch = np.stack([good, np.ones((64, 64), np.float32), nan])
    _, ok = fused_inverse(jax.device_put(batch, gpu))
    assert np.asarray(ok).tolist() == [True, False, False]
    inv, ok = fused_inverse(jax.device_put(good.astype(jnp.bfloat16), gpu))
    assert bool(ok) and inv.dtype == jnp.bfloat16


def test_gpu_solver_routes(gpu):
    """auto on the card: fused for a small batch, blocked for a large
    single matrix; LU, Cholesky and FP64 through the public entry points."""
    import gpu_matrix_inversion_tpu as mi
    from gpu_matrix_inversion_tpu.models.solver import _resolve

    small = jax.device_put(
        np.stack([hollow_random_matrix(32, seed=s) for s in range(4)]), gpu)
    assert _resolve("auto", small) == "fused"
    big_h = hollow_random_matrix(1024, seed=5)
    big = jax.device_put(big_h, gpu)
    assert _resolve("auto", big) == "blocked"
    for method, bound in (("auto", 1e-5), ("lu", 1e-5)):
        inv, ok = mi.inverse(big, method=method)
        assert bool(ok)
        assert relative_residual(big_h, np.asarray(inv)) < bound, method
    g = np.random.default_rng(1).standard_normal((512, 512))
    spd = (g @ g.T / 512 + np.eye(512)).astype(np.float32)
    inv, ok = mi.cholesky_inverse(jax.device_put(spd, gpu))
    assert bool(ok) and relative_residual(spd, np.asarray(inv)) < 1e-6
    with jax.enable_x64(True):
        a64 = hollow_random_matrix(512, seed=7, dtype=np.float64)
        inv, ok = mi.inverse(jax.device_put(a64, gpu))
        assert bool(ok) and relative_residual(a64, np.asarray(inv)) < 1e-12


def test_gpu_sharded_on_one_device_mesh(gpu):
    """The mesh paths on a 1-device GPU mesh: the column-sharded blocked
    body, and the fused kernel under shard_map for a dp-only batch."""
    from gpu_matrix_inversion_tpu.parallel import (make_device_mesh,
                                                   sharded_batched_inverse,
                                                   sharded_blocked_inverse)

    mesh = make_device_mesh(1, ("x",), platform="gpu")
    a = hollow_random_matrix(512, seed=11)
    inv, ok = sharded_blocked_inverse(a, mesh=mesh)
    assert bool(ok) and relative_residual(a, np.asarray(inv)) < 1e-5
    mesh2 = make_device_mesh((1, 1), ("dp", "tp"), platform="gpu")
    batch = np.stack([hollow_random_matrix(64, seed=s) for s in range(4)])
    invb, okb = sharded_batched_inverse(batch, mesh=mesh2)
    assert bool(np.all(np.asarray(okb)))
    for i in range(4):
        assert relative_residual(batch[i], np.asarray(invb)[i]) < 1e-5
