"""Multi-chip tests on a virtual 8-device CPU mesh (SURVEY.md section 4:
multi-chip tests run on CPU via xla_force_host_platform_device_count)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_matrix_inversion_tpu.parallel import (
    make_device_mesh,
    sharded_blocked_inverse,
    sharded_batched_inverse,
)
from gpu_matrix_inversion_tpu.utils.generators import hollow_random_matrix
from gpu_matrix_inversion_tpu.utils.residual import relative_residual

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="needs 8 virtual CPU devices")


def test_mesh_helper():
    mesh = make_device_mesh(8, ("x",), platform="cpu")
    assert mesh.shape["x"] == 8
    mesh2 = make_device_mesh((2, 4), ("dp", "tp"), platform="cpu")
    assert mesh2.shape == {"dp": 2, "tp": 4}


def test_sharded_inverse_matches_numpy():
    mesh = make_device_mesh(8, ("x",), platform="cpu")
    a = hollow_random_matrix(256, seed=70)
    inv, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=32)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_sharded_inverse_padding():
    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a = hollow_random_matrix(200, seed=71)
    inv, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=32)
    assert bool(ok)
    assert inv.shape == (200, 200)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_sharded_singular_flagged():
    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a = np.ones((64, 64), dtype=np.float32)
    _, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=16)
    assert not bool(ok)


def test_sharded_batched_dp_tp():
    mesh = make_device_mesh((2, 4), ("dp", "tp"), platform="cpu")
    a = np.stack([hollow_random_matrix(64, seed=s) for s in range(4)])
    inv, ok = sharded_batched_inverse(a, mesh=mesh, block_size=16)
    assert inv.shape == a.shape
    assert bool(np.all(np.asarray(ok)))
    for i in range(4):
        assert relative_residual(a[i], np.asarray(inv)[i]) < 1e-5


def test_sharded_bf16_io_contract():
    """bf16 input computes in f32 and returns bf16, exactly like
    blocked_inverse -- the mesh route must not drop a quality tier.
    (Regression: the sharded paths used to run the whole elimination in
    bf16 arithmetic, residual ~1e0 on inputs where the f32 compute path
    lands ~1e-3 after the bf16 output cast.)"""
    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a32 = hollow_random_matrix(96, seed=77)
    a = jnp.asarray(a32, dtype=jnp.bfloat16)
    inv, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=16)
    assert inv.dtype == jnp.bfloat16 and bool(ok)
    assert relative_residual(np.asarray(a, np.float32),
                             np.asarray(inv, np.float32)) < 1e-2

    mesh2 = make_device_mesh((2, 2), ("dp", "tp"), platform="cpu")
    ab = jnp.asarray(np.stack([a32, hollow_random_matrix(96, seed=78)]),
                     dtype=jnp.bfloat16)
    invb, okb = sharded_batched_inverse(ab, mesh=mesh2, block_size=16)
    assert invb.dtype == jnp.bfloat16 and bool(np.all(np.asarray(okb)))
    for i in range(2):
        assert relative_residual(np.asarray(ab[i], np.float32),
                                 np.asarray(invb[i], np.float32)) < 1e-2


def test_sharded_fp64():
    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a = hollow_random_matrix(128, seed=72, dtype=np.float64)
    inv, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=16)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-14


def test_sharded_matches_blocked_on_one_device_mesh():
    """On a 1-device mesh the sharded path runs the SAME shared
    _group_factor + windowed update as the single-device blocked driver,
    so the result must match bit-for-bit."""
    from gpu_matrix_inversion_tpu.ops.blocked import _blocked_inverse_jit

    mesh = make_device_mesh(1, ("x",), platform="cpu")
    a = hollow_random_matrix(256, seed=73)
    inv_sh, ok_sh = sharded_blocked_inverse(a, mesh=mesh, block_size=32,
                                            refine=0)
    inv_bl, ok_bl = _blocked_inverse_jit(
        jnp.asarray(a), pivot=True, block_size=32, precision="highest",
        group_size=32, refine=0)
    assert bool(ok_sh) and bool(ok_bl)
    np.testing.assert_array_equal(np.asarray(inv_sh), np.asarray(inv_bl))


def test_sharded_group_straddles_shards():
    """A group width that does not divide the shard width exercises the
    two-owner strip gather and the straddling deposits."""
    mesh = make_device_mesh(8, ("x",), platform="cpu")
    a = hollow_random_matrix(320, seed=74)
    # b=16, d=8 -> m rounds up to b*d*3 = 384, w = 2m/d = 96; group=4 ->
    # gw=64 does not divide the 96-wide shards, so group boundaries
    # straddle shard boundaries (plus 64 pad columns exercise padding).
    inv, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=16,
                                      group_size=4)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_sharded_production_geometry():
    """The mesh path at PRODUCTION geometry -- n=4096,
    b=128, the default group width (gw=1536) -- on a 4-device mesh
    (w=2048), so the features toy shapes never reach actually execute
    multi-device: the two-owner straddling strip gather (group 1 spans
    columns 1536:3072 across the shard boundary at 2048), straddling slot
    deposits (group 1's slots span the boundary at 6144), the tail group
    (32 panels = 2 full groups of 12 + tail of 8), and ``_unpermute`` at
    real shard widths. ~35 s on the virtual CPU mesh (jnp factor path)."""
    from gpu_matrix_inversion_tpu.parallel.sharded import _sharded_params

    n, d = 4096, 4
    b, m, group = _sharded_params(n, 128, d, None)
    assert (b, m) == (128, 4096) and group == 12  # the production gw=1536
    w = 2 * m // d
    gw = group * b
    # The geometry really does straddle: group 1's strip crosses a shard
    # boundary, as do its slot deposits.
    assert gw % w != 0 and (gw // w) != ((2 * gw - 1) // w)
    mesh = make_device_mesh(d, ("x",), platform="cpu")
    a = hollow_random_matrix(n, seed=40)
    inv, ok = sharded_blocked_inverse(a, mesh=mesh, refine=1)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_sharded_batched_dp_tp_panel_width():
    """The 2D dp x tp mesh at REAL panel width -- b=128 shard arithmetic
    under a dp axis.
    n=768 on a (2, 4) mesh: m=1024, w=2m/tp=512, and group_size=3 makes
    gw=384 straddle the shard boundaries (kb0=384 spans 384:768 across
    512), so the two-owner strip gather, the straddling deposits, AND the
    batch dimension all run together at production panel width."""
    from gpu_matrix_inversion_tpu.parallel.sharded import _sharded_params

    n, tp = 768, 4
    b, m, group = _sharded_params(n, 128, tp, 3)
    assert b == 128 and m == 1024 and group == 3
    w = 2 * m // tp
    gw = group * b
    assert (384 % w) + gw > w  # group 1 really straddles a shard boundary
    mesh = make_device_mesh((2, tp), ("dp", "tp"), platform="cpu")
    a = np.stack([hollow_random_matrix(n, seed=80 + s) for s in range(2)])
    inv, ok = sharded_batched_inverse(a, mesh=mesh, block_size=128,
                                      group_size=3)
    assert inv.shape == a.shape
    assert bool(np.all(np.asarray(ok)))
    for i in range(2):
        # Raw (no-refine) path at n=768: the BASELINE <=1e-4 gate.
        assert relative_residual(a[i], np.asarray(inv)[i]) < 1e-4


def test_sharded_solve():
    """solve() through the sharded method: the mesh
    inverse feeds the solve GEMM; the result must solve the system."""
    from gpu_matrix_inversion_tpu.models.solver import solve

    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a = hollow_random_matrix(256, seed=41)
    rng = np.random.default_rng(42)
    b = rng.standard_normal((256, 8)).astype(np.float32)
    x, ok = solve(a, b, method="sharded", mesh=mesh)
    assert bool(ok)
    r = np.linalg.norm(a.astype(np.float64) @ np.asarray(x) - b)
    assert r / np.linalg.norm(b) < 1e-4


def test_sharded_refine_polish():
    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a = hollow_random_matrix(192, seed=75)
    inv0, _ = sharded_blocked_inverse(a, mesh=mesh, block_size=32, refine=0)
    inv1, ok = sharded_blocked_inverse(a, mesh=mesh, block_size=32, refine=1)
    assert bool(ok)
    assert (relative_residual(a, np.asarray(inv1))
            <= relative_residual(a, np.asarray(inv0)))


def test_driver_dryrun_multichip():
    """The 8-device dryrun must run end-to-end on the virtual CPU mesh."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_default_platform_devices_accepts_string_default():
    """Review fix: jax accepts a platform STRING for jax_default_device;
    default_platform_devices must not crash on it (it used to read
    .platform off the string)."""
    import jax
    from gpu_matrix_inversion_tpu.parallel.mesh import (
        default_platform_devices)

    prev = jax.config.jax_default_device
    try:
        jax.config.update("jax_default_device", "cpu")
        devs = default_platform_devices()
        assert devs and all(d.platform == "cpu" for d in devs)
    finally:
        jax.config.update("jax_default_device", prev)


def test_batched_fused_route_gate():
    """dp-only GPU meshes with fused-sized matrices take the fused kernel
    per device; anything else keeps the column-sharded panel body (CPU
    meshes run the jnp route)."""
    import jax.numpy as jnp
    from gpu_matrix_inversion_tpu.parallel.sharded import _batched_fused_route

    assert _batched_fused_route(1, 128, jnp.float32, "gpu")
    assert _batched_fused_route(1, 100, jnp.bfloat16, "gpu")
    assert not _batched_fused_route(2, 128, jnp.float32, "gpu")   # tp > 1
    assert not _batched_fused_route(1, 129, jnp.float32, "gpu")   # too big
    assert not _batched_fused_route(1, 128, jnp.float32, "cpu")   # CPU mesh
    assert not _batched_fused_route(1, 128, jnp.float64, "gpu")   # fp64


def test_make_device_mesh_raises_instead_of_falling_back():
    """A mesh larger than the default platform has raises; it never moves
    to another platform unasked (CPU meshes come only from
    platform="cpu" or a CPU default)."""
    from unittest import mock
    from gpu_matrix_inversion_tpu.parallel import mesh as M

    one_gpu = [mock.Mock(platform="gpu")]
    with mock.patch.object(M, "default_platform_devices",
                           return_value=one_gpu), \
            mock.patch.object(M, "default_platform", return_value="gpu"):
        with pytest.raises(ValueError, match="mesh of 4 devices"):
            M.make_device_mesh(4, ("x",))
    with pytest.raises(ValueError, match="only 8 available"):
        make_device_mesh(9, ("x",), platform="cpu")


def test_sharded_params_round_to_mesh():
    """m rounds n up so panels tile every shard (b*d | m), and the group
    never spans more than two shards (gw <= w = 2m/d)."""
    from gpu_matrix_inversion_tpu.parallel.sharded import _sharded_params

    for n, bs, d in ((8100, 128, 3), (16350, 128, 3), (4096, 128, 6),
                     (513, 128, 3), (200, 32, 4), (4096, 128, 4)):
        b, m, group = _sharded_params(n, bs, d, None)
        assert b == min(bs, -(-n // 8) * 8), (n, b)
        assert m % (b * d) == 0 and n <= m < n + b * d, (n, d, m)
        assert group * b <= 2 * m // d, (n, d, group)
