"""Cholesky family: potrf / potrs / potri, plus LU-derived det/slogdet.

The SPD path is a capability the reference never had (its README concedes
LAPACK-shaped factorizations win, the reference README.md:62); these tests
gate it against numpy.linalg the way the LU suite gates getrf/getri."""

import numpy as np
import pytest

from gpu_matrix_inversion_tpu.ops.cholesky import (cholesky_factor,
                                                   cholesky_inverse,
                                                   cholesky_solve)
from gpu_matrix_inversion_tpu.utils.generators import hollow_random_matrix
from gpu_matrix_inversion_tpu.utils.residual import relative_residual


def spd_matrix(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n))
    return ((b @ b.T) / n + np.eye(n)).astype(dtype)


def test_factor_matches_numpy():
    for n in (64, 200, 384):  # 200 exercises the identity padding
        a = spd_matrix(n, seed=n)
        l, ok = cholesky_factor(a, block_size=128)
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(l), np.linalg.cholesky(a),
                                   rtol=2e-4, atol=2e-5)
        # Strictly lower output: upper triangle must be exactly zero.
        assert np.all(np.triu(np.asarray(l), 1) == 0)


def test_factor_reads_lower_triangle_only():
    """LAPACK uplo='L' semantics: garbage above the diagonal is ignored."""
    n = 96
    a = spd_matrix(n, seed=5)
    junk = a.copy()
    junk[np.triu_indices(n, 1)] = 333.0
    l1, ok1 = cholesky_factor(a, block_size=32)
    l2, ok2 = cholesky_factor(junk, block_size=32)
    assert bool(ok1) and bool(ok2)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_factor_batched_and_fp64():
    batch = np.stack([spd_matrix(128, seed=10 + i) for i in range(4)])
    l, ok = cholesky_factor(batch)
    assert np.all(np.asarray(ok))
    for i in range(4):
        np.testing.assert_allclose(np.asarray(l)[i],
                                   np.linalg.cholesky(batch[i]),
                                   rtol=2e-4, atol=2e-5)
    a64 = spd_matrix(160, seed=3, dtype=np.float64)
    l64, ok64 = cholesky_factor(a64, block_size=64)
    assert bool(ok64)
    np.testing.assert_allclose(np.asarray(l64), np.linalg.cholesky(a64),
                               rtol=1e-12, atol=1e-13)


def test_non_spd_flags_not_ok():
    n = 48
    a = spd_matrix(n, seed=7)
    a[n // 2, n // 2] = -50.0  # indefinite
    _, ok = cholesky_factor(a)
    assert not bool(ok)
    _, ok_inv = cholesky_inverse(a)
    assert not bool(ok_inv)


def test_solve_matches_numpy():
    n = 192
    a = spd_matrix(n, seed=21)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    l, ok_f = cholesky_factor(a, block_size=64)
    x, ok_s = cholesky_solve(l, b)
    assert bool(ok_f) and bool(ok_s)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                               rtol=5e-3, atol=5e-4)
    # Vector RHS round-trips through the (..., n) path.
    xv, ok_v = cholesky_solve(l, b[:, 0])
    assert bool(ok_v) and xv.shape == (n,)
    np.testing.assert_allclose(np.asarray(xv), np.asarray(x)[:, 0])


def test_potri_residual_and_dispatch():
    from gpu_matrix_inversion_tpu.models.solver import inverse
    for n in (96, 320):
        a = spd_matrix(n, seed=30 + n)
        inv, ok = cholesky_inverse(a)
        assert bool(ok)
        assert relative_residual(a, np.asarray(inv)) < 1e-5
        inv2, ok2 = inverse(a, method="cholesky")
        assert bool(ok2)
        np.testing.assert_array_equal(np.asarray(inv), np.asarray(inv2))


def test_potri_batched():
    batch = np.stack([spd_matrix(64, seed=40 + i) for i in range(3)])
    inv, ok = cholesky_inverse(batch)
    assert np.all(np.asarray(ok))
    for i in range(3):
        assert relative_residual(batch[i], np.asarray(inv)[i]) < 1e-5


def test_slogdet_matches_numpy():
    from gpu_matrix_inversion_tpu.ops.lu import det, slogdet
    for n, seed in ((32, 1), (100, 2), (300, 3)):
        a = hollow_random_matrix(n, seed=seed, dtype=np.float64)
        sign, logabs, ok = slogdet(a)
        s_np, l_np = np.linalg.slogdet(a)
        assert bool(ok)
        assert float(sign) == pytest.approx(s_np)
        assert float(logabs) == pytest.approx(l_np, rel=1e-10)
    # fp32 through the blocked factor (n >= 256 route).
    a = hollow_random_matrix(384, seed=4)
    sign, logabs, ok = slogdet(a)
    s_np, l_np = np.linalg.slogdet(a.astype(np.float64))
    assert bool(ok) and float(sign) == pytest.approx(s_np)
    assert float(logabs) == pytest.approx(l_np, rel=1e-4)
    d, okd = det(np.asarray([[2.0, 0.0], [0.0, 3.0]], np.float32))
    assert bool(okd) and float(d) == pytest.approx(6.0)


def test_slogdet_singular_and_batched():
    from gpu_matrix_inversion_tpu.ops.lu import slogdet
    sing = np.ones((16, 16), np.float32)
    sign, logabs, ok = slogdet(sing)
    assert not bool(ok)
    assert float(sign) == 0.0 and np.isneginf(float(logabs))
    batch = np.stack([hollow_random_matrix(48, seed=50 + i, dtype=np.float64)
                      for i in range(3)])
    sign, logabs, ok = slogdet(batch)
    for i in range(3):
        s_np, l_np = np.linalg.slogdet(batch[i])
        assert float(np.asarray(sign)[i]) == pytest.approx(s_np)
        assert float(np.asarray(logabs)[i]) == pytest.approx(l_np, rel=1e-10)


def test_factor_chunked_syrk_path():
    """rows >= 1024 activates the symmetric-aware chunked trailing update
    (strips skip the stale upper wedge); the factor must still match
    numpy.linalg.cholesky, including with a block size that does not
    divide the chunk width evenly."""
    n = 1200
    a = spd_matrix(n, seed=77)
    l, ok = cholesky_factor(a, block_size=64)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(l), np.linalg.cholesky(a),
                               rtol=5e-4, atol=5e-5)


def test_solve_dispatch_cholesky():
    """solve(method='cholesky') must run potrf+potrs (never forming the
    inverse) and support iterative refinement reusing the factor."""
    from gpu_matrix_inversion_tpu.models.solver import solve
    n = 160
    a = spd_matrix(n, seed=55)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    x, ok = solve(a, b, method="cholesky")
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                               rtol=5e-3, atol=5e-4)
    xr, okr = solve(a, b, method="cholesky", refine_iters=2)
    assert bool(okr)
    r0 = np.abs(a @ np.asarray(x) - b).max()
    r1 = np.abs(a @ np.asarray(xr) - b).max()
    assert r1 <= r0 * 1.5  # refinement never substantially degrades
    # vector RHS
    xv, okv = solve(a, b[:, 0], method="cholesky")
    assert bool(okv) and xv.shape == (n,)


def test_solve_cholesky_refine_ignores_upper_junk():
    """Regression (round-3 review): the refinement residual must use the
    SAME lower-triangle-symmetrized matrix the factor consumed -- with
    garbage above the diagonal, refine_iters>0 used to diverge to ~1e7
    while ok stayed True."""
    from gpu_matrix_inversion_tpu.models.solver import solve
    n = 96
    a = spd_matrix(n, seed=13)
    junk = a.copy()
    junk[np.triu_indices(n, 1)] = 444.0
    rng = np.random.default_rng(4)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    x0, ok0 = solve(a, b, method="cholesky", refine_iters=2)
    xj, okj = solve(junk, b, method="cholesky", refine_iters=2)
    assert bool(ok0) and bool(okj)
    np.testing.assert_allclose(np.asarray(xj), np.asarray(x0),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(a @ np.asarray(xj) - b).max() < 1e-3


def test_inverter_cholesky_refine_ignores_upper_junk():
    """Inverter(method='cholesky', refine_iters>0) must Newton-Schulz
    against the symmetrized matrix the factor consumed, not the caller's
    upper triangle."""
    from gpu_matrix_inversion_tpu import Inverter
    n = 80
    a = spd_matrix(n, seed=17)
    junk = a.copy()
    junk[np.triu_indices(n, 1)] = 555.0
    inv = Inverter(dtype="float32", method="cholesky", refine_iters=2)
    x0, ok0 = inv.inverse(a)
    xj, okj = inv.inverse(junk)
    assert bool(ok0) and bool(okj)
    np.testing.assert_allclose(np.asarray(xj), np.asarray(x0),
                               rtol=1e-5, atol=1e-7)
    assert relative_residual(a, np.asarray(xj)) < 1e-6
