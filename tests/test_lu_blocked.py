"""Tests of the blocked LU path (fast getrf/getrs/getri) against the spec
implementation and numpy."""

import jax.numpy as jnp
import numpy as np

from gpu_matrix_inversion_tpu.ops.lu import (
    lu_factor,
    lu_factor_blocked,
    lu_solve_fast,
    lu_inverse_fast,
)
from gpu_matrix_inversion_tpu.utils.generators import hollow_random_matrix
from gpu_matrix_inversion_tpu.utils.residual import relative_residual


def test_blocked_factor_reconstructs():
    n = 160  # forces padding (not a multiple of 128)
    a = hollow_random_matrix(n, seed=110, dtype=np.float64)
    lu, perm, ok = lu_factor_blocked(a, block_size=64)
    assert bool(ok)
    lu = np.asarray(lu)
    l = np.tril(lu, -1) + np.eye(n)
    u = np.triu(lu)
    np.testing.assert_allclose(l @ u, a[np.asarray(perm)], rtol=1e-9,
                               atol=1e-7)


def test_blocked_solve_matches_numpy():
    n = 256
    a = hollow_random_matrix(n, seed=111, dtype=np.float64)
    b = np.random.default_rng(0).standard_normal((n, 3))
    lu, perm, ok = lu_factor_blocked(a)
    x, ok2 = lu_solve_fast(lu, perm, b)
    assert bool(ok) and bool(ok2)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                               rtol=1e-7, atol=1e-8)


def test_blocked_inverse_fp32():
    n = 384
    a = hollow_random_matrix(n, seed=112)
    inv, ok = lu_inverse_fast(a)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_chunked_getri_matches_oneshot(monkeypatch):
    """Round-3 capacity fix: the one-shot getri solve against a full
    (n, n) identity holds tens of n^2 temporaries live and OOMs a 16 GB
    chip past n~10k; large single matrices solve the identity in column
    chunks instead. The chunked result must match the one-shot solve to
    rounding (gate shrunk, chunk non-dividing to exercise the tail)."""
    import gpu_matrix_inversion_tpu.ops.lu as L

    n = 100
    a = hollow_random_matrix(n, seed=113, dtype=np.float64)
    # Pin the solve route: single 2D matrices default to the trtri
    # composition now; this test compares the two solve variants.
    monkeypatch.setenv("MATINV_GETRI_ROUTE", "solve")
    inv_one, ok_one = lu_inverse_fast(a)
    monkeypatch.setattr(L, "GETRI_CHUNK_MIN_N", 64)
    inv_ch, ok_ch = L.lu_inverse_fast(a, chunk=32)  # 100 = 3*32 + 4 tail
    assert bool(ok_one) and bool(ok_ch)
    np.testing.assert_allclose(np.asarray(inv_ch), np.asarray(inv_one),
                               rtol=1e-12, atol=1e-12)
    # batched inputs stay on the one-shot path regardless of n
    ab = np.stack([a, a])
    invb, okb = L.lu_inverse_fast(ab)
    assert bool(np.all(np.asarray(okb)))
    np.testing.assert_allclose(np.asarray(invb[0]), np.asarray(inv_one),
                               rtol=1e-12, atol=1e-12)


def test_pallas_factor_matches_jnp_twin():
    """The blocked swap-free panel route must reproduce the unblocked
    getrf spec (``lu_factor``): identical pivot sequence and the same
    backward-error tier."""
    from gpu_matrix_inversion_tpu.ops.lu import _lu_factor_blocked_2d
    import jax.numpy as jnp

    for n, b in ((192, 64), (256, 128)):
        a = jnp.asarray(hollow_random_matrix(n, seed=300 + n))
        lu_f, perm_f, ok_f = _lu_factor_blocked_2d(a, b=b, pivot=True)
        lu_j, perm_j, ok_j = lu_factor(a)
        assert bool(ok_f) and bool(ok_j)
        np.testing.assert_array_equal(np.asarray(perm_f), np.asarray(perm_j))
        # The packed factors differ by rounding path only (blocked rank-b
        # updates vs sequential rank-1): compare backward errors, not
        # elements.
        scale = float(np.abs(np.asarray(a)).max())

        def backward(lu, perm):
            lu = np.asarray(lu, np.float64)
            l = np.tril(lu, -1) + np.eye(n)
            u = np.triu(lu)
            pa = np.asarray(a)[np.asarray(perm)].astype(np.float64)
            return np.abs(l @ u - pa).max() / scale
        err_f, err_j = backward(lu_f, perm_f), backward(lu_j, perm_j)
        assert err_f < 1e-4 and err_f < 20 * max(err_j, 1e-7)


def test_grouped_factor_matches_flat():
    """The two-level grouped getrf (internal rank-b updates confined to the
    group strip + one outer rank-gw update per group) must reproduce the
    flat per-panel loop: identical pivot sequence and the same backward
    error tier. Covers a tail group (panels % group != 0), a padded order,
    and the no-pivot variant."""
    import jax.numpy as jnp
    from gpu_matrix_inversion_tpu.ops.lu import _lu_factor_blocked_jit

    def backward(a, lu, perm):
        n = a.shape[-1]
        lu = np.asarray(lu, np.float64)
        l = np.tril(lu, -1) + np.eye(n)
        u = np.triu(lu)
        pa = np.asarray(a)[np.asarray(perm)].astype(np.float64)
        return np.abs(l @ u - pa).max() / np.abs(np.asarray(a)).max()

    for n, b, g, pivot in ((256, 32, 4, True), (300, 32, 3, True),
                           (512, 128, 2, True), (256, 32, 4, False)):
        a = np.asarray(hollow_random_matrix(n, seed=400 + n))
        if not pivot:
            # Hollow matrices have a ZERO diagonal: no-pivot LU needs a
            # diagonally dominant input to avoid a legitimate zero pivot.
            a = a + np.eye(n, dtype=a.dtype) * (np.abs(a).sum(axis=1).max())
        a = jnp.asarray(a)
        lu_g, perm_g, ok_g = _lu_factor_blocked_jit(
            a, pivot=pivot, b=b, group=g)
        lu_f, perm_f, ok_f = _lu_factor_blocked_jit(
            a, pivot=pivot, b=b, group=0)
        assert bool(ok_g) and bool(ok_f)
        np.testing.assert_array_equal(np.asarray(perm_g), np.asarray(perm_f))
        err_g, err_f = backward(a, lu_g, perm_g), backward(a, lu_f, perm_f)
        assert err_g < 1e-4 and err_g < 20 * max(err_f, 1e-7), (n, err_g,
                                                                err_f)


def test_pallas_factor_reconstructs_fp32():
    """PA = LU through the public wrapper on the grouped fp32 route,
    including a padded (non-multiple) order."""
    n = 200
    a = hollow_random_matrix(n, seed=114)
    lu, perm, ok = lu_factor_blocked(a, block_size=128)
    assert bool(ok)
    lu = np.asarray(lu, dtype=np.float64)
    l = np.tril(lu, -1) + np.eye(n)
    u = np.triu(lu)
    pa = a[np.asarray(perm)].astype(np.float64)
    scale = np.abs(a).max()
    assert np.abs(l @ u - pa).max() / scale < 5e-5


def test_blocked_lu_singular_flagged():
    a = np.ones((128, 128), dtype=np.float32)
    _, ok = lu_inverse_fast(a)
    assert not bool(ok)


def test_fast_path_batched():
    """ADVICE r1 (medium): lu_solve_fast/lu_inverse_fast must batch —
    jnp.take on a batched perm used to flat-gather and TypeError."""
    rng = np.random.default_rng(7)
    n, bsz = 64, 3
    a = np.stack([hollow_random_matrix(n, seed=200 + i, dtype=np.float64)
                  for i in range(bsz)])
    b = rng.standard_normal((bsz, n, 2)).astype(np.float64)
    lu, perm, ok = lu_factor_blocked(a, block_size=16)
    x, ok2 = lu_solve_fast(lu, perm, b)
    assert bool(np.all(np.asarray(ok))) and bool(np.all(np.asarray(ok2)))
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                               rtol=1e-7, atol=1e-8)
    inv, ok3 = lu_inverse_fast(a)
    assert bool(np.all(np.asarray(ok3)))
    np.testing.assert_allclose(np.asarray(inv), np.linalg.inv(a),
                               rtol=1e-6, atol=1e-6)


def test_trtri_lower_and_upper():
    """Blocked trtri vs a direct solve: both triangles, non-power-of-2 n
    (exercises the identity padding) and a batch axis."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import invert_triangular
    rng = np.random.default_rng(7)
    for n in (48, 200, 320):
        a = (rng.uniform(-1, 1, (n, n)).astype(np.float32) * 0.5 / np.sqrt(n)
             + np.eye(n, dtype=np.float32))
        low = np.tril(a, -1) + np.eye(n, dtype=np.float32)
        up = np.triu(a)
        li, okl = invert_triangular(low, lower=True, unit_diagonal=True, b=64)
        ui, oku = invert_triangular(up, lower=False, unit_diagonal=False, b=64)
        assert bool(okl) and bool(oku)
        assert np.abs(np.asarray(li) @ low - np.eye(n)).max() < 1e-5
        assert np.abs(np.asarray(ui) @ up - np.eye(n)).max() < 1e-5
    # Off-triangle garbage must be ignored (the packed-LU use case).
    n = 96
    junk = rng.uniform(-9, 9, (n, n)).astype(np.float32)
    low = np.tril(junk, -1) + np.eye(n, dtype=np.float32)
    li2, _ = invert_triangular(junk + np.eye(n, dtype=np.float32) - np.triu(junk),
                               lower=True, unit_diagonal=True, b=32)
    li3, _ = invert_triangular(low, lower=True, unit_diagonal=True, b=32)
    np.testing.assert_array_equal(np.asarray(li2), np.asarray(li3))


def test_trtri_batched_and_singular():
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import invert_triangular
    rng = np.random.default_rng(8)
    batch = np.stack([
        np.triu(rng.uniform(-1, 1, (64, 64)).astype(np.float32) * 0.1
                + np.eye(64, dtype=np.float32) * (i + 1))
        for i in range(3)
    ])
    inv, ok = invert_triangular(batch, lower=False, b=32)
    assert np.all(np.asarray(ok))
    err = np.abs(np.einsum("bij,bjk->bik", np.asarray(inv), batch)
                 - np.eye(64)).max()
    assert err < 1e-5
    sing = np.triu(np.ones((16, 16), np.float32))
    sing = sing * (1 - np.eye(16, dtype=np.float32))  # zero diagonal
    _, ok = invert_triangular(sing, lower=False)
    assert not bool(ok)


def test_getri_trtri_matches_solve_route():
    """The trtri-based getri (LAPACK's own composition, U^-1 L^-1 P) — the
    default single-matrix route — must agree with the identity-RHS solve
    route to fp32 residual level."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import (_lu_inverse_fast_oneshot,
                                                 _lu_inverse_trtri)
    from gpu_matrix_inversion_tpu.utils.residual import relative_residual
    for n in (96, 384):
        a = hollow_random_matrix(n, seed=300 + n)
        inv1, ok1 = _lu_inverse_trtri(a)
        inv2, ok2 = _lu_inverse_fast_oneshot(a)
        assert bool(ok1) and bool(ok2)
        assert relative_residual(a, np.asarray(inv1)) < 1e-5
        assert np.abs(np.asarray(inv1) - np.asarray(inv2)).max() < 1e-3 * (
            np.abs(np.asarray(inv2)).max())
    sing = np.ones((24, 24), dtype=np.float32)
    _, ok = _lu_inverse_trtri(sing)
    assert not bool(ok)


def test_trtri_chunked_cross_levels():
    """n=1024 with b=256 reaches a level with s=512, activating the
    triangular-aware chunked cross GEMMs (_tri_mm_chunks) -- both triangles
    must still reconstruct the identity, and the chunked result must agree
    with the unchunked bisection (b=512 keeps every level below the chunk
    gate at this size ... s=512 is the top; use the direct solve b=1024)."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import invert_triangular
    rng = np.random.default_rng(11)
    n = 1024
    a = (rng.uniform(-1, 1, (n, n)).astype(np.float32) * 0.5 / np.sqrt(n)
         + np.eye(n, dtype=np.float32))
    low = np.tril(a)
    up = np.triu(a)
    li, okl = invert_triangular(low, lower=True, unit_diagonal=False, b=256)
    ui, oku = invert_triangular(up, lower=False, unit_diagonal=False, b=256)
    assert bool(okl) and bool(oku)
    assert np.abs(np.asarray(li) @ low - np.eye(n)).max() < 1e-4
    assert np.abs(np.asarray(ui) @ up - np.eye(n)).max() < 1e-4
    # Direct-solve reference (n <= b skips the bisection entirely).
    li_ref, _ = invert_triangular(low, lower=True, unit_diagonal=False,
                                  b=1024)
    np.testing.assert_allclose(np.asarray(li), np.asarray(li_ref),
                               rtol=1e-4, atol=1e-6)


def test_getri_trtri_fp64():
    """The default trtri getri route must hold at float64 too (the factor
    takes the jnp twin; trtri/product are dtype-generic)."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import lu_inverse_fast
    a = hollow_random_matrix(200, seed=9, dtype=np.float64)
    inv, ok = lu_inverse_fast(a)
    assert bool(ok)
    err = np.abs(np.asarray(inv) @ a - np.eye(200)).max()
    assert err < 1e-11


def test_trtri_canvas_matches_stack():
    """Round-5 default: the in-place canvas assembly of the bisection
    levels (DESIGN.md 6h.2a) must be bit-identical to the stack/concat
    rebuild it replaced -- same per-pair GEMMs, same HIGHEST precision,
    only the level plumbing differs."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import _trtri_blocked_2d
    rng = np.random.default_rng(5)
    n = 300  # non-power order: exercises the identity padding too
    low = (np.tril(rng.standard_normal((n, n)).astype(np.float32))
           + 4 * np.eye(n, dtype=np.float32))
    for lower, unit in ((True, False), (False, True),
                        (True, True), (False, False)):
        t = low if lower else np.ascontiguousarray(low.T)
        a = _trtri_blocked_2d(jnp.asarray(t), lower=lower,
                              unit_diagonal=unit, b=64, canvas=True)
        s = _trtri_blocked_2d(jnp.asarray(t), lower=lower,
                              unit_diagonal=unit, b=64, canvas=False)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(s))


def test_getri_product_left_transposed():
    """Round-5 potri product (DESIGN.md 6h.2b): contracting on ``left``'s
    row axis must equal multiplying by the materialized transpose, up to
    f32 contraction-order rounding, in both 2-D and batched forms."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import _getri_product
    rng = np.random.default_rng(13)
    n = 200
    linv = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    left = rng.standard_normal((n, n)).astype(np.float32)
    r1 = np.asarray(_getri_product(jnp.asarray(left), jnp.asarray(linv),
                                   left_transposed=True))
    r2 = np.asarray(_getri_product(
        jnp.asarray(np.ascontiguousarray(left.T)), jnp.asarray(linv)))
    np.testing.assert_allclose(r1, r2, rtol=1e-5, atol=1e-3)
    bl = rng.standard_normal((3, n, n)).astype(np.float32)
    blinv = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    blinv = np.repeat(blinv[None], 3, axis=0)
    r3 = np.asarray(_getri_product(jnp.asarray(bl), jnp.asarray(blinv),
                                   left_transposed=True))
    r4 = np.asarray(_getri_product(
        jnp.asarray(np.ascontiguousarray(np.swapaxes(bl, 1, 2))),
        jnp.asarray(blinv)))
    np.testing.assert_allclose(r3, r4, rtol=1e-5, atol=1e-3)


def test_getri_product_left_triangular():
    """The 2-D double-triangular tiling (k0 = max(i0, j0)) must equal the
    column-chunked form exactly on inputs with true triangular structure
    -- the skipped tiles are exact zeros, so only GEMM association at the
    chunk boundaries differs."""
    import numpy as np
    from gpu_matrix_inversion_tpu.ops.lu import _getri_product
    rng = np.random.default_rng(29)
    n = 320  # non-multiple of both chunk sizes
    up = np.triu(rng.standard_normal((n, n))).astype(np.float32)
    lo = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    ref = np.asarray(_getri_product(jnp.asarray(up), jnp.asarray(lo)))
    new = np.asarray(_getri_product(jnp.asarray(up), jnp.asarray(lo),
                                    left_triangular=True, chunk=128,
                                    rchunk=192))
    np.testing.assert_allclose(new, ref, rtol=1e-5, atol=1e-3)
    reft = np.asarray(_getri_product(jnp.asarray(lo), jnp.asarray(lo),
                                     left_transposed=True))
    newt = np.asarray(_getri_product(jnp.asarray(lo), jnp.asarray(lo),
                                     left_transposed=True,
                                     left_triangular=True, chunk=128,
                                     rchunk=192))
    np.testing.assert_allclose(newt, reft, rtol=1e-5, atol=1e-3)
