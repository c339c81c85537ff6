"""Pivot-sequence oracle tests.

These pin the semantics of the swap-free panel factorization that the
blocked and sharded paths use (``ops/blocked._factor_panel``) against LAPACK
(scipy) and the plain jnp search:

- exact agreement with LAPACK's getrf pivot order (reference maxPivot
  semantics, matrix_inversion_FP32.cpp:68-142), with prior pivot rows
  excluded by the used mask;
- on exact ties the smallest row index wins, and any separation at all
  follows the true max (the search is a full-precision argmax);
- the composite transform matches the block-inverse algebra it stands for,
  and a panel with no usable pivot trips the ok flag.
"""

import numpy as np
import pytest
import scipy.linalg

import jax.numpy as jnp

from gpu_matrix_inversion_tpu.ops.blocked import (_factor_panel,
                                                  _panel_pivots_logical,
                                                  _panel_width)
from gpu_matrix_inversion_tpu.ops.lu import lu_factor


def lapack_pivot_rows(a: np.ndarray) -> np.ndarray:
    """Original-row pivot sequence of LAPACK getrf (ipiv unrolled)."""
    m = a.shape[0]
    _, piv = scipy.linalg.lu_factor(a)
    cur = np.arange(m)
    out = []
    for i in range(min(a.shape)):
        j = piv[i]
        out.append(cur[j])
        cur[i], cur[j] = cur[j], cur[i]
    return np.asarray(out)


@pytest.mark.parametrize("n", [16, 37, 96])
def test_lu_perm_matches_scipy(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    lu, perm, ok = lu_factor(a)
    assert bool(ok)
    m_scipy, piv = scipy.linalg.lu_factor(a)
    cur = np.arange(n)
    for i in range(n):
        j = piv[i]
        cur[i], cur[j] = cur[j], cur[i]
    np.testing.assert_array_equal(np.asarray(perm), cur)
    # and the packed factor itself agrees row-for-row
    np.testing.assert_allclose(np.asarray(lu), m_scipy, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("m,b", [(256, 32), (512, 64)])
def test_logical_panel_matches_lapack(m, b):
    """The swap-free jnp panel search must emit getrf's pivot order on a
    rectangular (m, b) panel (float64: no truncation, no ties)."""
    rng = np.random.default_rng(m + b)
    strip = rng.standard_normal((m, b))
    used = jnp.zeros((m, 1), jnp.float64)
    pivrows, _, ok, _ = _panel_pivots_logical(
        jnp.asarray(strip), used, jnp.int32(0), m=m, b=b, pivot=True)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(pivrows),
                                  lapack_pivot_rows(strip))


@pytest.mark.parametrize("m,b", [(256, 32), (512, 64)])
def test_kernel_pivots_match_logical(m, b):
    """The composite panel factorization picks exactly the logical search's
    pivots -- which are LAPACK's on the rows the used mask leaves -- and
    never a used row."""
    rng = np.random.default_rng(7 * m + b)
    mag = np.exp(rng.uniform(0.0, 8.0, (m, b)))
    strip = (mag * rng.choice([-1.0, 1.0], (m, b))).astype(np.float32)
    used = jnp.zeros((m, 1), jnp.float32).at[:8].set(1.0)  # exclude rows 0-7

    got, _, ok = _factor_panel(jnp.asarray(strip), jnp.int32(0), used, m=m,
                               b=b, pivot=True)
    want, _, _, _ = _panel_pivots_logical(
        jnp.asarray(strip), used, jnp.int32(0), m=m, b=b, pivot=True)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not np.any(np.isin(np.asarray(got), np.arange(8)))  # used mask
    np.testing.assert_array_equal(
        np.asarray(got), 8 + lapack_pivot_rows(strip[8:].astype(np.float64)))


@pytest.mark.parametrize("m,b", [(256, 32), (384, 64)])
def test_panel_factor_composite_matches_algebra(m, b):
    """The panel's transformed selector T E must match the block-inverse
    algebra of its composite C = T E - E = (E - L_masked) @ D^-1 - E, and
    applying it as X * (1 - rowmask) + (T E) @ X[pivrows] must eliminate
    every other row and deposit D^-1 @ D at the pivot rows."""
    rng = np.random.default_rng(13 * m + b)
    strip = rng.standard_normal((m, b)).astype(np.float32)
    used = jnp.zeros((m, 1), jnp.float32).at[:8].set(1.0)

    pivrows, te_t, ok = _factor_panel(jnp.asarray(strip), jnp.int32(0),
                                      used, m=m, b=b, pivot=True)
    assert bool(ok)
    want, _, _, _ = _panel_pivots_logical(jnp.asarray(strip), used,
                                          jnp.int32(0), m=m, b=b, pivot=True)
    np.testing.assert_array_equal(np.asarray(pivrows), np.asarray(want))

    pr = np.asarray(pivrows)
    dblk = strip[pr].astype(np.float64)
    dinv = np.linalg.inv(dblk)
    psel = np.zeros((m, b)); psel[pr, np.arange(b)] = 1.0
    rowmask = psel.sum(1, keepdims=True)
    l_masked = strip.astype(np.float64) * (1 - rowmask)
    te_ref = (psel - l_masked) @ dinv
    te = np.asarray(te_t, np.float64).T
    np.testing.assert_allclose(te, te_ref, rtol=2e-3,
                               atol=2e-4 * np.abs(te_ref).max())
    np.testing.assert_allclose(te[pr], dinv, rtol=1e-4,
                               atol=1e-5 * np.abs(dinv).max())

    # Functional check: the update zeroes every non-pivot row of the strip
    # and leaves the identity at the pivot rows.
    x = strip.astype(np.float64)
    x_new = x * (1 - rowmask) + te @ x[pr]
    np.testing.assert_allclose(x_new[pr], np.eye(b), atol=1e-4)
    mask = np.ones(m, bool); mask[pr] = False
    np.testing.assert_allclose(x_new[mask], 0.0, atol=1e-4)


def test_panel_factor_flags_zero_pivot():
    """A strip whose unused rows are all zero in some column must trip the
    panel's zero-pivot flag (the singular detector, reference
    identity-check tier FP32.cpp:814-835)."""
    m, b = 256, 16
    rng = np.random.default_rng(5)
    strip = rng.standard_normal((m, b)).astype(np.float32)
    strip[8:, 3] = 0.0          # column 3 has no pivot among unused rows
    used = jnp.zeros((m, 1), jnp.float32).at[:8].set(1.0)
    _, _, ok = _factor_panel(jnp.asarray(strip), jnp.int32(0), used,
                             m=m, b=b, pivot=True)
    assert not bool(ok)


def test_kernel_near_tie_valid_and_first_index():
    """Exact tie: the SMALLER row index wins. Any separation, however
    small, follows the true max (full-precision argmax, no index packing
    into the value's low bits)."""
    m, b = 256, 32
    rng = np.random.default_rng(3)
    strip = rng.uniform(0.1, 0.9, (m, b)).astype(np.float32)
    v = np.float32(1000.0)
    strip[200, 0] = v
    strip[50, 0] = -v
    used = jnp.zeros((m, 1), jnp.float32)
    got, _, _ = _factor_panel(jnp.asarray(strip), jnp.int32(0), used, m=m,
                              b=b, pivot=True)
    assert int(np.asarray(got)[0]) == 50  # tie -> first (smallest) row

    strip[200, 0] = np.nextafter(v, np.float32(np.inf))  # one ulp above
    got, _, _ = _factor_panel(jnp.asarray(strip), jnp.int32(0), used, m=m,
                              b=b, pivot=True)
    assert int(np.asarray(got)[0]) == 200


def test_kernel_wide_index_mask():
    """m past 16384: pivot indices far down the matrix survive intact."""
    m, b = 16448, 32
    rng = np.random.default_rng(11)
    strip = np.zeros((m, b), np.float32)
    strip[:64] = rng.uniform(0.1, 1.0, (64, b)).astype(np.float32)
    strip[16400] = np.linspace(100.0, 200.0, b).astype(np.float32)
    used = jnp.zeros((m, 1), jnp.float32)
    got, _, _ = _factor_panel(jnp.asarray(strip), jnp.int32(0), used, m=m,
                              b=b, pivot=True)
    assert int(np.asarray(got)[0]) == 16400
    want, _, _, _ = _panel_pivots_logical(
        jnp.asarray(strip), used, jnp.int32(0), m=m, b=b, pivot=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_block_param_boundaries():
    """The panel width is the requested width, capped by the 8-rounded
    order, for every dtype and size (no device-memory ladder)."""
    assert _panel_width(4096, 128) == 128
    assert _panel_width(16384, 128) == 128
    assert _panel_width(65537, 128) == 128
    assert _panel_width(100, 256) == 104
    assert _panel_width(3, 128) == 8
    assert _panel_width(4096, 40) == 40
