"""Precision refinement: FP32 factorizations to FP64-level residuals.

Besides the native FP64 paths, the reference's FP64 results can be reached
by *mixed precision*: factor/invert in FP32, then tighten the residual with

- **Newton-Schulz iteration** ``X <- X + X @ (I - A @ X)``: each step squares
  the residual (quadratic convergence), costs 2 GEMMs.
- **Iterative refinement** for solves: residual in higher precision, cheap
  LU re-solve for the correction (the classic LAPACK sgesv/dsgesv scheme).

With ``residual_dtype=float64`` (requires x64) the refined FP32 inverse
reaches FP64-level residuals on the ill-conditioned test set (BASELINE.md
configs[3]).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("iters", "residual_dtype"))
def newton_schulz_refine(a: jax.Array, x: jax.Array, *, iters: int = 2,
                         residual_dtype=None):
    """Refine an approximate inverse ``x`` of ``a`` by Newton-Schulz steps.

    Returns the refined inverse in ``residual_dtype`` (or ``x.dtype``).
    """
    rd = jnp.dtype(residual_dtype) if residual_dtype is not None else x.dtype
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=rd)
    a_h = a.astype(rd)
    # MISCOMPILE GUARD: when the approximate inverse is consumed ONLY by
    # this refine (its array never escaping the jit program), a compiler
    # rewrite that restructured the producer's gather/slice/select chain
    # into the refine GEMMs once degraded the refined residual by orders of
    # magnitude on the n=1950 seed=1950 hollow input (DESIGN.md section 8);
    # returning the intermediate from the same program, or this barrier,
    # restored the exact result. The barrier only pins a fusion boundary;
    # it costs nothing against the O(n^3) GEMMs. chip_smoke.py checks that
    # input on the card.
    x = jax.lax.optimization_barrier(x)
    x_h = x.astype(rd)
    # The residual GEMM must be exact-f32 (HIGHEST: a default-precision f32
    # product may run in reduced precision, e.g. TF32 on a GPU); the
    # correction GEMM X @ R can run one tier down -- its error is relative
    # to ||X||*||R|| ~ residual-sized, far below the step's own quadratic
    # convergence floor.
    corr_prec = (jax.lax.Precision.HIGH if rd == jnp.float32
                 else jax.lax.Precision.HIGHEST)
    for _ in range(iters):
        r = eye - jnp.matmul(a_h, x_h, preferred_element_type=rd,
                        precision=jax.lax.Precision.HIGHEST)
        x_h = x_h + jnp.matmul(x_h, r, preferred_element_type=rd,
                        precision=corr_prec)
    return x_h


@functools.partial(jax.jit, static_argnames=("iters", "residual_dtype"))
def refine_solve(a: jax.Array, b: jax.Array, x: jax.Array, lu: jax.Array,
                 perm: jax.Array, *, iters: int = 3, residual_dtype=None):
    """Iterative refinement of a solve ``A x = b`` given the FP32 LU factors.

    The residual is computed in ``residual_dtype`` (default: x.dtype); the
    correction re-uses the cheap FP32 factorization (LAPACK dsgesv pattern).
    """
    from gpu_matrix_inversion_tpu.ops.lu import lu_solve

    rd = jnp.dtype(residual_dtype) if residual_dtype is not None else x.dtype
    b_h = b.astype(rd)
    a_h = a.astype(rd)
    # Same dead-intermediate miscompile guard as
    # newton_schulz_refine: the initial solve and each correction reach
    # this loop through gather chains (permutation rows in lu_solve).
    x_h = jax.lax.optimization_barrier(x).astype(rd)
    for _ in range(iters):
        r = b_h - jnp.matmul(a_h, x_h, preferred_element_type=rd,
                        precision=jax.lax.Precision.HIGHEST)
        d, _ = lu_solve(lu, perm, r.astype(x.dtype))
        x_h = x_h + jax.lax.optimization_barrier(d).astype(rd)
    return x_h


def lu_inverse_refined(a: jax.Array, *, iters: int = 2, residual_dtype=None):
    """FP32 LU inverse + Newton-Schulz refinement; returns ``(inv, ok)``.

    The BASELINE.md configs[3] path: FP32 factor, FP64-level residual.
    """
    from gpu_matrix_inversion_tpu.ops.lu import lu_inverse

    x0, ok = lu_inverse(a.astype(jnp.float32))
    x = newton_schulz_refine(a, x0, iters=iters, residual_dtype=residual_dtype)
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(x), axis=(-2, -1)))
    return x, ok
