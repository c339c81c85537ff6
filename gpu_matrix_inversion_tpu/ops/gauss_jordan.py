"""Pure-jnp Gauss-Jordan inversion: the executable spec of the reference.

Reference semantics reproduced here (see SURVEY.md section 2, "The kernel set"):
per iteration ``r = 0..N-1`` over the augmented ``[A|I]`` system the reference
launches five OpenCL kernels from the host
(``matrix_inversion_FP32.cpp:622-705``):

- ``maxPivotKernel`` + ``finalMaxPivotKernel``: partial-pivot argmax of
  ``abs(col r)`` restricted to rows >= r  (FP32.cpp:68-142)
- ``pivotElementsKernel``: swap row r with the argmax row   (FP32.cpp:171-192)
- ``fixRowKernel``: normalize row r by the pivot            (FP32.cpp:150-164)
- ``fixColumnKernel``: rank-1 eliminate all other rows      (FP32.cpp:17-63)

Here the whole r-loop lives inside one ``jax.lax.fori_loop`` under ``jit``
(one compiled program, zero host round-trips -- the reference pays 3 host
syncs per iteration, SURVEY.md section 3.1), with data-dependent pivoting
expressed as ``dynamic_slice`` / ``where`` rather than real branches.

The no-pivot variant mirrors ``matrix_inversion_no_pivots.cpp`` (assumes a
nonzero diagonal; reference kernels ``findCrr`` / ``copyCirColumn``,
no_pivots.cpp:39-54).

Singularity contract: the reference detects a singular matrix only post-hoc
(zero pivot -> division by zero -> NaN row -> exact identity check fails ->
empty vector, FP32.cpp:814-835). JAX cannot return dynamic shapes, so the
functional core returns ``(inverse, ok)`` where ``ok`` is False iff a pivot
was exactly zero or the result is non-finite; the flat-vector API layer maps
``ok == False`` to the reference's empty-vector return.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# int32 zero for dynamic_slice index tuples (indices must share one dtype,
# including under x64).
_i0 = np.int32(0)


def _augment(a: jax.Array) -> jax.Array:
    """Build the augmented system ``[A|I]`` (reference makeAugmentedMatrix,
    matrix_inversion_FP32.cpp:198-215)."""
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)
    return jnp.concatenate([a, eye], axis=-1)


def _gj_step(r: jax.Array, carry, *, n: int, pivot: bool):
    """One Gauss-Jordan iteration on the augmented (n, 2n) system."""
    aug, ok = carry
    r = r.astype(jnp.int32)
    two_n = 2 * n

    # Pivot column r as an (n,) vector.
    col = lax.dynamic_slice(aug, (_i0, r), (n, 1))[:, 0]
    rows = lax.broadcasted_iota(jnp.int32, (n,), 0)

    if pivot:
        # Partial pivot: argmax of |col| over rows >= r
        # (reference maxPivot/finalMaxPivot, FP32.cpp:68-142).
        cand = jnp.where(rows >= r, jnp.abs(col), jnp.full_like(col, -1))
        p = jnp.argmax(cand).astype(jnp.int32)
    else:
        # No-pivot variant uses the diagonal directly
        # (reference findCrr, no_pivots.cpp:39-44).
        p = r

    piv = lax.dynamic_slice(col, (p,), (1,))[0]
    ok = jnp.logical_and(ok, piv != 0)
    piv_safe = jnp.where(piv == 0, jnp.ones_like(piv), piv)

    row_r = lax.dynamic_slice(aug, (r, _i0), (1, two_n))
    row_p = lax.dynamic_slice(aug, (p, _i0), (1, two_n))
    if pivot:
        # Swap rows r and p (reference pivotElementsKernel, FP32.cpp:171-192).
        aug = lax.dynamic_update_slice(aug, row_r, (p, _i0))
        aug = lax.dynamic_update_slice(aug, row_p, (r, _i0))
        # Pivot column after the swap: only entries r and p moved.
        col_at_r = lax.dynamic_slice(col, (r,), (1,))[0]
        col = jnp.where(rows == r, piv, jnp.where(rows == p, col_at_r, col))

    # Normalize the pivot row (reference fixRowKernel, FP32.cpp:150-164).
    norm_row = row_p / piv_safe if pivot else row_r / piv_safe  # (1, 2n)

    # Rank-1 eliminate every other row (reference fixColumnKernel,
    # FP32.cpp:17-63): aug[i, :] -= col[i] * norm_row for all i != r.
    factors = jnp.where(rows == r, jnp.zeros_like(col), col)[:, None]  # (n, 1)
    aug = aug - factors * norm_row
    aug = lax.dynamic_update_slice(aug, norm_row, (r, _i0))
    return aug, ok


def _gauss_jordan_aug(a: jax.Array, *, pivot: bool):
    n = a.shape[-1]
    aug = _augment(a)
    step = functools.partial(_gj_step, n=n, pivot=pivot)
    aug, ok = lax.fori_loop(0, n, step, (aug, jnp.bool_(True)))
    inv = aug[:, n:]
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(inv)))
    return inv, ok


@functools.partial(jax.jit, static_argnames=("pivot",))
def gauss_jordan_inverse(a: jax.Array, *, pivot: bool = True):
    """Invert ``a`` by Gauss-Jordan elimination on the augmented ``[A|I]``.

    Args:
      a: ``(..., n, n)`` array (float32 or float64). Leading axes are batched.
      pivot: partial pivoting on/off (reference FP32/FP64 vs no_pivots paths).

    Returns:
      ``(inverse, ok)`` where ``inverse`` has the shape/dtype of ``a`` and
      ``ok`` is a boolean with the batch shape -- False where a zero pivot was
      hit or the result is non-finite (the functional analog of the
      reference's empty-vector-on-singular contract, FP32.cpp:814-835).
    """
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got {a.shape}")
    fn = functools.partial(_gauss_jordan_aug, pivot=pivot)
    for _ in range(a.ndim - 2):
        fn = jax.vmap(fn)
    return fn(a)


def gauss_jordan_inverse_no_pivot(a: jax.Array):
    """No-pivot Gauss-Jordan (reference matrix_inversion_no_pivots.cpp:10).

    Assumes a nonzero diagonal throughout elimination; returns ``(inv, ok)``.
    """
    return gauss_jordan_inverse(a, pivot=False)
