"""Algorithm dispatch: choose the right inversion path for size/batch/dtype.

This is the runtime replacement for the reference's compile-time variant
selection (``#define FP32 / PIVOTS`` in ``main_file.cpp:14-18``): one entry
point that routes to

- ``spec``     pure-jnp Gauss-Jordan (executable spec; any backend)
- ``fused``    one fused Pallas kernel per system, whole [A|I] held by one
               program (small N and batched workloads; CUDA devices)
- ``blocked``  blocked Gauss-Jordan with rank-k GEMM trailing updates
               (large N)
- ``lu``       LU factorization + getri-style triangular solves
- ``ns``       Newton-Schulz iteration (pivot-free, pure GEMMs; well-
               conditioned matrices and warm starts)
- ``cholesky`` potrf/potri for symmetric positive-definite input: half the
               LU MACs and no pivot-search serial chain at all
- ``sharded``  panel-sharded multi-device path over a device mesh

``auto`` picks by shape, dtype and platform (``_resolve``): batched or small
single fp32/bf16 matrices go to ``fused`` on CUDA devices and to ``spec``
elsewhere, large single matrices to ``blocked``, and single matrices too
large for one device's memory to ``sharded`` when a mesh is available.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from gpu_matrix_inversion_tpu.ops.gauss_jordan import gauss_jordan_inverse
from gpu_matrix_inversion_tpu.ops.fused import fused_supported
from gpu_matrix_inversion_tpu.utils.platform import (compiled_kernels,
                                                     platform_of)

METHODS = ("auto", "spec", "fused", "blocked", "lu", "cholesky", "sharded",
           "ns")

_BLOCKED_MIN_N = 512


def sharded_auto_min_n(bytes_limit: int, itemsize: int = 4) -> int:
    """Smallest order whose slot-layout working set -- the (m, 2m) system,
    2 * itemsize * m^2 bytes (8 m^2 in fp32) -- takes at least half of a
    device's ``bytes_limit``; from there on ``auto`` moves single matrices
    to the mesh. The other half is the headroom for the input, the output
    and the Newton polish's temporaries."""
    per = 4 * itemsize            # 2 * itemsize * m^2 >= bytes_limit / 2
    n = math.isqrt(bytes_limit // per)
    if per * n * n < bytes_limit:
        n += 1
    return n


def _device_bytes_limit(a) -> int | None:
    """Memory limit of the device ``a`` lands on (None where the runtime
    reports no memory stats, as on the CPU)."""
    devs = (a.devices() if isinstance(a, jax.Array)
            and not isinstance(a, jax.core.Tracer) else None)
    dev = next(iter(devs)) if devs else jax.devices(platform_of(a))[0]
    stats = dev.memory_stats() or {}
    return stats.get("bytes_limit")


def _mesh_available(mesh) -> bool:
    if mesh is not None:
        return True
    from gpu_matrix_inversion_tpu.parallel.mesh import (
        default_platform_devices)
    return len(default_platform_devices()) > 1


def _sharded_auto(a, mesh) -> bool:
    """Whether ``auto`` sends a single matrix to the mesh: it must not fit
    comfortably in one device's memory, and a mesh must exist."""
    if not _mesh_available(mesh):
        return False
    limit = _device_bytes_limit(a)
    if limit is None:
        return False
    # bf16 computes in fp32, so its working set is fp32-sized.
    itemsize = max(a.dtype.itemsize, 4)
    return a.shape[-1] >= sharded_auto_min_n(limit, itemsize)


def _resolve(method: str, a: jax.Array, mesh=None) -> str:
    """The route for ``method`` on this input: an explicit choice by shape,
    dtype and platform. The fused kernel runs only where it compiles (CUDA)
    and for the dtypes and orders it serves; elsewhere -- including an
    explicit ``method="fused"`` -- the plain jnp spec runs instead."""
    fused_ok = (fused_supported(a)
                and compiled_kernels(platform_of(a)))
    if method == "fused":
        return "fused" if fused_ok else "spec"
    if method != "auto":
        return method
    n = a.shape[-1]
    if a.ndim == 2 and _sharded_auto(a, mesh):
        return "sharded"
    small = fused_supported(a) and (a.ndim > 2 or n < _BLOCKED_MIN_N)
    if small:
        return "fused" if fused_ok else "spec"
    if a.dtype in (jnp.float32, jnp.bfloat16) or n >= _BLOCKED_MIN_N:
        return "blocked"
    return "spec"


def inverse(a: jax.Array, *, method: str = "auto", pivot: bool = True,
            block_size: int | None = None, mesh=None,
            precision: str | None = None) -> Tuple[jax.Array, jax.Array]:
    """Invert ``a`` (shape ``(..., n, n)``); returns ``(inverse, ok)``.

    ``ok`` is the singularity flag per the reference's empty-on-singular
    contract (SURVEY.md section 2, C10). ``method="sharded"`` runs the
    panel-sharded multi-chip path over ``mesh`` (default: all devices).
    ``precision`` applies to the blocked and sharded paths; the remaining
    methods ignore it.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    a = jnp.asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got {a.shape}")

    resolved = _resolve(method, a, mesh)

    if resolved == "sharded":
        from gpu_matrix_inversion_tpu.parallel.sharded import (
            sharded_batched_inverse, sharded_blocked_inverse)
        kwargs = {} if block_size is None else {"block_size": block_size}
        if precision is not None:
            kwargs["precision"] = precision
        if a.ndim == 2:
            return sharded_blocked_inverse(a, mesh=mesh, pivot=pivot,
                                           **kwargs)
        a3 = a.reshape((-1,) + a.shape[-2:])
        inv, ok = sharded_batched_inverse(a3, mesh=mesh, pivot=pivot,
                                          **kwargs)
        return inv.reshape(a.shape), ok.reshape(a.shape[:-2])
    if resolved == "fused":
        from gpu_matrix_inversion_tpu.ops.fused import fused_inverse
        return fused_inverse(a, pivot=pivot)
    if resolved == "blocked":
        from gpu_matrix_inversion_tpu.ops.blocked import blocked_inverse
        kwargs = {}
        if block_size is not None:
            kwargs["block_size"] = block_size
        if precision is not None:
            kwargs["precision"] = precision
        return blocked_inverse(a, pivot=pivot, **kwargs)
    if resolved == "lu":
        from gpu_matrix_inversion_tpu.ops.lu import lu_inverse, lu_inverse_fast
        # Blocked getrf/getrs for sizes where panel GEMMs pay off; the
        # spec-level loops for small systems.
        if a.shape[-1] >= 256:
            return lu_inverse_fast(a)
        return lu_inverse(a)
    if resolved == "cholesky":
        from gpu_matrix_inversion_tpu.ops.cholesky import cholesky_inverse
        return cholesky_inverse(a)
    if resolved == "ns":
        from gpu_matrix_inversion_tpu.models.newton_schulz import (
            newton_schulz_inverse)
        return newton_schulz_inverse(a)
    if a.dtype == jnp.bfloat16:
        # bf16 is an I/O format: eliminate in fp32, return bf16.
        inv, ok = gauss_jordan_inverse(a.astype(jnp.float32), pivot=pivot)
        return inv.astype(jnp.bfloat16), ok
    return gauss_jordan_inverse(a, pivot=pivot)


def solve(a: jax.Array, b: jax.Array, *, method: str = "auto",
          pivot: bool = True, block_size: int | None = None,
          mesh=None, refine_iters: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Solve ``A @ x = b``; returns ``(x, ok)``. ``b`` may be ``(..., n, k)``
    or a single right-hand side ``(..., n)``.

    For the LU method this uses forward/back substitution; other methods
    form the explicit inverse (matching the reference, which only ever
    inverts). ``refine_iters`` applies classic iterative refinement
    REUSING the factorization/inverse (LAPACK dsgesv pattern; the
    correction costs O(n^2 k) per iteration, not a re-factorization).
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b, a.dtype)
    vec = (b.ndim == a.ndim - 1)  # single RHS as a vector
    if vec:
        b = b[..., None]
    hp = jax.lax.Precision.HIGHEST

    if method == "cholesky":
        # potrf + potrs: never forms the inverse (the SPD analog of the LU
        # branch below).
        from gpu_matrix_inversion_tpu.ops.cholesky import (cholesky_factor,
                                                           cholesky_solve)
        l, ok_f = cholesky_factor(a, **({} if block_size is None
                                        else {"block_size": block_size}))
        x, ok_s = cholesky_solve(l, b)
        ok = jnp.logical_and(ok_f, ok_s)
        if refine_iters > 0:
            # The factor reads only a's lower triangle (LAPACK uplo='L');
            # the refinement residual must use the SAME symmetrized matrix
            # or a junk upper triangle silently corrupts every correction.
            low = jnp.tril(a)
            asym = low + jnp.swapaxes(jnp.tril(a, -1), -1, -2)
        for _ in range(refine_iters):
            r = b - jnp.matmul(asym, x, preferred_element_type=a.dtype,
                               precision=hp)
            dx, _ = cholesky_solve(l, r)
            x = x + dx
        if refine_iters > 0:
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(x),
                                             axis=(-2, -1)))
        if vec:
            x = x[..., 0]
        return x, ok

    lu_auto = (method == "auto" and a.shape[-1] >= _BLOCKED_MIN_N)
    if method == "lu" or lu_auto:
        # Triangular solves (getrs); blocked factor + XLA triangular-solve
        # primitive for sizes where panel GEMMs pay off.
        from gpu_matrix_inversion_tpu.ops.lu import (
            lu_factor, lu_factor_blocked, lu_solve, lu_solve_fast)
        if a.shape[-1] >= 256:
            kwargs = {} if block_size is None else {"block_size": block_size}
            lu, perm, ok_f = lu_factor_blocked(a, pivot=pivot, **kwargs)
            x, ok_s = lu_solve_fast(lu, perm, b)
        else:
            lu, perm, ok_f = lu_factor(a, pivot=pivot)
            x, ok_s = lu_solve(lu, perm, b)
        ok = jnp.logical_and(ok_f, ok_s)
        if refine_iters > 0:
            from gpu_matrix_inversion_tpu.ops.refine import refine_solve
            x = refine_solve(a, b, x, lu, perm, iters=refine_iters)
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(x),
                                             axis=(-2, -1)))
    else:
        inv, ok = inverse(a, method=method, pivot=pivot,
                          block_size=block_size, mesh=mesh)
        # Under an outer jit `inv` is a gather/select-chain intermediate
        # consumed only by the GEMMs below -- the pattern a compiler
        # dead-intermediate rewrite once corrupted (DESIGN.md section 8;
        # same guard as ops/refine.py).
        inv = jax.lax.optimization_barrier(inv)
        x = jnp.matmul(inv, b, preferred_element_type=inv.dtype,
                       precision=hp)
        for _ in range(refine_iters):
            # Correction reuses the cached inverse: one residual GEMM +
            # one apply per iteration.
            r = b - jnp.matmul(a, x, preferred_element_type=a.dtype,
                               precision=hp)
            x = x + jnp.matmul(inv, r, preferred_element_type=inv.dtype,
                               precision=hp)
        if refine_iters > 0:
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(x),
                                             axis=(-2, -1)))
    if vec:
        x = x[..., 0]
    return x, ok


class Inverter:
    """Config-driven inversion session (the reference's compile-time
    ``#define`` variant selection, main_file.cpp:14-18, as a runtime object).

    Example::

        inv = Inverter(dtype="float32", method="blocked", refine_iters=1)
        x, ok = inv.inverse(a)
    """

    def __init__(self, config=None, *, mesh=None, **overrides):
        from gpu_matrix_inversion_tpu.utils.config import InversionConfig
        if config is None:
            config = InversionConfig.from_env(**overrides)
        elif overrides:
            import dataclasses
            config = dataclasses.replace(config, **overrides)
        self.config = config.validate()
        self.mesh = mesh

    def _cast(self, a):
        return jnp.asarray(a, dtype=jnp.dtype(self.config.dtype))

    def inverse(self, a):
        cfg = self.config
        a = self._cast(a)
        x, ok = inverse(a, method=cfg.method, pivot=cfg.pivot,
                        block_size=cfg.block_size, mesh=self.mesh,
                        precision=cfg.precision)
        if cfg.refine_iters > 0:
            from gpu_matrix_inversion_tpu.ops.refine import (
                newton_schulz_refine)
            if cfg.method == "cholesky":
                # The factor consumed only the lower triangle (uplo='L');
                # refine against the same symmetrized matrix, not the
                # caller's (possibly junk) upper triangle.
                a = jnp.tril(a) + jnp.swapaxes(jnp.tril(a, -1), -1, -2)
            x = newton_schulz_refine(a, x, iters=cfg.refine_iters)
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(x),
                                             axis=(-2, -1)))
        return x, ok

    def solve(self, a, b):
        # Thread the full session config through (ADVICE r1: solve used to
        # forward only method, silently dropping pivot/block_size/mesh);
        # refinement happens inside solve(), reusing the factorization.
        cfg = self.config
        a = self._cast(a)
        return solve(a, jnp.asarray(b, a.dtype), method=cfg.method,
                     pivot=cfg.pivot, block_size=cfg.block_size,
                     mesh=self.mesh, refine_iters=cfg.refine_iters)
