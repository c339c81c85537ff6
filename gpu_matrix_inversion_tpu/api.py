"""Public flat-vector API: parity with the reference's C++ surface.

Reference surface (``headers.h:7-16``, ``Matlab/mat_inv_32.h:4``):

- ``matrix_inversion_FP32(vector<float>, int)  -> vector<float>``
- ``matrix_inversion_FP64(vector<double>, int) -> vector<double>``
- ``matrix_inversion_no_pivots(vector<double>, int) -> vector<double>``
- ``FP32_bench / FP64_bench / no_pivots_bench   -> Res`` (timings + inverse)
- ``matrix_inv_32`` (the shipped MATLAB-facing library entry point)
- ``matrix_multiply(inverse, A, N) -> double``  (residual check)

Contract: flat row-major vector + matrix order in; inverse as flat vector
out; **empty vector** on any failure -- non-square input, order <= 0, or a
singular matrix (``matrix_inversion_FP32.cpp:11-12``, ``README.md:53-54``,
``mat_inv_32.cpp:206-215``). Deliberate deviation: the reference also maps
*internal* errors (cl_int throws) to the empty vector
(``mat_inv_32.cpp:391-394``); here internal failures raise -- swallowing
infrastructure errors as "singular matrix" misdiagnoses real bugs.

This module is the host-side shell; all compute routes through
:mod:`gpu_matrix_inversion_tpu.models.solver` onto the device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import jax
import jax.numpy as jnp

from gpu_matrix_inversion_tpu.models import solver
from gpu_matrix_inversion_tpu.utils.res import Res, PhaseTimer
from gpu_matrix_inversion_tpu.utils.validation import validate_flat_matrix
from gpu_matrix_inversion_tpu.utils.residual import reference_error_metric


def _x64_scope(dtype):
    """Enable float64 semantics for the FP64 paths when not globally on."""
    if dtype == np.float64 and not jax.config.jax_enable_x64:
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def _invert_flat(flat, order: int, dtype, *, pivot: bool,
                 method: str = "auto") -> np.ndarray:
    """Shared flat-vector inversion core; returns flat inverse or empty."""
    mat = validate_flat_matrix(flat, order)
    if mat is None:
        return np.empty(0, dtype=dtype)
    with _x64_scope(dtype):
        a = jnp.asarray(mat, dtype=dtype)
        inv, ok = solver.inverse(a, method=method, pivot=pivot)
        inv = np.asarray(inv)
        ok = bool(ok)
    if not ok:
        return np.empty(0, dtype=dtype)
    return inv.reshape(-1).astype(dtype)


def matrix_inv_32(flat, order: int) -> np.ndarray:
    """The shipped product API (reference ``Matlab/mat_inv_32.h:4``):
    FP32, partial pivoting, flat row-major in/out, empty on failure."""
    return _invert_flat(flat, order, np.float32, pivot=True)


def matrix_inversion_fp32(flat, order: int, *, verbose: bool = False,
                          strict_verify: bool | None = None) -> np.ndarray:
    """Reference ``matrix_inversion_FP32()`` (headers.h:8).

    ``verbose=True`` reproduces the reference's chatty single-shot path
    (device-capability dump at startup, per-phase timing report --
    FP32.cpp:304-333, :711-723) on top of the same contract -- including
    its identity self-check (FP32.cpp:814-835), which the verbose path
    always ran; pass ``strict_verify=False`` to skip it."""
    if not verbose:
        return _invert_flat(flat, order, np.float32, pivot=True)
    import json
    from gpu_matrix_inversion_tpu.utils.profiling import (
        device_info, print_phase_report)
    print("device:", json.dumps(device_info()))
    res = _bench(flat, order, np.float32, pivot=True,
                 strict_verify=(True if strict_verify is None
                                else strict_verify))
    print_phase_report(res, order)
    if not res.ok:
        return np.empty(0, dtype=np.float32)
    return res.inversa32


def matrix_inversion_fp64(flat, order: int) -> np.ndarray:
    """Reference ``matrix_inversion_FP64()`` (headers.h:9).

    FP64 runs natively wherever the device has double-precision units; the
    blocked and LU paths serve it like FP32.
    """
    return _invert_flat(flat, order, np.float64, pivot=True)


def matrix_inversion_no_pivots(flat, order: int) -> np.ndarray:
    """Reference ``matrix_inversion_no_pivots()`` (headers.h:10): FP64
    Gauss-Jordan assuming a nonzero diagonal throughout elimination."""
    return _invert_flat(flat, order, np.float64, pivot=False)


def identity_check_tolerance(order: int, dtype) -> float:
    """Default gate for the strict identity self-check.

    The reference's check is *exact* (left half == I elementwise,
    ``matrix_inversion_FP32.cpp:814-835``) because its fixColumn zeroes the
    pivot column identically; a blocked GEMM algorithm cannot promise exact
    zeros, so the promoted diagnostic gates max|A@X - I| at a few orders
    above the rounding floor. Growth is taken LINEAR in n (elimination
    error compounds with the step count times a growth factor): the r3
    power-size sweep measured max|AX-I| on refined hollow inputs at
    1.3e-3 (n=4096) -> 1.9e-2 (n=12288), which a sqrt(n) gate would
    false-fail at 12288 while the normalized residual sits at 2.8e-6.
    Genuinely wrong inverses (singular/Hilbert-block inputs) land orders
    of magnitude above this line (see test_api.py).
    """
    eps = float(np.finfo(dtype).eps)
    return 1e3 * eps * float(order)


@jax.jit
def _strict_identity_error_jit(a, inv):
    n = a.shape[-1]
    prod = jnp.matmul(a, inv, preferred_element_type=a.dtype,
                      precision=jax.lax.Precision.HIGHEST)
    eye = jnp.eye(n, dtype=a.dtype)
    return jnp.max(jnp.abs(prod - eye))


def _strict_identity_error(a, inv) -> float:
    """max elementwise |A @ X - I| computed on device (HIGHEST GEMM) --
    the reference's identity self-check tier promoted to a quantitative
    diagnostic (FP32.cpp:814-835; its de-facto singular detector). The
    jitted check lives at module scope so repeated calls at one shape hit
    the jit cache instead of re-tracing per call."""
    return float(_strict_identity_error_jit(a, inv))


def _bench(flat, order: int, dtype, *, pivot: bool,
           strict_verify: bool | None = None) -> Res:
    """Shared bench core: phase-timed inversion returning a ``Res``.

    Phase mapping from the reference's slots (``FP32_bench.cpp:256-443``):
    buffers -> device transfer; compile -> trace+jit compile;
    make_augmented/pivot/row/column -> fused into total_compute (one XLA
    program replaces the reference's 5-kernel x N-iteration host loop);
    get_inverted -> readback.

    ``strict_verify`` (or env ``MATINV_STRICT_VERIFY=1``) adds the
    reference's identity self-check tier: max elementwise |A@X - I| on
    device, recorded in ``Res.identity_error`` and gating ``ok`` at
    :func:`identity_check_tolerance` -- the analog of the verbose paths
    returning {} when the reduced left half is not exactly I
    (FP32.cpp:814-835).
    """
    import os
    if strict_verify is None:
        strict_verify = os.environ.get("MATINV_STRICT_VERIFY") == "1"
    timer = PhaseTimer()
    res = Res()
    mat = validate_flat_matrix(flat, order)
    if mat is None:
        res.ok = False
        res.times = dict(timer.times, total=timer.total())
        return res
    with _x64_scope(dtype):
        with timer.span("buffers"):
            a = jax.device_put(jnp.asarray(mat, dtype=dtype))
            a.block_until_ready()
        with timer.span("compile"):
            # Warm-up on the same shape triggers trace + XLA compile.
            inv, ok = solver.inverse(a, pivot=pivot)
            jax.block_until_ready((inv, ok))
        with timer.span("total_compute"):
            inv, ok = solver.inverse(a, pivot=pivot)
            jax.block_until_ready((inv, ok))
        if strict_verify:
            with timer.span("identity_check"):
                res.identity_error = _strict_identity_error(a, inv)
            ok = bool(ok) and (res.identity_error
                               <= identity_check_tolerance(order, dtype))
        with timer.span("get_inverted"):
            out = np.asarray(inv).reshape(-1)
            res.ok = bool(ok)
    if not res.ok:
        out = np.empty(0, dtype=dtype)
    if dtype == np.float64:
        res.inversa64 = out.astype(np.float64)
    else:
        res.inversa32 = out.astype(np.float32)
    res.times = dict(timer.times, total=timer.total())
    return res


def fp32_bench(flat, order: int, *, strict_verify: bool | None = None) -> Res:
    """Reference ``FP32_bench()`` (headers.h:13, FP32_bench.cpp:11)."""
    return _bench(flat, order, np.float32, pivot=True,
                  strict_verify=strict_verify)


def fp64_bench(flat, order: int, *, strict_verify: bool | None = None) -> Res:
    """Reference ``FP64_bench()`` (headers.h:14, FP64_bench.cpp:11)."""
    return _bench(flat, order, np.float64, pivot=True,
                  strict_verify=strict_verify)


def no_pivots_bench(flat, order: int, *,
                    strict_verify: bool | None = None) -> Res:
    """Reference ``matrix_inversion_no_pivots_bench()`` (headers.h:15).

    (The reference declares this but ships an empty ``no_pivot_bench.cpp``;
    SURVEY.md C10. Implemented for real here.) The crr/copy Res slots of
    the orphaned no-pivot benchmark (``..._no_pivots_benchmark.cpp:492-495``)
    are zero-filled: both stages are fused into the factorization here
    (see ``Res.times_vector``).
    """
    res = _bench(flat, order, np.float64, pivot=False,
                 strict_verify=strict_verify)
    res.times.setdefault("crr", 0.0)
    res.times.setdefault("copy", 0.0)
    return res


def matrix_multiply(inverse_flat, a_flat, order: int) -> float:
    """Verification GEMM + residual (reference ``matrix_multiply.cpp:15``):
    computes ``sqrt(N) - ||A_inv @ A||_F`` with the product on-device."""
    inv = validate_flat_matrix(inverse_flat, order)
    a = validate_flat_matrix(a_flat, order)
    if inv is None or a is None:
        return float("nan")
    # The reference's verification GEMM runs in double (simpleMultiply,
    # matrix_multiply.cpp:17-36); auto-enable x64 for fp64 inputs like the
    # fp64 inversion paths do (ADVICE r1).
    dtype = (np.float64 if np.asarray(inv).dtype == np.float64
             else np.float32)
    with _x64_scope(dtype):
        dt = jnp.dtype(dtype)
        prod = jnp.matmul(jnp.asarray(inv, dt), jnp.asarray(a, dt),
                          preferred_element_type=dt,
                          precision=jax.lax.Precision.HIGHEST)
        prod = np.asarray(prod)
    return reference_error_metric(np.eye(order), prod)
