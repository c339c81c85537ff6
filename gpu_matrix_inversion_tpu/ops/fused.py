"""Fused Pallas kernel (Triton route): whole-matrix Gauss-Jordan per program.

The reference's dominant overhead is its host loop: the OpenCL code
enqueues 5 kernels and pays 3 ``commandQueue.finish()`` host syncs per
iteration, N iterations per inversion (``FP32_bench.cpp:342-405``;
SURVEY.md section 3.1). Here one Triton program holds a whole padded
``[A | I]`` system as block values in registers and runs every pivot step
inside ONE kernel: no launches, no host syncs and no device-memory round
trips between steps. Plain XLA, by contrast, runs each of the m dependent
steps as a full pass over the whole batch in device memory.

Design:

- one program per system, on a grid over the batch;
- the system is carried as two (m, m) block values (the A half and the
  inverse half) through ``lax.fori_loop`` -- Triton has no scratch space;
- n is padded to the next power of two (Triton blocks are powers of two)
  as ``blockdiag(A, I)``, whose inverse is ``blockdiag(inv(A), I)``;
- pivoting is swap-free: a used-row mask replaces row exchanges (picking
  the max-|value| row among unused rows is the same pivot sequence as
  partial pivoting with exchanges), the pivot is one int32 argmax, and the
  caller restores row order with one gather by the emitted positions
  (contrast the reference's workgroup tree reduction + serial final scan,
  FP32.cpp:68-142).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpu_matrix_inversion_tpu.utils.platform import (compiled_kernels,
                                                     platform_of)

# Largest n the kernel serves. One program carries 2 * m^2 fp32 values, 128 KB
# at m = 128. On an H100 (batch 1024, fp32) the kernel still compiles at
# m = 256, but takes 208-291 ms per batch there against 56 ms for the vmapped
# blocked path, so larger orders go to that path.
FUSED_MAX_N = 128

# Smallest padded order: keeps every block at least one warp wide.
_MIN_M = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _padded_order(n: int) -> int:
    return max(pl.next_power_of_2(n), _MIN_M)


def _num_warps(m: int) -> int:
    """Warps per program, from a sweep on an H100 at a batch of 4096: m=128
    is fastest at 8 warps (4, 16 and 32 are slower), m=64 at 2 and m=32 at
    1."""
    if m >= 128:
        return 8
    return 2 if m >= 64 else 1


def _gj_kernel(a_ref, inv_ref, pos_ref, ok_ref, *, m: int, pivot: bool):
    """Kernel body: swap-free Gauss-Jordan on one (m, m) system.

    Row ``p`` of the inverse half ends up holding inverse row ``r`` where
    ``pos[r] = p``; ``ok`` is 0 on an exactly zero pivot or a non-finite
    result (the reference's post-hoc identity check, FP32.cpp:814-835).
    Inputs of any float dtype compute in fp32 (bf16 is an I/O format).
    """
    f32 = jnp.float32
    rows = lax.broadcasted_iota(jnp.int32, (m,), 0)
    rows2 = lax.broadcasted_iota(jnp.int32, (m, m), 0)
    lanes2 = lax.broadcasted_iota(jnp.int32, (m, m), 1)
    zero = jnp.zeros((m, m), f32)
    # makeAugmentedMatrix (reference FP32.cpp:198-215): [A | I].
    left = a_ref[...].astype(f32)
    right = jnp.where(rows2 == lanes2, jnp.ones((m, m), f32), zero)

    def step(r, carry):
        left, right, used, pos, ok = carry
        col = jnp.sum(jnp.where(lanes2 == r, left, zero), axis=1)   # (m,)
        if pivot:
            # maxPivot/finalMaxPivot (FP32.cpp:68-142) over UNUSED rows as
            # one argmax (first index on ties, like jnp.argmax).
            cand = jnp.where(used > 0, jnp.full((m,), -1.0, f32),
                             jnp.abs(col))
            p = lax.argmax(cand, 0, jnp.int32)
        else:
            p = r
        sel = rows == p
        piv = jnp.sum(jnp.where(sel, col, jnp.zeros((m,), f32)))
        ok = ok * (piv != 0).astype(jnp.int32)
        piv_safe = jnp.where(piv == 0, jnp.ones((), f32), piv)
        sel2 = rows2 == p
        # fixRowKernel (FP32.cpp:150-164): normalize pivot row p in place.
        row_l = jnp.sum(jnp.where(sel2, left, zero), axis=0) / piv_safe
        row_r = jnp.sum(jnp.where(sel2, right, zero), axis=0) / piv_safe
        # fixColumnKernel (FP32.cpp:17-63): rank-1 eliminate all other rows
        # and deposit the normalized pivot row, one pass per half.
        f = jnp.where(sel, jnp.zeros((m,), f32), col)[:, None]
        left = jnp.where(sel2, row_l[None, :], left - f * row_l[None, :])
        right = jnp.where(sel2, row_r[None, :], right - f * row_r[None, :])
        used = jnp.where(sel, jnp.ones((m,), f32), used)
        pos = jnp.where(rows == r, p, pos)
        return left, right, used, pos, ok

    init = (left, right, jnp.zeros((m,), f32), rows, jnp.int32(1))
    _, right, _, pos, ok = lax.fori_loop(jnp.int32(0), jnp.int32(m), step,
                                         init)
    # Finite check: 0*x sums to 0 iff every element is finite.
    probe = jnp.sum(right * zero)
    inv_ref[...] = right.astype(inv_ref.dtype)
    pos_ref[...] = pos
    ok_ref[...] = ok * (probe == 0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("pivot", "interpret"))
def _fused_batched(a, *, pivot: bool, interpret: bool = False):
    """(B, n, n) -> (inverse (B, n, n), ok (B,)) with one program per
    system."""
    bsz, n, _ = a.shape
    m = _padded_order(n)
    if m != n:
        # Pad to blockdiag(A, I): padded rows are zero in the real columns,
        # so they never win a pivot against a nonsingular A.
        pad = jnp.broadcast_to(jnp.eye(m, dtype=a.dtype), (bsz, m, m))
        a = pad.at[:, :n, :n].set(a)
    kernel = functools.partial(_gj_kernel, m=m, pivot=pivot)
    inv, pos, ok = pl.pallas_call(
        kernel,
        grid=(bsz,),
        in_specs=[pl.BlockSpec((None, m, m), lambda i: (i, 0, 0))],
        out_specs=(
            pl.BlockSpec((None, m, m), lambda i: (i, 0, 0)),
            pl.BlockSpec((None, m), lambda i: (i, 0)),
            pl.BlockSpec((None,), lambda i: (i,)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((bsz, m, m), a.dtype),
            jax.ShapeDtypeStruct((bsz, m), jnp.int32),
            jax.ShapeDtypeStruct((bsz,), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(m), num_stages=1),
        interpret=interpret,
        name="gauss_jordan_fused",
    )(a)
    # Undo the logical permutation: inverse row r is at physical row pos[r].
    inv = jnp.take_along_axis(inv, pos[:, :, None], axis=1)
    return inv[:, :n, :n], ok > 0


def fused_supported(a) -> bool:
    """Whether the fused kernel serves this dtype and order."""
    return (a.dtype in (jnp.float32, jnp.bfloat16)
            and a.shape[-1] <= FUSED_MAX_N)


def fused_inverse(a: jax.Array, *, pivot: bool = True,
                  interpret: bool = False):
    """Invert ``(..., n, n)`` fp32/bf16 matrices with the fused kernel.

    Mirrors the reference's FP32 pivoted Gauss-Jordan entry point
    (``matrix_inversion_FP32.cpp:12``, kernel chain :17-226) with the whole
    ``[A | I]`` system held by one program and the r-loop inside ONE kernel
    -- versus the reference's 5 kernel launches + 3 host syncs per
    iteration (``FP32_bench.cpp:342-405``). ``pivot=False`` is the
    ``matrix_inversion_no_pivots.cpp:10`` variant.

    The kernel compiles for CUDA devices; ``interpret=True`` runs it in the
    Pallas interpreter instead (CPU tests). Returns ``(inverse, ok)``.
    Raises ``NotImplementedError`` for dtypes or sizes the kernel does not
    serve, and ``RuntimeError`` off CUDA without ``interpret=True``.
    """
    a = jnp.asarray(a)
    if a.dtype not in (jnp.float32, jnp.bfloat16):
        raise NotImplementedError(
            f"fused kernel serves fp32/bf16; got {a.dtype}")
    n = a.shape[-1]
    if n > FUSED_MAX_N:
        raise NotImplementedError(
            f"n={n} exceeds the fused kernel's reach ({FUSED_MAX_N}); "
            "use the blocked path")
    if not interpret and not compiled_kernels(platform_of(a)):
        raise RuntimeError(
            "the fused kernel compiles for CUDA devices only; got platform "
            f"{platform_of(a)!r} (pass interpret=True to run it in the "
            "Pallas interpreter)")
    batch_shape = a.shape[:-2]
    a3 = a.reshape((-1,) + a.shape[-2:])
    inv, ok = _fused_batched(a3, pivot=pivot, interpret=interpret)
    return inv.reshape(a.shape), ok.reshape(batch_shape)
