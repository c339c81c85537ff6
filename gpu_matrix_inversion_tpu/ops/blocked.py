"""Blocked right-looking Gauss-Jordan: rank-b trailing updates as GEMMs.

The performance path for large N (BASELINE.md configs[1], 4096^2). The
reference's ``fixColumnKernel`` performs the O(N^2) rank-1 trailing update
once per iteration, N times (``matrix_inversion_FP32.cpp:17-63``) -- pure
bandwidth-bound vector work. Here the same elimination is regrouped into
N/b panel steps whose trailing update is one rank-b GEMM, turning the
algorithm compute-bound.

Per panel k (pivot columns kb .. kb+b-1):

1. *Pivot search*: a b-step swap-free Gauss-Jordan pass over the (m, b)
   strip determines the b pivot rows -- the blocked generalization of the
   reference's two-stage workgroup-partial argmax (FP32.cpp:68-142). A
   "used rows" mask replaces physical row exchanges.
2. *Logical permutation*: rows are never physically moved during
   elimination (the reference's pivotElementsKernel and a naive blocked
   equivalent both burn a full pass over the matrix per swap batch). Pivot
   rows stay in place; a cross-panel used-row mask keeps the search honest,
   and ONE gather at the very end puts the inverse rows in order.
3. *Block elimination*: the search carries an identity probe through the
   same steps, which yields the panel's composite transform C; its whole
   effect on any columns X is ``X + C @ X[pivrows]`` -- one rank-b GEMM
   that both eliminates every other row AND deposits the scaled pivot
   rows. In exact arithmetic this equals the b sequential pivoted
   eliminations (with D = the pivot-row block,
   ``C = (E - L_masked) @ D^-1 - E``).

All shapes are static across panels, so the whole inversion is one XLA
program with no dynamic shapes and no recompilation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gpu_matrix_inversion_tpu.ops.gauss_jordan import _i0
from gpu_matrix_inversion_tpu.ops.fused import _round_up

# Panel width: a starting value, not yet tuned on the card.
DEFAULT_BLOCK_SIZE = 128

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _panel_width(n: int, block_size: int) -> int:
    """Panel width b for order n: the requested width, never wider than the
    (8-rounded) matrix."""
    return min(block_size, max(_round_up(n, 8), 8))


def _default_group_size(b: int, num_panels: int | None = None) -> int:
    """Panels per composite group when the caller does not choose.

    Without ``num_panels`` (callers that size groups before the panel count
    is known: lu, sharded) the composite width is gw = group*b ~ 1536
    columns, independent of b. With it, the target is gw = 1024, and at
    m <= 8192 a group that DIVIDES the panel count is preferred, so no
    unrolled tail group follows the full ones. Wider groups push work from
    the windowed outer GEMM into the internal per-panel updates (rank-b on
    a growing (m, gw+b) window); narrower ones launch more outer GEMMs on
    short windows. These widths are starting values, not yet tuned on the
    card.
    """
    bb = min(b, 128)
    if num_panels is None:
        return max(4, 1536 // bb)
    m = num_panels * b
    target_gw = 1024
    target = max(4, target_gw // bb)
    if num_panels <= target or m > 8192:
        return target
    divisors = [g for g in range(max(4, target // 2),
                                 min(num_panels, 2 * target) + 1)
                if num_panels % g == 0]
    return min(divisors, key=lambda g: abs(g - target), default=target)


def _unroll_groups(num_groups: int) -> bool:
    """Whether the blocked driver statically unrolls its group loop.

    Default: unroll up to 16 groups (every default geometry up to 16384^2;
    jit/compile cost grows with the unroll, so pathological group counts
    keep the fori body). ``MATINV_UNROLL_GROUPS`` (0/1) overrides for A/B
    experiments."""
    import os
    env = os.environ.get("MATINV_UNROLL_GROUPS")
    if env is not None and env != "":
        return env != "0"
    return num_groups <= 16


def _panel_pivots_logical(strip: jax.Array, used: jax.Array, kb, *, m: int,
                          b: int, pivot: bool):
    """Swap-free panel Gauss-Jordan that also builds the panel's transform.

    b Gauss-Jordan steps on ``[strip | probe]`` with a used-row mask
    instead of row exchanges: selecting the max-|value| row among unused
    rows is the same pivot sequence as partial pivoting with exchanges, and
    ties go to the smallest row index (``jnp.argmax``). The (m, b) probe
    starts at zero; step r injects the unit vector of its pivot row into
    probe column r just before eliminating (earlier steps act as identity
    on a not-yet-pivot row, so late injection is exact), so after the panel
    the probe holds T E -- the total transform T applied to the pivot-row
    selector E -- and ``probe - E`` is the panel's composite C. Every value
    comes from the same sequential rank-1 steps as the strip's own
    elimination, with no (b, b) block inverse in between.

    Returns ``(pivrows (b,), used, ok, probe (m, b))``.
    """
    rows = lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    lane = lax.broadcasted_iota(jnp.int32, (1, 2 * b), 1)
    w0 = jnp.concatenate([strip, jnp.zeros_like(strip)], axis=1)

    def step(r, carry):
        w, used, pivrows, ok = carry
        r = r.astype(jnp.int32)
        col = lax.dynamic_slice(w, (_i0, r), (m, 1))
        if pivot:
            cand = jnp.where(used > 0, jnp.full_like(col, -1), jnp.abs(col))
            p = jnp.argmax(cand[:, 0]).astype(jnp.int32)
        else:
            p = kb + r
        piv = lax.dynamic_slice(col, (p, _i0), (1, 1))[0, 0]
        ok = jnp.logical_and(ok, piv != 0)
        piv_safe = jnp.where(piv == 0, jnp.ones_like(piv), piv)
        used = jnp.where(rows == p, jnp.ones_like(used), used)
        pivrows = lax.dynamic_update_slice(pivrows, p[None], (r,))

        # Inject e_p into probe column r, then normalize and eliminate.
        row_p = lax.dynamic_slice(w, (p, _i0), (1, 2 * b))
        row_p = jnp.where(lane == b + r, row_p + 1, row_p)
        norm = row_p / piv_safe
        factors = jnp.where(rows == p, jnp.zeros_like(col), col)
        w = jnp.where(rows == p, norm, w - factors * norm)
        return w, used, pivrows, ok

    pivrows0 = jnp.zeros((b,), jnp.int32)
    w, used, pivrows, ok = lax.fori_loop(
        0, b, step, (w0, used, pivrows0, jnp.bool_(True)))
    return pivrows, used, ok, w[:, b:]


# --------------------------------------------------------------------------
# Shared panel/group factorization (single-device blocked driver AND the
# per-device body of parallel/sharded.py)
# --------------------------------------------------------------------------


def _factor_panel(strip, kb, used, *, m: int, b: int, pivot: bool):
    """Panel pivot rows + transformed selector T E (as its transpose, (b, m)).

    The panel's whole effect on any working-set columns X is
    ``X * (1 - rowmask) + (T E) @ X[pivrows]`` (rowmask: the panel's pivot
    rows) -- one rank-b GEMM that eliminates AND deposits the scaled pivot
    rows. It equals ``X + C @ X[pivrows]`` with the composite C = T E - E,
    but never forms ``T E - E``: at the pivot rows that difference is
    ``D^-1 - I``, and with pivots larger than one it cancels away most of
    D^-1's digits. T E comes from the panel's own elimination
    (``_panel_pivots_logical``). Returns ``(pivrows, te_t, ok)``.
    """
    # The scope names the serial panel chain in device traces.
    with jax.named_scope("panel_factor"):
        pivrows, _, ok, probe = _panel_pivots_logical(strip, used, kb, m=m,
                                                      b=b, pivot=pivot)
    return pivrows, jnp.swapaxes(probe, -1, -2), ok


def _group_factor(og, kb0, used, *, gsize: int, gw: int, m: int, b: int,
                  dtype, pivot: bool, precision):
    """Factor ``gsize`` consecutive panels on the [O | G] working set.

    ``og`` is (m, 2*gw): the group's outer strip O followed by the
    (initially zero) identity-probe columns G. After the loop,
    ``og[:, gw:]`` is the group's transformed selector T E (see
    ``_blocked_gj``). Shared verbatim by the single-device driver and the
    replicated per-device factorization of ``parallel/sharded.py`` -- the
    mesh generalization of the reference's two-stage argmax
    (``matrix_inversion_FP32.cpp:68-142``).

    Returns ``(og, pivtot (gw,), used, ok)``.
    """
    rows = lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    pivtot = jnp.zeros((gw,), jnp.int32)
    ok = jnp.bool_(True)
    for i in range(gsize):  # static unroll; all slices static
        ib = i * b
        strip = og[:, ib:ib + b]
        pivrows, te_t, ok_f = _factor_panel(
            strip, kb0 + ib, used, m=m, b=b, pivot=pivot)
        ok = jnp.logical_and(ok, ok_f)
        pivtot = lax.dynamic_update_slice(pivtot, pivrows, (np.int32(ib),))

        psel = (rows == pivrows[None, :]).astype(dtype)   # (m, b)
        rowmask = jnp.sum(psel, axis=1, keepdims=True)
        used = used + rowmask.astype(jnp.float32)
        # Inject this panel's identity probe columns BEFORE its own
        # update (prior transforms act as identity on them).
        og = og.at[:, gw + ib:gw + ib + b].set(psel)

        # Windowed internal update: O columns before this panel are
        # finished (frozen, same argument as the outer window) and G
        # probes beyond this panel are still zero, so the live columns
        # are exactly og[:, ib : gw+ib+b] -- a static slice here since
        # the group loop is unrolled. One rank-b GEMM (te_t contracted on
        # its row axis) eliminates AND deposits the scaled rows into the
        # zeroed pivot rows.
        og_win = og[:, ib:gw + ib + b]                    # (m, gw+b)
        # Same gather-then-update hazard as run_group's outer window (see
        # the barrier note there): materialize the pivot rows first so the
        # windowed update can write og in place.
        block_rows = lax.optimization_barrier(
            jnp.take(og_win, pivrows, axis=0))            # (b, gw+b)
        og = og.at[:, ib:gw + ib + b].set(
            og_win * (1 - rowmask) + lax.dot_general(
                te_t, block_rows, (((0,), (0,)), ((), ())),
                preferred_element_type=dtype, precision=precision))
    return og, pivtot, used, ok


# --------------------------------------------------------------------------
# Blocked driver
# --------------------------------------------------------------------------


def _blocked_gj(a: jax.Array, *, pivot: bool, b: int, precision,
                group_size: int = 4):
    n = a.shape[-1]
    m = max(_round_up(n, b), b)
    dtype = a.dtype

    # Pad to blockdiag(A, I): inverse is blockdiag(inv(A), I); padded rows
    # are all-zero in real columns so they never win a pivot.
    if m != n:
        apad = jnp.eye(m, dtype=dtype)
        apad = lax.dynamic_update_slice(apad, a, (0, 0))
        a = apad
    # Slot layout: left half is the A working set; the right half holds the
    # composite-transform columns in PIVOT ORDER (slot t = the column that
    # tracks the t-th pivot row), not in standard column positions. Slots
    # start at zero and are deposited as each group finishes, so at group
    # kk the live columns are exactly [kb0+gw, m+kb0): the not-yet-
    # eliminated left columns plus the already-deposited slots -- one
    # CONTIGUOUS window of constant width m-gw. Finished left columns are
    # frozen (they equal e_{pivot row}; later pivot rows carry zeros there)
    # and future slots are still zero, so the trailing update touches HALF
    # the columns the classic [A | I] layout would (2m^3 instead of 4m^3
    # MACs for the full inversion). One column gather at the very end maps
    # slots back to standard positions, mirroring the row gather.
    aug = jnp.concatenate([a, jnp.zeros((m, m), dtype=dtype)], axis=-1)

    num_panels = m // b

    # Logical-permutation scheme: rows never move during elimination -- a
    # cross-panel "used" mask excludes prior pivot rows from the search,
    # the panel's row placement is folded into the trailing GEMM as extra
    # rank, and a single gather at the very end puts the inverse rows in
    # order.
    #
    # Two-level grouping: `group` consecutive panels are processed against
    # a working set [O | G] where O is the outer strip (the group's
    # columns) and G a progressively-injected identity probe. After the
    # group, G - E^T IS the group's composite column transform C
    # (T X = X + C @ X[pivot rows] -- exact: T_j e_p = e_p for any
    # not-yet-pivot row p, so late injection is sound), so the whole matrix
    # is touched ONCE per group (rank-group*b GEMM) instead of once per
    # panel.
    # group need NOT divide num_panels: a shorter tail group handles the
    # remainder (shrinking group to a divisor collapses to group=1 on
    # prime-ish panel counts -- N=10000 has 157 panels at b=64).
    group = max(1, min(group_size, num_panels))
    gw = group * b
    num_groups = num_panels // group
    tail = num_panels - num_groups * group

    group_factor = functools.partial(
        _group_factor, m=m, b=b, dtype=dtype, pivot=pivot,
        precision=precision)

    def run_group(kb0, carry, gsize, gw, static_call=True):
        """Factor ``gsize`` consecutive panels starting at column ``kb0``
        and apply their composite transform to the live window."""
        aug, used, pos, ok = carry
        # Static offsets wherever kb0 is a trace-time constant (the
        # unrolled group loop): a static lax.slice folds into its consumer,
        # where a dynamic_slice of the window materializes a buffer that
        # XLA may then relayout-copy for the GEMM.
        k0 = int(kb0) if static_call else None
        og = jnp.concatenate(
            [lax.slice(aug, (0, k0), (m, k0 + gw)) if static_call
             else lax.dynamic_slice(aug, (_i0, kb0), (m, gw)),
             jnp.zeros((m, gw), dtype)], axis=1)  # [O | G]
        og, pivtot, used_new, ok_g = group_factor(og, kb0, used,
                                                  gsize=gsize, gw=gw)
        ok = jnp.logical_and(ok, ok_g)
        pos = lax.dynamic_update_slice(pos, pivtot, (kb0,))
        # The group's pivot rows.
        rowmask = (used_new - used).astype(dtype)             # (m, 1)
        used = used_new

        # Group transform G = T E, applied to the live window
        # [kb0+gw, m+kb0) in one rank-gw GEMM as win * (1 - rowmask) +
        # G @ win[pivtot] (the composite C = G - E, without forming it; see
        # _factor_panel). The group's own left columns get the finished O;
        # its slots [m+kb0, m+kb0+gw) get G, the deposited transform the
        # classic layout would scatter to columns m+pivtot.
        g = og[:, gw:]
        win = (lax.slice(aug, (0, k0 + gw), (m, k0 + m)) if static_call
               else lax.dynamic_slice(aug, (_i0, kb0 + gw), (m, m - gw)))
        # Materialize the gathered pivot rows BEFORE the update GEMM: the
        # gather reads rows of the same region the fused GEMM+add+update
        # overwrites, and without the barrier XLA may break that hazard by
        # copying the whole aug buffer every group. With the rows in their
        # own buffer the update is elementwise in the region and buffer
        # assignment can do it in place. The pairing with static offsets is
        # deliberate: dynamic-kb0 calls (the fori body) skip the barrier.
        blockw = jnp.take(win, pivtot, axis=0)
        if static_call:
            blockw = lax.optimization_barrier(blockw)
        win = win * (1 - rowmask) + jnp.matmul(
            g, blockw, preferred_element_type=dtype, precision=precision)
        aug = lax.dynamic_update_slice(aug, win, (_i0, kb0 + gw))
        aug = lax.dynamic_update_slice(aug, og[:, :gw], (_i0, kb0))
        aug = lax.dynamic_update_slice(aug, og[:, gw:],
                                       (_i0, np.int32(m) + kb0))
        return aug, used, pos, ok

    def group_step(kk, carry):
        kb0 = kk.astype(jnp.int32) * gw
        return run_group(kb0, carry, group, gw, static_call=False)

    used0 = jnp.zeros((m, 1), jnp.float32)
    pos0 = lax.broadcasted_iota(jnp.int32, (m,), 0)
    carry = (aug, used0, pos0, jnp.bool_(True))
    if _unroll_groups(num_groups):
        # Static unroll of the group loop: straight-line code lets the
        # window updates alias in place, where a while-loop carry may be
        # copied whole once per iteration.
        for kk in range(num_groups):
            carry = run_group(np.int32(kk * gw), carry, group, gw)
    else:
        carry = lax.fori_loop(0, num_groups, group_step, carry)
    if tail:
        # np.int32 (NOT jnp): under an outer vmap trace a jnp constant is
        # lifted to a tracer, breaking run_group's static-offset path
        # (int(kb0) at trace time).
        carry = run_group(np.int32(num_groups * group * b), carry,
                          tail, tail * b)
    aug, _, pos, ok = carry
    # Undo the logical permutation once. Slot t of the right half is the
    # inverse column pos[t] (and inverse row g lives at physical row
    # pos[g]), so gather columns by the inverse permutation of pos, then
    # rows by pos -- two gathers replacing the classic layout's one.
    slots = lax.slice(aug, (0, m), (m, 2 * m))
    invpos = jnp.zeros((m,), jnp.int32).at[pos].set(
        lax.broadcasted_iota(jnp.int32, (m,), 0))
    inv = jnp.take(jnp.take(slots, invpos, axis=1), pos, axis=0)[:n, :n]
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(inv)))
    return inv, ok


@functools.partial(jax.jit,
                   static_argnames=("pivot", "block_size", "precision",
                                    "group_size", "refine"))
def _blocked_inverse_jit(a: jax.Array, *, pivot: bool, block_size: int,
                         precision: str, group_size: int = 4,
                         refine: int = 1):
    fn = functools.partial(_blocked_gj, pivot=pivot, b=block_size,
                           precision=_PRECISIONS[precision],
                           group_size=group_size)
    for _ in range(a.ndim - 2):
        fn = jax.vmap(fn)
    inv, ok = fn(a)
    if refine > 0:
        # Newton-Schulz polish, paying back the grouped-update accuracy
        # trade.
        from gpu_matrix_inversion_tpu.ops.refine import newton_schulz_refine
        inv = newton_schulz_refine(a, inv, iters=refine)
        ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(inv), axis=(-2, -1)))
    return inv, ok


def effective_gemm_flops(n: int, *, block_size: int = DEFAULT_BLOCK_SIZE,
                         group_size: int | None = None) -> int:
    """Flops the windowed blocked algorithm ACTUALLY schedules for one
    inversion.

    The reference's 4*N^3 model (``matrix_inversion_FP64.cpp:753-755``)
    counts the classic full-width [A | I] elimination; the windowed
    pivot-order slot layout deliberately touches about HALF those columns
    (see ``_blocked_gj``), so a "TFLOP/s" on the 4N^3 model is an
    *algorithmic* rate that can legitimately exceed the hardware matmul
    peak. This helper counts the GEMMs the path really issues -- outer
    composite and internal panel updates -- so utilization can be reported
    honestly.
    """
    b = _panel_width(n, block_size)
    m = max(_round_up(n, b), b)
    num_panels = m // b
    if group_size is None:
        group_size = _default_group_size(b, num_panels)
    group = max(1, min(group_size, num_panels))
    num_groups = num_panels // group
    tail = num_panels - num_groups * group
    fl = 0
    for gsize in [group] * num_groups + ([tail] if tail else []):
        gw = gsize * b
        fl += 2 * m * gw * (m - gw)        # outer composite rank-gw GEMM
        fl += gsize * 2 * m * b * (gw + b)  # internal rank-b panel updates
    return fl


def blocked_inverse(a: jax.Array, *, pivot: bool = True,
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    precision: str = "highest",
                    group_size: int | None = None,
                    refine: int = 1):
    """Blocked Gauss-Jordan inverse; ``(..., n, n) -> (inverse, ok)``.

    The large-N performance path mirroring the reference's pivoted
    Gauss-Jordan (``matrix_inversion_FP32.cpp:12``): its per-iteration
    rank-1 ``fixColumnKernel`` trailing update (FP32.cpp:17-63) is
    regrouped into rank-``group*b`` GEMMs, and the two-stage
    maxPivot/finalMaxPivot argmax (FP32.cpp:68-142) generalizes to the
    swap-free panel pivot search. ``pivot=False`` mirrors
    ``matrix_inversion_no_pivots.cpp:10``.

    Args:
      precision: matmul precision for the rank-b trailing updates -- one of
        ``"default"``, ``"high"``, ``"highest"`` (full fp32; on a GPU the
        lower tiers may run fp32 products in TF32).
      group_size: panels per composite trailing update. Larger = fewer
        full-matrix passes but a somewhat larger raw residual, which the
        default Newton polish recovers. Default: ``_default_group_size``;
        set 1 for per-panel updates.
      refine: Newton-Schulz polish steps applied to the result (default 1;
        0 disables).
    """
    a = jnp.asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got {a.shape}")
    if a.dtype == jnp.bfloat16:
        # bf16 is an I/O format: compute in fp32 (bf16 GJ arithmetic is
        # numerically useless past tiny n), return bf16.
        inv, ok = blocked_inverse(a.astype(jnp.float32), pivot=pivot,
                                  block_size=block_size, precision=precision,
                                  group_size=group_size, refine=refine)
        return inv.astype(jnp.bfloat16), ok
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {set(_PRECISIONS)}")
    n = a.shape[-1]
    b = _panel_width(n, block_size)
    if group_size is None:
        group_size = _default_group_size(b, max(_round_up(n, b), b) // b)
    return _blocked_inverse_jit(a, pivot=pivot, block_size=b,
                                precision=precision, group_size=group_size,
                                refine=refine)
