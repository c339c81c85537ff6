"""LU factorization + getri-style inversion and solves.

The reference *loses* to NumPy/MATLAB because "they utilize LAPACK's LU
Decompositions which is more efficient than Gauss Jordan"
(reference ``README.md:62``). This module is the LAPACK-shaped path the
reference never built: partial-pivoted LU (getrf), triangular solves (getrs),
explicit inversion (getri), and FP32-factor + iterative-refinement to reach
FP64-level residuals (BASELINE.md configs[3]).

Spec-level implementation in pure jnp with static shapes (fori_loop +
dynamic_slice); the blocked path reuses the machinery in
``ops/blocked.py``. Storage convention matches LAPACK: L (unit lower) and U
packed in one matrix, plus a row-permutation vector (PA = LU).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gpu_matrix_inversion_tpu.ops.blocked import (_default_group_size,
                                                  _panel_width)
from gpu_matrix_inversion_tpu.ops.gauss_jordan import _i0


def _lu_factor_2d(a: jax.Array, *, pivot: bool = True):
    n = a.shape[-1]
    rows1 = lax.broadcasted_iota(jnp.int32, (n,), 0)
    sub = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    lane = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    perm0 = rows1

    def step(r, carry):
        lu, perm, ok = carry
        r = r.astype(jnp.int32)
        col = lax.dynamic_slice(lu, (_i0, r), (n, 1))[:, 0]
        if pivot:
            cand = jnp.where(rows1 >= r, jnp.abs(col), jnp.full_like(col, -1))
            p = jnp.argmax(cand).astype(jnp.int32)
        else:
            p = r
        piv = lax.dynamic_slice(col, (p,), (1,))[0]
        ok = jnp.logical_and(ok, piv != 0)
        piv_safe = jnp.where(piv == 0, jnp.ones_like(piv), piv)

        if pivot:
            row_r = lax.dynamic_slice(lu, (r, _i0), (1, n))
            row_p = lax.dynamic_slice(lu, (p, _i0), (1, n))
            lu = lax.dynamic_update_slice(lu, row_r, (p, _i0))
            lu = lax.dynamic_update_slice(lu, row_p, (r, _i0))
            pg = lax.dynamic_slice(perm, (r,), (1,))
            pp = lax.dynamic_slice(perm, (p,), (1,))
            perm = lax.dynamic_update_slice(perm, pp, (r,))
            perm = lax.dynamic_update_slice(perm, pg, (p,))
            col_at_r = lax.dynamic_slice(col, (r,), (1,))[0]
            col = jnp.where(rows1 == r, piv,
                            jnp.where(rows1 == p, col_at_r, col))

        # Multipliers for rows below r.
        factors = jnp.where(rows1 > r, col / piv_safe,
                            jnp.zeros_like(col))[:, None]  # (n, 1)
        row_r = lax.dynamic_slice(lu, (r, _i0), (1, n))
        # Eliminate only the trailing columns (> r); store multipliers in
        # column r below the diagonal (LAPACK packed layout).
        update = factors * row_r
        update = jnp.where(lane > r, update, jnp.zeros_like(update))
        lu = lu - update
        lu = jnp.where(jnp.logical_and(lane == r, sub > r),
                       jnp.broadcast_to(factors, (n, n)), lu)
        return lu, perm, ok

    lu, perm, ok = lax.fori_loop(0, n, step, (a, perm0, jnp.bool_(True)))
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(lu)))
    return lu, perm, ok


@functools.partial(jax.jit, static_argnames=("pivot",))
def lu_factor(a: jax.Array, *, pivot: bool = True):
    """getrf: returns ``(lu, perm, ok)`` with PA = LU, batched over leading
    axes. ``perm`` maps output row i to input row perm[i]."""
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got {a.shape}")
    batch, n = a.shape[:-2], a.shape[-1]
    a3 = a.reshape((-1, n, n))
    lu, perm, ok = jax.vmap(functools.partial(_lu_factor_2d, pivot=pivot))(a3)
    return lu.reshape(a.shape), perm.reshape(batch + (n,)), ok.reshape(batch)


def _lu_solve_2d(lu: jax.Array, perm: jax.Array, b: jax.Array):
    """getrs: solve A x = b given (lu, perm); b is (n, k)."""
    n = lu.shape[-1]
    rows = lax.broadcasted_iota(jnp.int32, (n,), 0)
    y = jnp.take(b, perm, axis=0)

    # Forward substitution, column-oriented: L is unit lower.
    def fwd(j, y):
        j = j.astype(jnp.int32)
        yj = lax.dynamic_slice(y, (j, _i0), (1, y.shape[1]))
        coll = lax.dynamic_slice(lu, (_i0, j), (n, 1))[:, 0]
        f = jnp.where(rows > j, coll, jnp.zeros_like(coll))[:, None]
        return y - f * yj

    y = lax.fori_loop(0, n, fwd, y)

    # Back substitution: U x = y.
    def bwd(t, carry):
        y, ok = carry
        j = jnp.int32(n - 1) - t.astype(jnp.int32)
        ujj = lax.dynamic_slice(lu, (j, j), (1, 1))[0, 0]
        ok = jnp.logical_and(ok, ujj != 0)
        ujj_safe = jnp.where(ujj == 0, jnp.ones_like(ujj), ujj)
        xj = lax.dynamic_slice(y, (j, _i0), (1, y.shape[1])) / ujj_safe
        colu = lax.dynamic_slice(lu, (_i0, j), (n, 1))[:, 0]
        f = jnp.where(rows < j, colu, jnp.zeros_like(colu))[:, None]
        y = y - f * xj
        y = lax.dynamic_update_slice(y, xj, (j, _i0))
        return y, ok

    y, ok = lax.fori_loop(0, n, bwd, (y, jnp.bool_(True)))
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(y)))
    return y, ok


@jax.jit
def lu_solve(lu: jax.Array, perm: jax.Array, b: jax.Array):
    """Solve using a prior :func:`lu_factor`; returns ``(x, ok)``."""
    batch, n = lu.shape[:-2], lu.shape[-1]
    k = b.shape[-1]
    x, ok = jax.vmap(_lu_solve_2d)(lu.reshape((-1, n, n)),
                                   perm.reshape((-1, n)),
                                   b.reshape((-1, n, k)))
    return x.reshape(b.shape), ok.reshape(batch)


@jax.jit
def lu_inverse(a: jax.Array):
    """getri: explicit inverse via LU + n simultaneous solves.

    Returns ``(inverse, ok)`` -- the LAPACK-equivalent path the reference's
    README concedes to (README.md:62).
    """
    n = a.shape[-1]
    lu, perm, ok_f = lu_factor(a)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    inv, ok_s = lu_solve(lu, perm, eye)
    return inv, jnp.logical_and(ok_f, ok_s)


@functools.partial(jax.jit, static_argnames=("pivot",))
def lu_solve_matrix(a: jax.Array, b: jax.Array, *, pivot: bool = True):
    """One-shot solve A x = b; returns ``(x, ok)``."""
    lu, perm, ok_f = lu_factor(a, pivot=pivot)
    x, ok_s = lu_solve(lu, perm, b)
    return x, jnp.logical_and(ok_f, ok_s)


# --------------------------------------------------------------------------
# Blocked LU: the performance getrf/getrs (fori panels + rank-b GEMM trailing
# updates; same logical-permutation design as ops/blocked.py). Partial-
# pivoted GJ and LU choose identical pivot sequences: the search reads only
# not-yet-pivoted rows, whose values evolve identically under both
# eliminations.
# --------------------------------------------------------------------------


def _lu_panel(strip, used, kb, *, m: int, b: int, pivot: bool):
    """Factor an (m, b) panel with no-swap partial pivoting.

    Multipliers are stored in place below the (logical) diagonal; ``used``
    excludes prior pivot rows from the search. Returns
    ``(w, pivrows, used, ok)``.
    """
    rows = lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    lane_b = lax.broadcasted_iota(jnp.int32, (m, b), 1)

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

        eliminable = jnp.logical_and(used == 0, rows != p)  # (m, 1)
        f = jnp.where(eliminable, col / piv_safe, jnp.zeros_like(col))
        used = jnp.where(rows == p, jnp.ones_like(used), used)
        pivrows = lax.dynamic_update_slice(pivrows, p[None], (r,))

        row_p = lax.dynamic_slice(w, (p, _i0), (1, b))
        upd = jnp.where(lane_b > r, f * row_p, jnp.zeros_like(w))
        w = w - upd
        # Store the multipliers in panel column r (eliminated rows only).
        w = jnp.where(jnp.logical_and(lane_b == r, eliminable),
                      jnp.broadcast_to(f, (m, b)), w)
        return w, used, pivrows, ok

    pivrows0 = jnp.zeros((b,), jnp.int32)
    w, used, pivrows, ok = lax.fori_loop(
        0, b, step, (strip, used, pivrows0, jnp.bool_(True)))
    return w, pivrows, used, ok


def _panel_multipliers(w, pivrows, used_before, *, m: int, b: int, dtype):
    """Truncated multiplier matrix and unit-lower L11 of a factored panel.

    ``L[i, r]`` is live iff row i was eliminated at step r (still unpivoted
    then, and not used before the panel), so the truncation also lets one
    GEMM write the panel's own pivot rows' U values."""
    lane_b1 = lax.broadcasted_iota(jnp.int32, (1, b), 1)
    tri_b = (lax.broadcasted_iota(jnp.int32, (b, b), 0)
             > lax.broadcasted_iota(jnp.int32, (b, b), 1))
    order = jnp.full((m,), b, jnp.int32).at[pivrows].set(
        jnp.arange(b, dtype=jnp.int32))
    lmask = (order[:, None] > lane_b1).astype(dtype)
    l_trunc = w * lmask * (1 - used_before.astype(dtype))
    l11 = jnp.where(tri_b, jnp.take(w, pivrows, axis=0),
                    jnp.zeros((b, b), dtype)) + jnp.eye(b, dtype=dtype)
    return l_trunc, l11


def _lu_factor_blocked_2d(a, *, b: int, pivot: bool):
    """Flat blocked getrf: one full-width rank-b trailing GEMM per panel."""
    n = a.shape[-1]
    m = max(((n + b - 1) // b) * b, b)
    dtype = a.dtype
    if m != n:
        apad = jnp.eye(m, dtype=dtype)
        apad = lax.dynamic_update_slice(apad, a, (0, 0))
        a = apad

    lane_m = lax.broadcasted_iota(jnp.int32, (1, m), 1)
    hp = jax.lax.Precision.HIGHEST

    def panel_step(k, carry):
        lu, used, pos, ok = carry
        kb = k.astype(jnp.int32) * b
        used_before = used
        strip = lax.dynamic_slice(lu, (_i0, kb), (m, b))
        w, pivrows, used, okp = _lu_panel(strip, used, kb, m=m, b=b,
                                          pivot=pivot)
        ok = jnp.logical_and(ok, okp)
        l_trunc, l11 = _panel_multipliers(w, pivrows, used_before, m=m, b=b,
                                          dtype=dtype)

        lu = lax.dynamic_update_slice(lu, w, (_i0, kb))
        pos = lax.dynamic_update_slice(pos, pivrows, (kb,))

        # U rows for the trailing columns: unit-lower solve against the
        # panel-local multiplier block.
        arows = jnp.take(lu, pivrows, axis=0)  # (b, m)
        u_all = lax.linalg.triangular_solve(
            l11, arows, left_side=True, lower=True, unit_diagonal=True)
        u_rest = jnp.where(lane_m >= kb + b, u_all, jnp.zeros_like(u_all))

        # Rank-b trailing update; the truncation makes it apply the right
        # partial sums to this panel's own pivot rows too (their rest
        # columns become U rows).
        lu = lu - jnp.matmul(l_trunc, u_rest, preferred_element_type=dtype,
                             precision=hp)
        return lu, used, pos, ok

    used0 = jnp.zeros((m, 1), jnp.float32)
    pos0 = lax.broadcasted_iota(jnp.int32, (m,), 0)
    lu, _, pos, ok = lax.fori_loop(0, m // b, panel_step,
                                   (a, used0, pos0, jnp.bool_(True)))
    # Standard LAPACK orientation: row g of the packed factor is U row g /
    # the multipliers of the row ending up at position g.
    lu = jnp.take(lu, pos, axis=0)[:n, :n]
    perm = pos[:n]
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(lu)))
    return lu, perm, ok


def _lu_group_sizes(num_panels: int, group: int):
    """Static (first_panel, gsize) schedule: full groups plus one tail.

    The tail group is simply smaller (like ops/blocked: shrinking ``group``
    to a divisor collapses to group=1 on prime-ish panel counts)."""
    out, k = [], 0
    while k < num_panels:
        g = min(group, num_panels - k)
        out.append((k, g))
        k += g
    return out


def _lu_factor_grouped_2d(a, *, b: int, group: int, pivot: bool):
    """Two-level blocked getrf.

    The flat panel loop (``_lu_factor_blocked_2d``) pays one FULL-width
    rank-b trailing GEMM, one (b, m) row gather and one (b, m) triangular
    solve per panel -- ~2m^3 MACs where LU needs ~m^3/2, and m/b serial
    full-matrix passes. This version ports ops/blocked's two-level grouping
    (``_group_factor``): ``group`` consecutive panels are factored against
    the (m, gw) group strip only (rank-b updates masked to the strip's
    not-yet-factored lanes), then the remaining window -- a STATICALLY
    shrinking (m, m-kb0-gw) slice, one Python-level group at a time -- gets
    a single rank-gw update. The group's U rows come from one unit-lower
    (gw, gw) solve in pivot order, and the same order-truncation identity
    as the panel level writes the pivot rows' own U values in the same
    GEMM. Each panel is the swap-free jnp panel (``_lu_panel``, the
    blocked form of ``matrix_inversion_FP32.cpp:68-142``'s two-stage
    argmax).
    """
    n = a.shape[-1]
    m = max(((n + b - 1) // b) * b, b)
    dtype = a.dtype
    if m != n:
        apad = jnp.eye(m, dtype=dtype)
        a = lax.dynamic_update_slice(apad, a, (0, 0))

    hp = jax.lax.Precision.HIGHEST

    lu = a
    used = jnp.zeros((m, 1), jnp.float32)
    pos = lax.broadcasted_iota(jnp.int32, (m,), 0)
    ok = jnp.bool_(True)

    for k0, gsize in _lu_group_sizes(m // b, group):
        kb0 = k0 * b
        gw = gsize * b
        lane_gw = lax.broadcasted_iota(jnp.int32, (1, gw), 1)
        used_g0 = used
        strip0 = lax.slice(lu, (0, kb0), (m, kb0 + gw))

        def panel_body(i, carry, kb0=kb0, gw=gw, lane_gw=lane_gw):
            strip, used, pivloc, ok = carry
            ib = i.astype(jnp.int32) * b
            pstrip = lax.dynamic_slice(strip, (_i0, ib), (m, b))
            w, pivrows, used_new, okp = _lu_panel(pstrip, used, kb0 + ib,
                                                  m=m, b=b, pivot=pivot)
            ok = jnp.logical_and(ok, okp)
            l_trunc, l11 = _panel_multipliers(w, pivrows, used, m=m, b=b,
                                              dtype=dtype)
            strip = lax.dynamic_update_slice(strip, w, (_i0, ib))
            used = used_new
            pivloc = lax.dynamic_update_slice(pivloc, pivrows, (ib,))

            # Internal trailing update, confined to the strip: U rows for
            # the strip's remaining lanes, then one rank-b GEMM whose
            # order-truncated L also writes the pivot rows' U values.
            arows = jnp.take(strip, pivrows, axis=0)          # (b, gw)
            u_all = lax.linalg.triangular_solve(
                l11, arows, left_side=True, lower=True, unit_diagonal=True)
            u_g = jnp.where(lane_gw >= ib + b, u_all, jnp.zeros_like(u_all))
            strip = strip - jnp.matmul(l_trunc, u_g,
                                       preferred_element_type=dtype,
                                       precision=hp)
            return strip, used, pivloc, ok

        pivloc0 = jnp.zeros((gw,), jnp.int32)
        strip, used, pivloc, ok = lax.fori_loop(
            0, gsize, panel_body, (strip0, used, pivloc0, ok))
        lu = lax.dynamic_update_slice(lu, strip, (_i0, np.int32(kb0)))
        pos = lax.dynamic_update_slice(pos, pivloc, (np.int32(kb0),))

        rest = m - kb0 - gw
        if rest:
            win = lax.slice(lu, (0, kb0 + gw), (m, m))        # (m, rest)
            # Materialize the gathered pivot rows before the trailing
            # update GEMM (same in-place hazard fix as ops/blocked.py's
            # run_group: without it XLA may copy the full lu buffer per
            # group to break the gather-while-overwriting hazard).
            arows_w = lax.optimization_barrier(
                jnp.take(win, pivloc, axis=0))                # (gw, rest)
            lgg_rows = jnp.take(strip, pivloc, axis=0)        # (gw, gw)
            tri_gw = (lax.broadcasted_iota(jnp.int32, (gw, gw), 0)
                      > lax.broadcasted_iota(jnp.int32, (gw, gw), 1))
            lgg = (jnp.where(tri_gw, lgg_rows, jnp.zeros_like(lgg_rows))
                   + jnp.eye(gw, dtype=dtype))
            u_rest = lax.linalg.triangular_solve(
                lgg, arows_w, left_side=True, lower=True, unit_diagonal=True)
            order_g = jnp.full((m,), gw, jnp.int32).at[pivloc].set(
                lax.broadcasted_iota(jnp.int32, (gw,), 0))
            lmask_g = (order_g[:, None] > lane_gw).astype(dtype)
            ltr_g = strip * lmask_g * (1 - used_g0.astype(dtype))
            win = win - jnp.matmul(ltr_g, u_rest,
                                   preferred_element_type=dtype,
                                   precision=hp)
            lu = lax.dynamic_update_slice(lu, win, (_i0, np.int32(kb0 + gw)))

    lu = jnp.take(lu, pos, axis=0)[:n, :n]
    perm = pos[:n]
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(lu)))
    return lu, perm, ok


@functools.partial(jax.jit, static_argnames=("pivot", "b", "group"))
def _lu_factor_blocked_jit(a, *, pivot: bool, b: int, group: int = 0):
    batch, n = a.shape[:-2], a.shape[-1]
    if group > 1:
        fn = functools.partial(_lu_factor_grouped_2d, b=b, group=group,
                               pivot=pivot)
    else:
        fn = functools.partial(_lu_factor_blocked_2d, b=b, pivot=pivot)
    lu, perm, ok = jax.vmap(fn)(a.reshape((-1, n, n)))
    return (lu.reshape(a.shape), perm.reshape(batch + (n,)),
            ok.reshape(batch))


def _lu_group(b: int) -> int:
    """Panels per group of the grouped getrf (``MATINV_LU_GROUP`` overrides;
    1 = the flat per-panel loop)."""
    return int(os.environ.get("MATINV_LU_GROUP", 0)) or _default_group_size(b)


def lu_factor_blocked(a: jax.Array, *, pivot: bool = True,
                      block_size: int = 128):
    """Blocked getrf: swap-free panel factorization + rank-b GEMM trailing
    updates, two-level grouped (``_lu_factor_grouped_2d``); the fast path
    (:func:`lu_factor` is the executable spec). Returns ``(lu, perm, ok)``
    with the same convention as :func:`lu_factor`."""
    a = jnp.asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got {a.shape}")
    n = a.shape[-1]
    b = _panel_width(n, min(block_size, max(n, 8)))
    return _lu_factor_blocked_jit(a, pivot=pivot, b=b, group=_lu_group(b))


@jax.jit
def lu_solve_fast(lu: jax.Array, perm: jax.Array, b: jax.Array):
    """Blocked getrs via the XLA triangular-solve primitive (the fast path;
    :func:`lu_solve` is the executable spec). Returns ``(x, ok)``."""
    n = lu.shape[-1]
    tri = (jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
           > jax.lax.broadcasted_iota(jnp.int32, (n, n), 1))
    lmat = jnp.where(tri, lu, jnp.zeros_like(lu)) + jnp.eye(n, dtype=lu.dtype)
    umat = jnp.where(tri, jnp.zeros_like(lu), lu)
    # take_along_axis (not take) so a batched perm gathers per-batch rows
    # instead of flattening (ADVICE r1: batched (B, n, n) inputs).
    y = jnp.take_along_axis(b, perm[..., None], axis=-2)
    y = lax.linalg.triangular_solve(lmat, y, left_side=True, lower=True,
                                    unit_diagonal=True)
    x = lax.linalg.triangular_solve(umat, y, left_side=True, lower=False)
    diag = jnp.diagonal(umat, axis1=-2, axis2=-1)
    ok = jnp.logical_and(jnp.all(diag != 0, axis=-1),
                         jnp.all(jnp.isfinite(x), axis=(-2, -1)))
    return x, ok


# --------------------------------------------------------------------------
# Blocked triangular inversion (trtri). LAPACK's getri is built on trtri(U)
# rather than solves against the identity; this is the GEMM-shaped version:
# batched diagonal-block inverses, then log2(#blocks) levels of BATCHED
# GEMMs (every recursion node at a level has identical shapes, so each level
# is one batched matmul instead of 2^k small ones). Replaces the reference's
# O(N) serial elimination sweep for the inverse-assembly phase.
# --------------------------------------------------------------------------


def _trtri_default_b(n: int) -> int:
    """Base block: fewer levels means fewer level-boundary gathers/concats
    and larger batched GEMMs; below 2048 a 1024 base would BE most of the
    matrix, so keep a real bisection. A starting value, not yet tuned on
    the card."""
    return 1024 if n >= 2048 else 256


def _tri_mm_chunks(s: int) -> int:
    """Cross-GEMM chunking factor: the bisection's cross products contract
    against TRIANGULAR sub-inverses, so a dense (s, s) GEMM schedules ~2x
    the needed MACs. Chunking in 4 strips cuts the multiplier to
    (1 + 1/4)/2 = 0.625 while keeping every strip >= 128 columns wide;
    below s=512 the strips get too narrow to pay."""
    return 4 if s >= 512 else 1


def _trtri_blocked_2d(t: jax.Array, *, lower: bool, unit_diagonal: bool,
                      b: int | None = None, canvas: bool = True):
    """Inverse of an (n, n) triangular matrix by block bisection.

    X = [[X11, 0], [-X22 T21 X11, X22]] (lower; mirrored for upper), applied
    bottom-up: level k combines 2^k sub-inverses of size s into batched
    (s, s) GEMMs, chunked to exploit the sub-inverses' triangularity
    (``_tri_mm_chunks``). Pads n to b * 2^L with identity so every level is
    a uniform batch. All value-carrying GEMMs run at HIGHEST (CLAUDE.md #5).
    ``canvas=True`` (default) assembles levels in place on an (m, m) canvas
    with static-offset slices instead of stack/concat rebuilds (see the
    canvas branch comment).
    """
    n = t.shape[-1]
    dt = t.dtype
    if b is None:
        b = _trtri_default_b(n)
    if n <= b:
        return lax.linalg.triangular_solve(
            t, jnp.eye(n, dtype=dt), left_side=True, lower=lower,
            unit_diagonal=unit_diagonal)
    # Adaptive base block: the smallest m = base * 2^levels >= n with
    # base <= b keeps the identity padding under one lane-tile per level
    # (a FIXED base of 256 padded n=11000 to 16384 -- a 3.3x flop cliff;
    # base=176, levels=6 pads to 11264 instead).
    levels = max((-(-n // b) - 1).bit_length(), 0)
    base = -(-n // (1 << levels))
    base = -(-base // 8) * 8
    m = base * (1 << levels)
    b = base
    if m != n:
        tp = jnp.eye(m, dtype=dt)
        t = lax.dynamic_update_slice(tp, t, (0, 0))
    nb = m // b

    # Batched diagonal-block inverses: (nb, b, b) triangular solves vs I.
    dblocks = t.reshape(nb, b, nb, b)
    diag = jnp.stack([dblocks[i, :, i, :] for i in range(nb)])
    x = lax.linalg.triangular_solve(
        diag, jnp.broadcast_to(jnp.eye(b, dtype=dt), (nb, b, b)),
        left_side=True, lower=lower, unit_diagonal=unit_diagonal)

    hp = jax.lax.Precision.HIGHEST

    def mm(a_, b_):
        return jnp.matmul(a_, b_, precision=hp, preferred_element_type=dt)

    def tri_mm_right(y, xt):
        # y @ xt with xt (B, s, s) triangular: column strip J of the result
        # only touches xt's nonzero rows for those columns.
        s = xt.shape[-1]
        ch = _tri_mm_chunks(s)
        if ch == 1:
            return mm(y, xt)
        cw = s // ch
        cols = []
        for j0 in range(0, s, cw):
            if lower:   # xt lower: rows >= j0 in columns [j0, j0+cw)
                cols.append(mm(y[..., :, j0:], xt[..., j0:, j0:j0 + cw]))
            else:       # xt upper: rows < j0+cw
                cols.append(mm(y[..., :, :j0 + cw], xt[..., :j0 + cw,
                                                       j0:j0 + cw]))
        return jnp.concatenate(cols, axis=-1)

    def tri_mm_left(xt, y):
        # xt @ y with xt (B, s, s) triangular: row strip I of the result
        # only touches xt's nonzero columns in those rows.
        s = xt.shape[-2]
        ch = _tri_mm_chunks(s)
        if ch == 1:
            return mm(xt, y)
        cw = s // ch
        rows_ = []
        for i0 in range(0, s, cw):
            if lower:   # xt lower: columns < i0+cw in rows [i0, i0+cw)
                rows_.append(mm(xt[..., i0:i0 + cw, :i0 + cw],
                                y[..., :i0 + cw, :]))
            else:       # xt upper: columns >= i0
                rows_.append(mm(xt[..., i0:i0 + cw, i0:], y[..., i0:, :]))
        return jnp.concatenate(rows_, axis=-2)

    if canvas:
        # Canvas assembly: the batched formulation
        # below pays a strided block gather (`off` stack) plus a FULL
        # rebuild of x (three concats over the whole live area) at every
        # level; the canvas writes each level's cross blocks in place with
        # static-offset slices/updates and never moves the diagonal
        # sub-inverses at all. Same GEMMs (per pair instead of batched),
        # ~1/4 the copies.
        xc = jnp.zeros((m, m), dt)
        for i in range(nb):
            xc = lax.dynamic_update_slice(xc, x[i], (i * b, i * b))
        for level in range(levels):
            s = b << level
            for p in range(m // (2 * s)):
                r0 = p * 2 * s
                x11 = lax.slice(xc, (r0, r0), (r0 + s, r0 + s))
                x22 = lax.slice(xc, (r0 + s, r0 + s),
                                (r0 + 2 * s, r0 + 2 * s))
                if lower:
                    off = lax.slice(t, (r0 + s, r0), (r0 + 2 * s, r0 + s))
                    cross = -tri_mm_left(x22, tri_mm_right(off, x11))
                    xc = lax.dynamic_update_slice(xc, cross, (r0 + s, r0))
                else:
                    off = lax.slice(t, (r0, r0 + s), (r0 + s, r0 + 2 * s))
                    cross = -tri_mm_left(x11, tri_mm_right(off, x22))
                    xc = lax.dynamic_update_slice(xc, cross, (r0, r0 + s))
        return xc[:n, :n]

    for level in range(levels):
        s = b << level
        npairs = m // (2 * s)
        tb = t.reshape(npairs, 2 * s, npairs, 2 * s)
        if lower:
            off = jnp.stack([tb[p, s:, p, :s] for p in range(npairs)])
        else:
            off = jnp.stack([tb[p, :s, p, s:] for p in range(npairs)])
        x11, x22 = x[0::2], x[1::2]
        if lower:
            cross = -tri_mm_left(x22, tri_mm_right(off, x11))
            top = jnp.concatenate([x11, jnp.zeros_like(cross)], axis=-1)
            bot = jnp.concatenate([cross, x22], axis=-1)
        else:
            cross = -tri_mm_left(x11, tri_mm_right(off, x22))
            top = jnp.concatenate([x11, cross], axis=-1)
            bot = jnp.concatenate([jnp.zeros_like(cross), x22], axis=-1)
        x = jnp.concatenate([top, bot], axis=-2)
    return x[0][:n, :n]


@functools.partial(jax.jit, static_argnames=("lower", "unit_diagonal", "b",
                                             "canvas"))
def invert_triangular(t: jax.Array, *, lower: bool = True,
                      unit_diagonal: bool = False, b: int | None = None,
                      canvas: bool = True):
    """trtri: explicit inverse of a triangular matrix, batched over leading
    axes. Returns ``(inverse, ok)``; ``ok`` is False on a zero diagonal
    (or any non-finite output). The off-triangle of ``t`` is ignored.
    ``b`` overrides the default base block (``_trtri_default_b``).
    Replaces the reference's O(N)-launch serial elimination sweep tier
    (``matrix_inversion_FP32.cpp:622-705``) with log2(n/b) levels of
    batched GEMMs for the inverse-assembly phase."""
    if t.ndim < 2 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got {t.shape}")
    n = t.shape[-1]
    r_i = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    c_i = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    keep = (r_i > c_i) if lower else (r_i < c_i)   # strict off-diagonal
    tc = jnp.where(keep, t, jnp.zeros_like(t))
    dvals = (jnp.ones_like(jnp.diagonal(t, axis1=-2, axis2=-1))
             if unit_diagonal else jnp.diagonal(t, axis1=-2, axis2=-1))
    eye = jnp.eye(n, dtype=t.dtype)
    tc = tc + eye * dvals[..., None, :]
    fn = functools.partial(_trtri_blocked_2d, lower=lower,
                           unit_diagonal=unit_diagonal, b=b, canvas=canvas)
    batch = t.shape[:-2]
    out = jax.vmap(fn)(tc.reshape((-1, n, n))).reshape(t.shape)
    ok = jnp.logical_and(jnp.all(dvals != 0, axis=-1),
                         jnp.all(jnp.isfinite(out), axis=(-2, -1)))
    return out, ok


def _getri_product(left: jax.Array, linv: jax.Array, *, chunk: int = 512,
                   left_transposed: bool = False,
                   left_triangular: bool = False, rchunk: int = 512):
    """``left @ linv`` exploiting ``linv``'s LOWER triangularity (batched
    over leading axes): column-chunk J only multiplies the rows of ``linv``
    at or below J's start (the rest are zero), cutting the dense n^3 MACs
    to ~n^3/2 at chunk << n. Static Python loop; one GEMM per chunk
    (chunk and rchunk are starting values, not yet tuned on the card).
    Used by getri (left = U^-1) and potri (left = L^-T).

    ``left_transposed=True`` computes ``left.T @ linv`` by contracting on
    ``left``'s ROW axis directly (dot_general takes either operand
    layout), so potri never materializes the (n, n) transpose of
    ``L^-1`` -- a pure relayout copy.

    ``left_triangular=True`` additionally exploits that ``left`` (after the
    optional transpose) is UPPER triangular -- true for both callers
    (getri's U^-1; potri's L^-T): row-chunk I of the output only needs
    contraction indices k >= max(i0, j0), trimming the MACs further to
    ~n^3/3 at rchunk, chunk << n. Per (I, J) tile one GEMM with a
    static k offset; out-of-range contributions are exact zeros, so the
    tiling is algebraically exact, not an approximation."""
    n = linv.shape[-1]
    hp = jax.lax.Precision.HIGHEST
    nb = left.ndim - 2
    bdims = tuple(range(nb))
    if left_triangular:
        rows = []
        for i0 in range(0, n, rchunk):
            r = min(rchunk, n - i0)
            cols = []
            for j0 in range(0, n, chunk):
                c = min(chunk, n - j0)
                k0 = max(i0, j0)
                if left_transposed:
                    cols.append(lax.dot_general(
                        left[..., k0:, i0:i0 + r],
                        linv[..., k0:, j0:j0 + c],
                        (((nb,), (nb,)), (bdims, bdims)),
                        precision=hp, preferred_element_type=left.dtype))
                else:
                    cols.append(jnp.matmul(
                        left[..., i0:i0 + r, k0:],
                        linv[..., k0:, j0:j0 + c],
                        precision=hp, preferred_element_type=left.dtype))
            rows.append(jnp.concatenate(cols, axis=-1))
        return jnp.concatenate(rows, axis=-2)
    cols = []
    for j0 in range(0, n, chunk):
        c = min(chunk, n - j0)
        if left_transposed:
            cols.append(lax.dot_general(
                left[..., j0:, :], linv[..., j0:, j0:j0 + c],
                (((nb,), (nb,)), (bdims, bdims)),
                precision=hp, preferred_element_type=left.dtype))
        else:
            cols.append(jnp.matmul(left[..., :, j0:],
                                   linv[..., j0:, j0:j0 + c],
                                   precision=hp,
                                   preferred_element_type=left.dtype))
    return jnp.concatenate(cols, axis=-1)


@jax.jit
def _lu_inverse_trtri(a: jax.Array):
    """getri via trtri (LAPACK's own shape): A^-1 = U^-1 L^-1 P, with the
    permutation applied as one final column gather. GEMM-rich alternative
    to the identity-RHS solves; also ~3 n^2 live temporaries instead of the
    solve path's tens of n^2 (the n=11000 OOM, GETRI_CHUNK_MIN_N)."""
    n = a.shape[-1]
    lu, perm, ok_f = lu_factor_blocked(a)
    linv, ok_l = invert_triangular(lu, lower=True, unit_diagonal=True)
    uinv, ok_u = invert_triangular(lu, lower=False, unit_diagonal=False)
    # linv/uinv are slice/concat-built intermediates consumed ONLY by the
    # GEMMs below inside one jit program -- the pattern a compiler
    # dead-intermediate rewrite once corrupted (DESIGN.md section 8); guard
    # the seam like ops/refine.py does.
    linv, uinv = lax.optimization_barrier((linv, uinv))
    prod = _getri_product(uinv, linv, left_triangular=True)
    # A^-1 = U^-1 L^-1 P and (P x)[i] = x[perm[i]], so column j of the
    # result is column invperm[j] of the product.
    invperm = jnp.zeros((n,), perm.dtype).at[perm].set(
        lax.broadcasted_iota(perm.dtype, (n,), 0))
    inv = jnp.take(prod, invperm, axis=1)
    ok = jnp.logical_and(jnp.logical_and(ok_f, ok_l),
                         jnp.logical_and(ok_u,
                                         jnp.all(jnp.isfinite(inv))))
    return inv, ok


# Above this order the one-shot getri solve (triangular solves against the
# full (n, n) identity) can hold tens of n^2 temporaries live; the chunked
# solve bounds the RHS to (n, chunk) per step. Only reachable on the opt-in
# MATINV_GETRI_ROUTE=solve path: the default trtri route holds ~5 n^2 and
# never chunks.
GETRI_CHUNK_MIN_N = 8192 + 1


@functools.partial(jax.jit, static_argnames=("chunk",))
def _lu_inverse_chunked(lu: jax.Array, perm: jax.Array, *, chunk: int):
    """getri solve with the identity RHS processed ``chunk`` columns at a
    time: peak temp memory drops from O(k * n^2) to O(n^2 + k * n * chunk).

    The permuted identity chunk P @ I[:, j0:j0+c] is built directly as the
    one-hot comparison perm[i] == j0 + jj (no gather); columns past n (tail
    chunk) come out zero and the final slice drops them.
    """
    n = lu.shape[-1]
    c = chunk
    nc = -(-n // c)
    tri = (jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
           > jax.lax.broadcasted_iota(jnp.int32, (n, n), 1))
    lmat = jnp.where(tri, lu, jnp.zeros_like(lu)) + jnp.eye(n, dtype=lu.dtype)
    umat = jnp.where(tri, jnp.zeros_like(lu), lu)
    lane_c = jax.lax.broadcasted_iota(jnp.int32, (1, c), 1)

    def body(k, out):
        j0 = k.astype(jnp.int32) * c
        y = (perm[:, None] == j0 + lane_c).astype(lu.dtype)   # P @ I chunk
        y = lax.linalg.triangular_solve(lmat, y, left_side=True, lower=True,
                                        unit_diagonal=True)
        x = lax.linalg.triangular_solve(umat, y, left_side=True, lower=False)
        return lax.dynamic_update_slice(out, x, (_i0, j0))

    out = lax.fori_loop(0, nc, body, jnp.zeros((n, nc * c), lu.dtype))
    inv = out[:, :n]
    diag = jnp.diagonal(umat)
    ok = jnp.logical_and(jnp.all(diag != 0), jnp.all(jnp.isfinite(inv)))
    return inv, ok


def lu_inverse_fast(a: jax.Array, *, chunk: int = 2048):
    """Blocked getri; returns ``(inverse, ok)`` -- the performance version
    of :func:`lu_inverse` (the LAPACK path the reference's README concedes
    to, ``README.md:62``).

    Single matrices take the trtri composition ``A^-1 = U^-1 L^-1 P``
    (LAPACK's own getri shape: GEMM-rich, and ~5 n^2 live temporaries, so
    it needs no chunking at any order the device can hold). Batched inputs take the solve route, whose one
    triangular-solve pair amortizes over the batch. ``MATINV_GETRI_ROUTE=
    solve`` forces the solve route for single matrices (identity chunked
    past :data:`GETRI_CHUNK_MIN_N` to bound temp memory)."""
    n = a.shape[-1]
    route = os.environ.get("MATINV_GETRI_ROUTE", "trtri")
    if a.ndim == 2 and route != "solve":
        return _lu_inverse_trtri(a)
    if a.ndim == 2 and n >= GETRI_CHUNK_MIN_N:
        lu, perm, ok_f = lu_factor_blocked(a)
        inv, ok_s = _lu_inverse_chunked(lu, perm, chunk=min(chunk, n))
        return inv, jnp.logical_and(ok_f, ok_s)
    return _lu_inverse_fast_oneshot(a)


@jax.jit
def _lu_inverse_fast_oneshot(a: jax.Array):
    n = a.shape[-1]
    lu, perm, ok_f = lu_factor_blocked(a)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    inv, ok_s = lu_solve_fast(lu, perm, eye)
    return inv, jnp.logical_and(ok_f, ok_s)


# --------------------------------------------------------------------------
# Scheduled-flop models: count the MACs the implementations
# above actually issue (2 flops per MAC), so bench.py can report honest
# effective rates/MFU next to the reference's algorithmic models
# (``matrix_inversion_FP64.cpp:751-755``). Triangular solves are counted at
# their algorithmic ~k^2/2-MACs-per-RHS-column cost; the models track the
# exact chunk/group geometry the code selects, so they are accurate to the
# small (b, b) base cases (<1% at n >= 2048).
# --------------------------------------------------------------------------


def _trtri_effective_flops(n: int, b: int | None = None) -> int:
    """Flops one :func:`_trtri_blocked_2d` call schedules (one triangle)."""
    if b is None:
        b = _trtri_default_b(n)
    if n <= b:
        return n**3  # triangular solve vs I: ~n^3/2 MACs
    levels = max((-(-n // b) - 1).bit_length(), 0)
    base = -(-n // (1 << levels))
    base = -(-base // 8) * 8
    m = base * (1 << levels)
    fl = (m // base) * base**3  # batched diagonal-block solves vs I
    for level in range(levels):
        s = base << level
        npairs = m // (2 * s)
        mult = (1 + 1 / _tri_mm_chunks(s)) / 2  # 0.625 chunked, 1.0 dense
        # two chunked (s, s) cross products per pair (right then left)
        fl += npairs * 2 * int(2 * mult * s**3)
    return fl


def _getri_product_flops(n: int, chunk: int = 512,
                         left_triangular: bool = False,
                         rchunk: int = 512) -> int:
    """Flops of :func:`_getri_product`'s triangular-aware chunks (must
    mirror that function's tiling exactly -- bench MFU divides by these)."""
    fl = 0
    if left_triangular:
        for i0 in range(0, n, rchunk):
            r = min(rchunk, n - i0)
            for j0 in range(0, n, chunk):
                c = min(chunk, n - j0)
                fl += 2 * r * c * (n - max(i0, j0))
        return fl
    for j0 in range(0, n, chunk):
        fl += 2 * n * (n - j0) * min(chunk, n - j0)
    return fl


def getrf_effective_flops(n: int, *, block_size: int = 128) -> int:
    """Flops :func:`lu_factor_blocked`'s grouped path schedules."""
    b = _panel_width(n, min(block_size, max(n, 8)))
    group = _lu_group(b)
    m = max(-(-n // b) * b, b)
    fl = 0
    for k0, gsize in _lu_group_sizes(m // b, group):
        gw = gsize * b
        rest = m - k0 * b - gw
        # Per panel: the b rank-1 panel steps (~m*b^2 MACs) + u_all (b, gw)
        # solve + rank-b strip GEMM.
        fl += gsize * (2 * m * b * b + b * b * gw + 2 * m * b * gw)
        if rest:
            fl += gw * gw * rest       # u_rest unit-lower solve
            fl += 2 * m * gw * rest    # rank-gw window update
    return fl


def getri_effective_flops(n: int) -> int:
    """Flops the default trtri-route getri (:func:`lu_inverse_fast`)
    schedules: grouped getrf + L/U trtri pair + the chunked
    ``U^-1 @ L^-1`` product."""
    return (getrf_effective_flops(n) + 2 * _trtri_effective_flops(n)
            + _getri_product_flops(n, left_triangular=True))


@functools.partial(jax.jit, static_argnames=("iters",))
def cond_estimate(a: jax.Array, inv: jax.Array, *, iters: int = 8,
                  seed: int = 0):
    """Estimate the 2-norm condition number given a matrix and its inverse.

    The gecon-shaped diagnostic the reference never had (its only quality
    signal was the post-hoc identity check, FP32.cpp:814-835): power
    iteration on ``A^T A`` and ``inv^T inv`` estimates ||A||_2 and
    ||A^-1||_2; their product estimates cond_2(A). Fully batched, pure
    GEMM work.
    """
    n = a.shape[-1]
    hp = jax.lax.Precision.HIGHEST

    def spectral_norm(mat):
        key = jax.random.PRNGKey(seed)
        v = jax.random.normal(key, mat.shape[:-2] + (n, 1), mat.dtype)

        def body(_, v):
            v = jnp.matmul(mat, v, precision=hp)
            v = jnp.matmul(jnp.swapaxes(mat, -1, -2), v, precision=hp)
            norm = jnp.sqrt(jnp.sum(v * v, axis=(-2, -1), keepdims=True))
            return v / jnp.where(norm == 0, jnp.ones_like(norm), norm)

        v = lax.fori_loop(0, iters, body, v)
        av = jnp.matmul(mat, v, precision=hp)
        return jnp.sqrt(jnp.sum(av * av, axis=(-2, -1)))

    return spectral_norm(a) * spectral_norm(inv)


@jax.jit
def slogdet(a: jax.Array):
    """Sign and log-absolute-determinant from the LU factorization
    (numpy.linalg.slogdet contract): returns ``(sign, logabsdet, ok)``,
    batched over leading axes.

    The getrf-derived diagnostic the reference never exposed (its pipeline
    stops at the inverse; determinants fall out of the same factorization
    for free, ``matrix_inversion_FP32.cpp:622-705``'s pivot loop already
    computes every pivot). ``det(A) = sign(P) * prod(diag(U))``; the
    permutation sign is the parity of its inversion count -- an O(n^2)
    boolean reduction, which vectorizes where cycle-walking would
    serialize. Exactly singular input gives ``sign=0, logabsdet=-inf``
    (numpy's value convention) and ``ok=False`` (the factor's zero-pivot
    flag, consistent with the library-wide ``(result, ok)`` contract)."""
    a = jnp.asarray(a)
    n = a.shape[-1]
    if n >= 256:
        lu, perm, ok = lu_factor_blocked(a)
    else:
        lu, perm, ok = lu_factor(a)
    diag = jnp.diagonal(lu, axis1=-2, axis2=-1)
    # Parity of perm: #{i < j : perm[i] > perm[j]} mod 2.
    lt = (lax.broadcasted_iota(jnp.int32, (n, n), 0)
          < lax.broadcasted_iota(jnp.int32, (n, n), 1))
    inversions = jnp.sum(
        jnp.logical_and(lt, perm[..., :, None] > perm[..., None, :]),
        axis=(-2, -1))
    sign_perm = jnp.where(inversions % 2 == 0, 1.0, -1.0).astype(a.dtype)
    sign = sign_perm * jnp.prod(jnp.sign(diag), axis=-1)
    logabs = jnp.sum(jnp.log(jnp.abs(diag)), axis=-1)
    return sign, logabs, ok


def det(a: jax.Array):
    """Determinant via :func:`slogdet` (overflows to ``+-inf`` exactly where
    ``numpy.linalg.det`` does). Returns ``(det, ok)``."""
    sign, logabs, ok = slogdet(a)
    return sign * jnp.exp(logabs), ok
