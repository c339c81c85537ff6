"""Panel-sharded multi-device Gauss-Jordan inversion over a device mesh.

BASELINE.md configs[4]: invert N x N for N beyond one device's memory by
column-sharding the augmented (m, 2m) system over a mesh axis. SPMD design
(via ``shard_map``) with ONE collective per panel *group*:

1. *Group gather*: the (m, gw) outer strip of the next ``group`` panels is
   assembled from its owner shard(s) by a single masked-gather ``psum``
   (the analog of the reference's pivot-row broadcast; between the cards of
   one host this rides NVLink). gw = group*b columns per collective instead of b: same total
   bytes (m^2 for the whole inversion), group-times fewer messages.
2. *Replicated group factorization*: every device runs the SAME
   ``ops/blocked._group_factor`` the single-device path uses -- windowed
   pivot-order slot layout, composite panel transforms, per-panel rank-b
   internal updates (identical data -> identical pivots; no index
   exchange, no divergence): the mesh-scale generalization of the
   reference's two-stage workgroup argmax (FP32.cpp:68-142).
3. *Local windowed update*: each device applies the group's composite
   column transform C (m, gw) to its own column shard in one rank-gw
   GEMM -- and SKIPS the GEMM entirely when none of its columns intersect
   the live window [kb0+gw, m+kb0) (out-of-window columns receive provably
   zero updates: finished left columns are zero at this group's pivot rows,
   future slot columns are still zero). The skip recovers the windowed
   layout's ~2x MAC saving on average across the mesh.

Comm volume: one (m, gw) psum per group = m^2 floats total for the whole
inversion -- a 16384^2 FP32 inversion moves ~1 GB between devices against
4*N^3 = 17.6 TFLOP of elimination -- plus one column permutation
(all-to-all) undoing the slot layout at the end.

The batched variant shards batch over a ``dp`` mesh axis and columns over
``tp`` (2D mesh), i.e. data-parallel x tensor-parallel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpu_matrix_inversion_tpu.ops.gauss_jordan import _i0
from gpu_matrix_inversion_tpu.ops.blocked import (_PRECISIONS,
                                                  _default_group_size,
                                                  _group_factor,
                                                  _panel_width, _round_up,
                                                  _unroll_groups)
from gpu_matrix_inversion_tpu.parallel.mesh import make_device_mesh
from gpu_matrix_inversion_tpu.utils.platform import (compiled_kernels,
                                                     mesh_platform)

try:  # jax >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _local_gj(aug_loc: jax.Array, *, m: int, b: int, w: int, group: int,
              pivot: bool, axis: str, precision):
    """Per-device body: ``aug_loc`` is the (m, w) local column shard of the
    (m, 2m) slot-layout working set [A | slots].

    Same logical-permutation + windowed slot layout as the single-chip
    ``ops/blocked._blocked_gj`` (rows never move; slots deposit composite
    columns in pivot order; one global gather at the end restores order).
    The group factorization is the shared ``_group_factor``; only the
    strip gather, the deposit scatter, and the window-overlap skip are
    mesh-specific. Per group the ONLY communication is the one strip psum.
    """
    dtype = aug_loc.dtype
    my = lax.axis_index(axis).astype(jnp.int32)
    lane_w = lax.broadcasted_iota(jnp.int32, (1, w), 1)  # my local columns
    num_panels = m // b
    ngroups = num_panels // group
    tail = num_panels - ngroups * group
    group_factor = functools.partial(
        _group_factor, m=m, b=b, dtype=dtype, pivot=pivot,
        precision=precision)

    def shift_cols(chunk, width: int, start):
        """Place ``chunk`` (m, cw) into a zero (m, width) canvas at dynamic
        column ``start`` (clamped into range) via one dynamic_update_slice.

        This pad-shift is THE column-alignment primitive here: a
        ``jnp.take(..., axis=1)`` with traced indices may lower to a
        per-column gather, while dynamic_update_slice is one contiguous
        copy.
        """
        buf = jnp.zeros((m, width), chunk.dtype)
        return lax.dynamic_update_slice(buf, chunk, (_i0, start))

    unroll = _unroll_groups(ngroups)

    def run_group(kb0, carry, gsize, gw, static_call=True):
        aug_loc, used, pos, ok = carry
        # With a static kb0 (the unrolled group loop) a column range that
        # lies entirely inside ONE shard is known at trace time; the gather
        # and deposits below then use static offsets over just (m, gw)
        # instead of full-width canvases/selects.
        kb0_static = int(kb0) if static_call else None

        def inside_one_shard(g0):
            return g0 is not None and (g0 % w) + gw <= w

        # 1. Group gather: global columns [kb0, kb0+gw) live on one or two
        # shards (gw <= w by the group cap). Fast path (static kb0, group
        # inside one shard): every device takes the SAME static (m, gw)
        # slice of its local shard, scales by scalar ownership, and the
        # psum keeps only the owner's values (non-owners contribute zeros
        # from their own finite data). General path: each owner takes ONE
        # contiguous clipped (m, gw) dynamic_slice, pad-shifts it into
        # window coordinates, masks to the lanes it owns, and the psum
        # assembles the full strip (robust to any alignment, so gw never
        # needs to divide the shard width).
        if inside_one_shard(kb0_static):
            off_s = kb0_static % w
            cand = lax.slice(aug_loc, (0, off_s), (m, off_s + gw))
            own_dev = (my == kb0_static // w).astype(dtype)
            o_strip = lax.psum(cand * own_dev, axis)
        else:
            off = jnp.clip(kb0 - my * w, 0, jnp.int32(w - gw))
            cand = lax.dynamic_slice(aug_loc, (_i0, off), (m, gw))
            shift = my * w + off - kb0                   # in [-gw, gw]
            contrib = shift_cols(cand, 3 * gw, gw + shift)[:, gw:2 * gw]
            lane_g = kb0 + lax.broadcasted_iota(jnp.int32, (1, gw), 1)
            own = jnp.logical_and(lane_g >= my * w,
                                  lane_g < my * w + w).astype(dtype)
            o_strip = lax.psum(contrib * own, axis)

        # 2. Replicated factorization on [O | G] (identical inputs on every
        # device -> identical pivots/composites, no index exchange).
        og = jnp.concatenate([o_strip, jnp.zeros((m, gw), dtype)], axis=1)
        og, pivtot, used_new, ok_g = group_factor(og, kb0, used,
                                                  gsize=gsize, gw=gw)
        rowmask = (used_new - used).astype(dtype)    # the group's pivot rows
        used = used_new
        ok = jnp.logical_and(ok, ok_g)
        pos = lax.dynamic_update_slice(pos, pivtot, (kb0,))

        # 3. Local windowed update by the group transform G = T E (as
        # win * (1 - rowmask) + G @ win[pivtot], see ops/blocked.py) on
        # my shard's intersection with the live window [kb0+gw, m+kb0) in
        # one rank-gw GEMM, skipped when my columns miss the window
        # entirely. The update is confined to a (m, ww) slice with
        # ww = min(w, m-gw): out-of-window columns receive provably zero
        # updates (finished left columns are zero at this group's pivot
        # rows, future slots are still zero), so a slice that clamps into
        # the shard and overhangs the window is exact -- while updating the
        # WHOLE shard would schedule up to 2m/(m-gw) times the live MACs.
        g = og[:, gw:]
        lo = kb0 + gw
        hi = np.int32(m) + kb0
        ww = min(w, m - gw)

        def do_update(aug_loc):
            off_u = jnp.clip(lo - my * w, 0, jnp.int32(w - ww))
            win = lax.dynamic_slice(aug_loc, (_i0, off_u), (m, ww))
            # Barrier: see ops/blocked.py run_group -- materializing the
            # gathered pivot rows lets XLA update the region in place
            # instead of copying the shard to break the gather/overwrite
            # hazard. ONLY when this group body is straight-line code
            # (in-place needs static offsets + barrier together), so
            # dynamic-kb0 calls skip it.
            xp = jnp.take(win, pivtot, axis=0)                # (gw, ww)
            if static_call:
                xp = lax.optimization_barrier(xp)
            win = win * (1 - rowmask) + lax.dot_general(
                g, xp, (((1,), (0,)), ((), ())),
                preferred_element_type=dtype, precision=precision)
            return lax.dynamic_update_slice(aug_loc, win, (_i0, off_u))

        has = jnp.logical_and(my * w < hi, my * w + w > lo)
        aug_loc = lax.cond(has, do_update, lambda x: x, aug_loc)

        # 4. Deposits: the group's own columns get the finished O, its slot
        # columns [m+kb0, m+kb0+gw) get G. Fast path (static kb0, range
        # inside one shard): read the (m, gw) region at its STATIC local
        # offset, select chunk on the owner (scalar ownership), write it
        # back with one static dynamic_update_slice -- (m, gw) traffic
        # instead of the general path's full-width canvas + lane select.
        # General path (dynamic kb0 or shard-straddling
        # group): pad-shift into local coordinates and write under a
        # lane-index ownership select (see shift_cols).
        jg = my * w + lane_w                                   # (1, w)

        def deposit(aug_loc, chunk, g0, g0_static):
            if inside_one_shard(g0_static):
                off_d = g0_static % w
                cur = lax.slice(aug_loc, (0, off_d), (m, off_d + gw))
                sel_dev = (my == g0_static // w)
                new = jnp.where(sel_dev, chunk, cur)
                # Same barrier rationale as do_update: materialize the
                # select so buffer assignment can write the region in
                # place (static offsets + barrier).
                new = lax.optimization_barrier(new)
                return lax.dynamic_update_slice(aug_loc, new,
                                                (_i0, np.int32(off_d)))
            sel = jnp.logical_and(jg >= g0, jg < g0 + gw)
            t = jnp.clip(g0 - my * w, -jnp.int32(gw), jnp.int32(w))
            shifted = shift_cols(chunk, w + 2 * gw, gw + t)[:, gw:gw + w]
            return jnp.where(sel, shifted, aug_loc)

        aug_loc = deposit(aug_loc, og[:, :gw], kb0, kb0_static)
        aug_loc = deposit(aug_loc, og[:, gw:], np.int32(m) + kb0,
                          None if kb0_static is None else m + kb0_static)
        return aug_loc, used, pos, ok

    def group_step(kk, carry):
        kb0 = kk.astype(jnp.int32) * (group * b)
        return run_group(kb0, carry, group, group * b, static_call=False)

    used0 = jnp.zeros((m, 1), jnp.float32)
    pos0 = lax.broadcasted_iota(jnp.int32, (m,), 0)
    carry = (aug_loc, used0, pos0, jnp.bool_(True))
    if unroll:
        # Static unroll + barrier = in-place shard updates (the same
        # pairing as ops/blocked._blocked_gj).
        for kk in range(ngroups):
            carry = run_group(np.int32(kk * group * b), carry,
                              group, group * b)
    else:
        carry = lax.fori_loop(0, ngroups, group_step, carry)
    if tail:
        carry = run_group(np.int32(ngroups * group * b), carry,
                          tail, tail * b)
    aug_loc, _, pos, ok = carry
    return aug_loc, pos, ok.reshape(1)


def _build_aug_slots(a: jax.Array, m: int) -> jax.Array:
    """Pad to blockdiag(A, I) and append the ZERO slot half (the windowed
    slot layout of ops/blocked.py -- not the classic [A | I])."""
    n = a.shape[-1]
    dtype = a.dtype
    if m != n:
        apad = jnp.eye(m, dtype=dtype)
        apad = lax.dynamic_update_slice(apad, a, (0, 0))
        a = apad
    return jnp.concatenate([a, jnp.zeros((m, m), dtype=dtype)], axis=-1)


def _unpermute(aug_out, pos, m: int, n: int):
    """Slot half -> inverse: columns by the inverse permutation of pos,
    rows by pos (see ops/blocked.py). Under column sharding the column
    gather is a mesh permutation; XLA lowers it to collectives."""
    slots = lax.slice(aug_out, (0, m), (m, 2 * m))
    invpos = jnp.zeros((m,), jnp.int32).at[pos].set(
        lax.broadcasted_iota(jnp.int32, (m,), 0))
    return jnp.take(jnp.take(slots, invpos, axis=1), pos, axis=0)[:n, :n]


def _sharded_params(n: int, block_size: int, d: int, group_size):
    """Geometry for the sharded path: the single-device panel width, with m
    rounded so panels tile the shard width (w = 2m/d, b | w)."""
    b = _panel_width(n, block_size)
    m = _round_up(n, b * d)
    if group_size is None:
        group_size = _default_group_size(b)
    # gw = group*b <= w keeps every group on at most two shards, which is
    # what the one-dynamic-slice strip gather and pad-shift deposits in
    # _local_gj assume.
    group = max(1, min(group_size, m // b, 2 * m // (d * b)))
    return b, m, group


@functools.lru_cache(maxsize=64)
def _sharded_run(mesh: Mesh, n: int, m: int, b: int, group: int,
                 pivot: bool, axis: str, precision: str, refine: int):
    """Build-and-cache the jitted single-matrix program for one geometry.

    The jit MUST be cached across calls: a fresh ``@jax.jit`` closure per
    call retraces and recompiles the whole shard_map program every time.
    Mesh objects hash by device tuple + axis names, so the same mesh reuses
    its executable.
    """
    w = 2 * m // mesh.shape[axis]
    local = functools.partial(_local_gj, m=m, b=b, w=w, group=group,
                              pivot=pivot, axis=axis,
                              precision=_PRECISIONS[precision])
    fn = shard_map(local, mesh=mesh, in_specs=P(None, axis),
                   out_specs=(P(None, axis), P(None), P(axis)),
                   check_vma=False)

    @jax.jit
    def run(a):
        aug = _build_aug_slots(a, m)
        aug_out, pos, ok = fn(aug)
        inv = _unpermute(aug_out, pos, m, n)
        ok = jnp.logical_and(jnp.all(ok), jnp.all(jnp.isfinite(inv)))
        if refine > 0:
            from gpu_matrix_inversion_tpu.ops.refine import (
                newton_schulz_refine)
            inv = newton_schulz_refine(a, inv, iters=refine)
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(inv)))
        return inv, ok

    return run


def sharded_blocked_inverse(a: jax.Array, *, mesh: Optional[Mesh] = None,
                            block_size: int = 128, pivot: bool = True,
                            axis: str = "x", precision: str = "highest",
                            group_size: int | None = None,
                            refine: int = 1):
    """Invert a single (n, n) matrix column-sharded over ``mesh[axis]``.

    Returns ``(inverse, ok)`` like the single-chip paths. ``refine`` adds
    Newton-Schulz polish steps computed as global (sharded) GEMMs; the
    default matches ``blocked_inverse`` (one polish step) so auto-routing
    a large matrix to the mesh does not silently drop a quality tier.
    """
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        # Same bf16-as-I/O contract as blocked_inverse: compute in fp32
        # (bf16 GJ arithmetic is numerically useless past tiny n), return
        # bf16 — the mesh route must not silently drop a quality tier.
        inv, ok = sharded_blocked_inverse(
            a.astype(jnp.float32), mesh=mesh, block_size=block_size,
            pivot=pivot, axis=axis, precision=precision,
            group_size=group_size, refine=refine)
        return inv.astype(jnp.bfloat16), ok
    if mesh is None:
        from gpu_matrix_inversion_tpu.parallel.mesh import (
            default_platform_devices)
        mesh = make_device_mesh(len(default_platform_devices()), (axis,))
    d = mesh.shape[axis]
    n = a.shape[-1]
    b, m, group = _sharded_params(n, block_size, d, group_size)
    run = _sharded_run(mesh, n, m, b, group, pivot, axis, precision, refine)
    # Commit the input to the mesh's own devices (replicated) so nothing
    # lands on the process default device, which may be another platform
    # than the mesh (the tests pin a CPU default).
    return run(jax.device_put(a, NamedSharding(mesh, P())))


def sharded_batched_inverse(a: jax.Array, *, mesh: Optional[Mesh] = None,
                            block_size: int = 128, pivot: bool = True,
                            dp_axis: str = "dp", tp_axis: str = "tp",
                            precision: str = "highest",
                            group_size: int | None = None):
    """Batched inversion on a 2D (dp, tp) mesh: batch sharded over ``dp``,
    augmented columns over ``tp``. ``a`` is (B, n, n); B % dp == 0.

    On dp-only GPU meshes (tp == 1) with matrices inside the fused kernel's
    reach, each device runs the single-device fused kernel on its local
    batch (``_batched_fused_route``); ``precision``/``group_size`` apply
    only to the column-sharded panel body.

    Returns ``(inverse (B, n, n), ok (B,))``.
    """
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        # bf16 I/O contract (see sharded_blocked_inverse / blocked_inverse).
        inv, ok = sharded_batched_inverse(
            a.astype(jnp.float32), mesh=mesh, block_size=block_size,
            pivot=pivot, dp_axis=dp_axis, tp_axis=tp_axis,
            precision=precision, group_size=group_size)
        return inv.astype(jnp.bfloat16), ok
    if mesh is None:
        from gpu_matrix_inversion_tpu.parallel.mesh import (
            default_platform_devices)
        nd = len(default_platform_devices())
        dp = 2 if nd % 2 == 0 and nd > 1 else 1
        mesh = make_device_mesh((dp, nd // dp), (dp_axis, tp_axis))
    dp = mesh.shape[dp_axis]
    tp = mesh.shape[tp_axis]
    bsz, n, _ = a.shape
    if bsz % dp != 0:
        raise ValueError(f"batch {bsz} not divisible by dp={dp}")
    if _batched_fused_route(tp, n, a.dtype, mesh_platform(mesh)):
        # dp-only meshes with fused-sized matrices: each device inverts its
        # local batch with the fused kernel (ops/fused) instead of
        # vmapping the panel-sharded body. ``precision``/``group_size`` do
        # not apply (fp32 compute in registers).
        run = _sharded_batched_fused_run(mesh, pivot, dp_axis)
        return run(jax.device_put(a, NamedSharding(mesh, P(dp_axis))))
    b, m, group = _sharded_params(n, block_size, tp, group_size)
    run = _sharded_batched_run(mesh, n, m, b, group, pivot, dp_axis,
                               tp_axis, precision)
    # See sharded_blocked_inverse: commit to the mesh devices, batch-sharded
    # over dp so each dp group only materializes its own slice.
    return run(jax.device_put(a, NamedSharding(mesh, P(dp_axis))))


def _batched_fused_route(tp: int, n: int, dtype, platform: str) -> bool:
    """True when the batched sharded path should run the fused kernel per
    device instead of the column-sharded panel body: no tensor parallelism
    to honor (tp == 1), a dtype and order the fused kernel serves, and a
    mesh whose devices compile it (CPU meshes keep the jnp panel body)."""
    from gpu_matrix_inversion_tpu.ops.fused import FUSED_MAX_N
    return (tp == 1 and n <= FUSED_MAX_N and compiled_kernels(platform)
            and dtype in (jnp.float32, jnp.bfloat16))


@functools.lru_cache(maxsize=64)
def _sharded_batched_fused_run(mesh: Mesh, pivot: bool, dp_axis: str):
    """Cached jitted dp-sharded fused-batched program (see _sharded_run for
    why the cache is load-bearing). The per-device body is the
    single-device fused kernel (``ops/fused._fused_batched``), one program
    per local system."""
    from gpu_matrix_inversion_tpu.ops.fused import _fused_batched

    def local(a_loc):
        return _fused_batched(a_loc, pivot=pivot)

    fn = shard_map(local, mesh=mesh, in_specs=P(dp_axis),
                   out_specs=(P(dp_axis), P(dp_axis)), check_vma=False)
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _sharded_batched_run(mesh: Mesh, n: int, m: int, b: int, group: int,
                         pivot: bool, dp_axis: str, tp_axis: str,
                         precision: str):
    """Cached jitted batched program (see _sharded_run for why)."""
    w = 2 * m // mesh.shape[tp_axis]
    local = functools.partial(_local_gj, m=m, b=b, w=w, group=group,
                              pivot=pivot, axis=tp_axis,
                              precision=_PRECISIONS[precision])
    fn = shard_map(jax.vmap(local), mesh=mesh,
                   in_specs=P(dp_axis, None, tp_axis),
                   out_specs=(P(dp_axis, None, tp_axis), P(dp_axis, None),
                              P(dp_axis, tp_axis)),
                   check_vma=False)

    @jax.jit
    def run(a):
        aug = jax.vmap(lambda x: _build_aug_slots(x, m))(a)
        aug_out, pos, ok = fn(aug)
        inv = jax.vmap(lambda ao, p: _unpermute(ao, p, m, n))(aug_out, pos)
        ok = jnp.logical_and(jnp.all(ok, axis=-1),
                             jnp.all(jnp.isfinite(inv), axis=(-2, -1)))
        return inv, ok

    return run
