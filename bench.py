"""Benchmark: prints ONE JSON line of timings on the GPU.

Metric: batched 128x128 FP32 inversions/sec (the fused Triton kernel,
BASELINE.json configs[2]) with ``vs_baseline`` = speedup over single-core
NumPy/LAPACK ``np.linalg.inv`` measured live on this host. Extra fields
report the 4096^2 blocked, getri and potri paths, 8192^2 and 16384^2
blocked, and the sharded wrapper on a 1-device mesh, each with the
reference's 4*N^3 flop model (matrix_inversion_FP64.cpp:753-755) and the
flops the path actually schedules (``*_gflops_effective``), against a
float32 HIGHEST matmul rate measured in the same run.

Per-op times are amortized: K ops run inside one jitted lax.scan (each
iteration perturbs the input so nothing hoists) and K=1 is differenced
against K=5. Single-call wall-clock times are reported alongside
(``*_ms_single_call``).

It fails when JAX finds no GPU, and every record names the device. The
cell-by-cell benchmark that replaces this script is ROADMAP item 1.1.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _trace(msg: str) -> None:
    """Stage marker to stderr (``MATINV_BENCH_TRACE=1``): flushed markers
    tell which stage a stalled run stopped in."""
    if os.environ.get("MATINV_BENCH_TRACE"):
        print(f"[bench {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


def _sync(out) -> float:
    return float(np.asarray(out))


def _bench(fn, *args, reps: int = 3) -> float:
    _sync(fn(*args))  # warm-up (compile)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def _amortized(make_fn, a, k1: int = 1, k2: int = 5, reps: int = 3) -> tuple:
    """Per-op seconds net of the per-call dispatch cost, plus the
    single-call wall-clock: run k ops inside one jitted scan and
    difference the k1 and k2 timings.

    The k1/k2 reps are INTERLEAVED (k1, k2, k1, k2, ...) so clock drift
    across minutes does not bake into the slope; paired reps sample both
    programs in the same window and min() picks the fastest consistent
    pair."""
    f1, f2 = make_fn(k1), make_fn(k2)
    _sync(f1(a)); _sync(f2(a))  # warm both (compile) before any timing
    t1s, t2s = [], []
    for _ in range(reps):
        t0 = time.perf_counter(); _sync(f1(a))
        t1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); _sync(f2(a))
        t2s.append(time.perf_counter() - t0)
    t1, t2 = min(t1s), min(t2s)
    # Clamp: jitter can make t2 < t1 for ops far below the dispatch cost;
    # never report a negative/zero per-op time.
    return max((t2 - t1) / (k2 - k1), 1e-6), t1


def main() -> None:
    from gpu_matrix_inversion_tpu.utils.config import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX's first device is on "
              f"{dev.platform!r}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}), file=sys.stderr)
    from gpu_matrix_inversion_tpu.ops.fused import fused_inverse
    from gpu_matrix_inversion_tpu.ops.blocked import (blocked_inverse,
                                                      effective_gemm_flops)
    from gpu_matrix_inversion_tpu.ops.lu import lu_inverse_fast
    from gpu_matrix_inversion_tpu.utils.generators import hollow_random_matrix
    from gpu_matrix_inversion_tpu.utils.residual import relative_residual

    # --- headline: batched 128^2 throughput (configs[2]) ------------------
    bs, n = 4096, 128
    base = np.stack([hollow_random_matrix(n, seed=i) for i in range(8)])
    batch = jnp.asarray(np.tile(base, (bs // 8, 1, 1)))

    @jax.jit
    def probe_batched(x):
        inv, ok = fused_inverse(x)
        return jnp.sum(inv) + jnp.sum(ok)

    _trace("batched fused 128^2 (f32)")
    t_batched = _bench(probe_batched, batch)
    inv_per_s = bs / t_batched

    # bf16 I/O variant (fp32 compute in the kernel).
    batch_bf16 = batch.astype(jnp.bfloat16)
    _trace("batched fused 128^2 (bf16)")
    t_bf16 = _bench(probe_batched, batch_bf16)
    inv_per_s_bf16 = bs / t_bf16

    # NumPy/LAPACK single-core baseline on the same matrices.
    np.linalg.inv(base[0])  # warm-up
    t0 = time.perf_counter()
    n_np = 64
    for i in range(n_np):
        np.linalg.inv(base[i % 8])
    t_np = (time.perf_counter() - t0) / n_np
    np_inv_per_s = 1.0 / t_np

    # --- measured matmul rate ---------------------------------------------
    # f32 HIGHEST 4096^3 GEMM, amortized like every other sub-100ms op here.
    # All effective rates below divide scheduled MACs by time; dividing by
    # this rate gives the *_mfu fields.
    n_big = 4096
    rng_mm = np.random.default_rng(3)
    g_mm = jnp.asarray(rng_mm.standard_normal((n_big, n_big)),
                       dtype=jnp.float32)

    def make_mm(k):
        @jax.jit
        def p(a):
            def body(c, _):
                out = jnp.matmul(a + c, a,
                                 precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32)
                return c + jnp.float32(1e-7), jnp.sum(out)
            c, outs = lax.scan(body, jnp.float32(0), None, length=k)
            return jnp.sum(outs) + c
        return p

    _trace("matmul peak 4096^3 (f32 HIGHEST)")
    t_mm, _ = _amortized(make_mm, g_mm, 1, 8)
    peak_tflops = 2 * n_big**3 / t_mm / 1e12
    del g_mm

    # --- 4096^2 blocked Gauss-Jordan (configs[1]) --------------------------
    a_big = jnp.asarray(hollow_random_matrix(n_big, seed=1))

    def make_blocked(k, refine):
        @jax.jit
        def p(a):
            def body(c, _):
                inv, ok = blocked_inverse(a + c, refine=refine)
                return c + jnp.float32(1e-7), jnp.sum(inv)
            c, outs = lax.scan(body, jnp.float32(0), None, length=k)
            return jnp.sum(outs) + c
        return p

    _trace("blocked 4096 raw scans")
    t_raw, t_raw_single = _amortized(lambda k: make_blocked(k, 0), a_big)
    _trace("blocked 4096 refined scans")
    t_ref, t_ref_single = _amortized(lambda k: make_blocked(k, 1), a_big)

    def make_lu(k):
        @jax.jit
        def p(a):
            def body(c, _):
                inv, ok = lu_inverse_fast(a + c)
                return c + jnp.float32(1e-7), jnp.sum(inv)
            c, outs = lax.scan(body, jnp.float32(0), None, length=k)
            return jnp.sum(outs) + c
        return p

    _trace("lu getri 4096 scans")
    t_lu, _ = _amortized(make_lu, a_big, 1, 3)
    gflops_raw = 4 * n_big**3 / t_raw / 1e9
    gflops_raw_eff = effective_gemm_flops(n_big) / t_raw / 1e9
    from gpu_matrix_inversion_tpu.ops.lu import getri_effective_flops
    gflops_lu_eff = getri_effective_flops(n_big) / t_lu / 1e9

    # --- SPD potri 4096 (Cholesky family; no reference counterpart) --------
    from gpu_matrix_inversion_tpu.ops.cholesky import cholesky_inverse
    rng_spd = np.random.default_rng(2)
    g = rng_spd.standard_normal((n_big, n_big))
    a_spd = jnp.asarray(((g @ g.T) / n_big
                         + np.eye(n_big)).astype(np.float32))

    def make_potri(k):
        @jax.jit
        def p(a):
            def body(c, _):
                inv, ok = cholesky_inverse(
                    a + c * jnp.eye(n_big, dtype=a.dtype))
                return c + jnp.float32(1e-6), jnp.sum(inv)
            c, outs = lax.scan(body, jnp.float32(0), None, length=k)
            return jnp.sum(outs) + c
        return p

    _trace("cholesky potri 4096 scans")
    t_potri, _ = _amortized(make_potri, a_spd, 1, 3)
    from gpu_matrix_inversion_tpu.ops.cholesky import potri_effective_flops
    gflops_potri_eff = potri_effective_flops(n_big) / t_potri / 1e9
    inv_spd, ok_spd = cholesky_inverse(a_spd)
    resid_spd = relative_residual(np.asarray(a_spd), np.asarray(inv_spd))
    del a_spd, inv_spd

    # --- 8192^2 blocked row -------------------------------------------------
    n_mid = 8192
    a_mid = jnp.asarray(hollow_random_matrix(n_mid, seed=4))

    def make_blocked_mid(k):
        @jax.jit
        def p(a):
            def body(c, _):
                inv, ok = blocked_inverse(a + c, refine=0)
                return c + jnp.float32(1e-7), jnp.sum(inv)
            c, outs = lax.scan(body, jnp.float32(0), None, length=k)
            return jnp.sum(outs) + c
        return p

    _trace("blocked 8192 scans")
    t_mid, t_mid_single = _amortized(make_blocked_mid, a_mid, 1, 3)
    gflops_mid_eff = effective_gemm_flops(n_mid) / t_mid / 1e9
    del a_mid

    # --- 16384^2 single-device capacity point --------------------------------
    # Long enough that dispatch cost is negligible: a plain single-call
    # timing, no amortization scan.
    n_huge = 16384
    a_huge = jnp.asarray(hollow_random_matrix(n_huge, seed=2))

    @jax.jit
    def probe_huge(a):
        inv, ok = blocked_inverse(a, refine=0)
        return jnp.sum(inv) + ok.astype(jnp.float32)

    _trace("blocked 16384 single-call")
    t_huge = _bench(probe_huge, a_huge, reps=2)
    gflops_huge = 4 * n_huge**3 / t_huge / 1e9
    gflops_huge_eff = effective_gemm_flops(n_huge) / t_huge / 1e9
    del a_huge

    # --- sharded wrapper gate (1-device mesh) -------------------------------
    # Pins two past regressions: the per-call jit rebuild and the serial
    # dynamic-index column gathers. Single-call wall-clock.
    from gpu_matrix_inversion_tpu.parallel.mesh import make_device_mesh
    from gpu_matrix_inversion_tpu.parallel.sharded import (
        sharded_blocked_inverse)
    mesh1 = make_device_mesh(1, ("x",))

    def probe_sharded(x):
        inv, ok = sharded_blocked_inverse(x, mesh=mesh1, refine=0)
        return jnp.sum(inv) + ok.astype(jnp.float32)

    _trace("sharded 4096 (1-dev mesh)")
    t_sharded = _bench(probe_sharded, a_big)

    # --- correctness gates (BASELINE: <=1e-4 rel residual) ------------------
    _trace("correctness gates")
    inv_small, ok_small = fused_inverse(np.asarray(base[0]))
    resid = relative_residual(base[0], np.asarray(inv_small))
    inv_raw, ok_raw = blocked_inverse(a_big, refine=0)
    resid_raw = relative_residual(np.asarray(a_big), np.asarray(inv_raw))
    inv_refined, _ = blocked_inverse(a_big, refine=1)
    resid_refined = relative_residual(np.asarray(a_big),
                                      np.asarray(inv_refined))

    result = {
        "metric": "batched_128x128_fp32_inversions_per_sec",
        "value": round(inv_per_s, 1),
        "unit": "inv/s",
        "vs_baseline": round(inv_per_s / np_inv_per_s, 2),
        "batch": bs,
        "numpy_inv_per_s": round(np_inv_per_s, 1),
        "batched_bf16_inv_per_s": round(inv_per_s_bf16, 1),
        "blocked_4096_ms": round(t_raw * 1e3, 1),
        "blocked_4096_ms_single_call": round(t_raw_single * 1e3, 1),
        "blocked_4096_ms_refined": round(t_ref * 1e3, 1),
        "blocked_4096_ms_refined_single_call": round(t_ref_single * 1e3, 1),
        "lu_getri_4096_ms": round(t_lu * 1e3, 1),
        "lu_getri_4096_gflops_effective": round(gflops_lu_eff, 1),
        "cholesky_potri_4096_ms": round(t_potri * 1e3, 1),
        "cholesky_potri_4096_gflops_effective": round(gflops_potri_eff, 1),
        "potri_4096_residual": float(f"{resid_spd:.3g}"),
        "blocked_4096_gflops_4n3": round(gflops_raw, 1),
        "blocked_4096_gflops_effective": round(gflops_raw_eff, 1),
        "blocked_8192_ms": round(t_mid * 1e3, 1),
        "blocked_8192_ms_single_call": round(t_mid_single * 1e3, 1),
        "blocked_8192_gflops_effective": round(gflops_mid_eff, 1),
        "blocked_16384_ms": round(t_huge * 1e3, 1),
        "blocked_16384_gflops_4n3": round(gflops_huge, 1),
        "blocked_16384_gflops_effective": round(gflops_huge_eff, 1),
        # MFU = effective rate over the live-measured f32 HIGHEST matmul
        # rate.
        "matmul_peak_tflops_f32_highest": round(peak_tflops, 2),
        "blocked_4096_mfu": round(gflops_raw_eff / 1e3 / peak_tflops, 3),
        # nongemm_ms: the measured time NOT explained by the scheduled
        # MACs running at the live matmul rate.
        "blocked_4096_nongemm_ms": round(
            (t_raw - effective_gemm_flops(n_big) / (peak_tflops * 1e12))
            * 1e3, 2),
        "blocked_8192_mfu": round(gflops_mid_eff / 1e3 / peak_tflops, 3),
        "blocked_16384_mfu": round(gflops_huge_eff / 1e3 / peak_tflops, 3),
        "lu_getri_4096_mfu": round(gflops_lu_eff / 1e3 / peak_tflops, 3),
        "cholesky_potri_4096_mfu": round(
            gflops_potri_eff / 1e3 / peak_tflops, 3),
        "sharded_4096_ms_single_call_1dev": round(t_sharded * 1e3, 1),
        "sharded_vs_blocked_single_call": round(
            t_sharded / max(t_raw_single, 1e-9), 2),
        "blocked_4096_residual_raw": float(f"{resid_raw:.3g}"),
        "blocked_4096_residual_refined": float(f"{resid_refined:.3g}"),
        "residual_128_fused": float(f"{resid:.3g}"),
        # The sharded wrapper gate is part of ok: the regressions it pins
        # (per-call rebuild, serial gathers) show up as 30x and more, so a
        # loose 5x bound catches them.
        "ok": (bool(ok_small) and bool(ok_raw) and resid_raw < 1e-4
               and bool(ok_spd) and resid_spd < 1e-4
               and t_sharded / max(t_raw_single, 1e-9) < 5.0),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    _trace("done")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
