"""End-to-end smoke run of the inversion library on one NVIDIA GPU.

Drives the main paths once, through the public entry points, at the sizes
the library supports, in ONE process (each card takes one JAX process):

1. batched   -- ``inverse`` (auto route) on 4096 x 128^2 fp32: the fused
                Triton kernel, checked compiled (not interpreted), timed
                against the vmapped jnp Gauss-Jordan and ``jnp.linalg.inv``;
2. flat API  -- ``matrix_inv_32`` / ``fp32_bench`` round trips and the
                empty-on-failure contract;
3. blocked   -- 4096^2 raw and refined, the n=1950 seam input, 16384^2 raw,
                4096^2 fp64, timings beside ``jnp.linalg.inv``, and the share
                of device time the serial panel chain takes (one trace);
4. LAPACK    -- LU/getri, LU solve with refinement, Cholesky/potri and
                ``slogdet``.

``--four-cards`` runs only the sharded paths (16384^2 on a 4-card mesh,
compared with the single-card blocked result; a batch on a (2, 2) dp x tp
mesh). ``--rehearse`` runs everything at tiny sizes on the CPU, with the
kernel in the Pallas interpreter, and never prints the final ok line.

Residuals are normwise ``||AX - I||_F / (||A||_F ||X||_F)``: on the host in
float64 below n = 8192, on the card in float64 from there on. Each phase
prints its wall time, its residuals beside their bounds and its route. The
last line of a passing run is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage::

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # four cards, sharded paths only
    python chip_smoke.py --rehearse      # CPU rehearsal at tiny sizes
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument("--four-cards", action="store_true",
                  help="run only the sharded paths on a 4-card mesh")
ARGS.add_argument("--rehearse", action="store_true",
                  help="tiny sizes on the CPU, kernel interpreted; never "
                       "prints the final ok line")
OPTS = ARGS.parse_args()

if OPTS.rehearse:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")

from gpu_matrix_inversion_tpu.utils.config import enable_compile_cache  # noqa

enable_compile_cache()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gpu_matrix_inversion_tpu as mi  # noqa: E402
from gpu_matrix_inversion_tpu.models.solver import _resolve  # noqa: E402
from gpu_matrix_inversion_tpu.ops.blocked import blocked_inverse  # noqa
from gpu_matrix_inversion_tpu.ops.fused import (  # noqa: E402
    _fused_batched, fused_inverse)
from gpu_matrix_inversion_tpu.ops.gauss_jordan import (  # noqa: E402
    gauss_jordan_inverse)
from gpu_matrix_inversion_tpu.utils.generators import (  # noqa: E402
    hollow_random_matrix)

HIGHEST = jax.lax.Precision.HIGHEST
REPS = 5
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def size(real, tiny):
    return tiny if OPTS.rehearse else real


def device_header():
    smi = shutil.which("nvidia-smi")
    if smi:
        line = subprocess.run(
            [smi, "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    else:
        line = "nvidia-smi: not available"
    print(line)
    devs = jax.devices()
    d0 = devs[0]
    print(f"platform={d0.platform} device_kind={d0.device_kind} "
          f"count={len(devs)} jax={jax.__version__}")
    return d0


def resid_host(a, x) -> float:
    a = np.asarray(a, np.float64)
    x = np.asarray(x, np.float64)
    r = a @ x - np.eye(a.shape[-1])
    return float(np.linalg.norm(r) / (np.linalg.norm(a) * np.linalg.norm(x)))


@jax.jit
def _resid_dev(a, x):
    a = a.astype(jnp.float64)
    x = x.astype(jnp.float64)
    r = jnp.matmul(a, x, precision=HIGHEST) - jnp.eye(a.shape[-1],
                                                       dtype=jnp.float64)
    return jnp.linalg.norm(r) / (jnp.linalg.norm(a) * jnp.linalg.norm(x))


def resid(a, x) -> float:
    """Normwise residual in float64: on the card from n = 8192 on."""
    if a.shape[-1] >= 8192:
        with jax.enable_x64(True):
            return float(_resid_dev(jnp.asarray(a), jnp.asarray(x)))
    return resid_host(a, x)


def report(name, value, bound):
    ok = value <= bound
    print(f"  {name}: residual {value:.3e} (bound {bound:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: residual {value:.3e} above {bound:.0e}")


def timed(fn, *args, reps=REPS):
    """Median wall time of ``reps`` calls after one warm-up call, each
    ending in block_until_ready. Returns (last output, median, all)."""
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts), ts


def fmt_ms(ts):
    return "[" + ", ".join(f"{t * 1e3:.3f}" for t in ts) + "]"


def phase(name):
    def deco(fn):
        def run(*a, **k):
            print(f"== {name}")
            t0 = time.perf_counter()
            fn(*a, **k)
            print(f"   {name}: {time.perf_counter() - t0:.1f} s")
        return run
    return deco


def hlo_has_triton(fn, *args) -> bool:
    """Whether the program for ``fn(*args)``, as compiled for CUDA, calls the
    Triton kernel. On the card this reads the compiled executable; in a
    rehearsal it reads the lowering for CUDA (there is no card to compile
    for)."""
    traced = jax.jit(fn).trace(*args)
    if OPTS.rehearse:
        text = traced.lower(lowering_platforms=("cuda",)).as_text()
    else:
        text = traced.lower().compile().as_text()
    return "triton" in text.lower()


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


@phase("batched")
def batched():
    bsz, n = size(4096, 64), size(128, 32)
    base = np.stack([hollow_random_matrix(n, seed=s) for s in range(64)])
    host = np.tile(base, (bsz // 64, 1, 1))
    a = jnp.asarray(host)
    route = _resolve("auto", a)
    print(f"  route: {route} (batch {bsz} x {n}^2 fp32)")
    if OPTS.rehearse:
        check(route == "spec", f"CPU route is {route}, not spec")
        kernel = jax.jit(lambda x: fused_inverse(x, interpret=True))
    else:
        check(route == "fused", f"auto route is {route}, not fused")
        kernel = jax.jit(lambda x: mi.inverse(x))
    check(hlo_has_triton((lambda x: _fused_batched(x, pivot=True))
                         if OPTS.rehearse else (lambda x: mi.inverse(x)), a),
          "compiled program has no Triton kernel")
    print("  compiled program calls the Triton kernel: yes")

    (inv, ok), t_k, ts_k = timed(kernel, a)
    ok = np.asarray(ok)
    check(ok.all(), f"{int((~ok).sum())} systems flagged not ok")
    inv_h = np.asarray(inv)
    worst = max(resid_host(host[i], inv_h[i]) for i in range(64))
    report("kernel, worst of 64", worst, 1e-5)

    spec = jax.jit(lambda x: gauss_jordan_inverse(x))
    (inv_s, ok_s), t_s, ts_s = timed(spec, a)
    check(np.asarray(ok_s).all(), "jnp spec flagged a system")
    report("vmapped jnp spec, sample 0",
           resid_host(host[0], np.asarray(inv_s[0])), 1e-5)
    vendor = jax.jit(jnp.linalg.inv)
    inv_v, t_v, ts_v = timed(vendor, a)
    report("jnp.linalg.inv, sample 0",
           resid_host(host[0], np.asarray(inv_v[0])), 1e-5)
    print(f"  time per batch (median of {REPS}, ms): kernel {t_k * 1e3:.3f} "
          f"{fmt_ms(ts_k)}; vmapped jnp spec {t_s * 1e3:.3f} "
          f"{fmt_ms(ts_s)}; jnp.linalg.inv {t_v * 1e3:.3f} {fmt_ms(ts_v)}")
    print(f"  kernel vs vmapped spec: {t_s / t_k:.2f}x; "
          f"vs jnp.linalg.inv: {t_v / t_k:.2f}x")

    bad = host[:8].copy()
    bad[3] = 1.0                                   # all-ones: singular
    _, ok_bad = kernel(jnp.asarray(bad))
    ok_bad = np.asarray(ok_bad)
    check(not ok_bad[3] and ok_bad[[0, 1, 2, 4, 5, 6, 7]].all(),
          f"singular member flags wrong: {ok_bad.tolist()}")
    print("  all-ones member: ok=False, others ok=True")


@phase("flat API")
def flat_api():
    n = size(256, 48)
    a = hollow_random_matrix(n, seed=5)
    out = mi.matrix_inv_32(a.reshape(-1).tolist(), n)
    check(out.size == n * n, "matrix_inv_32 returned empty")
    report(f"matrix_inv_32 n={n}", resid_host(a, out.reshape(n, n)), 1e-5)
    res = mi.fp32_bench(a.reshape(-1), n)
    check(res.ok and res.inversa32.size == n * n, "fp32_bench failed")
    report(f"fp32_bench n={n}",
           resid_host(a, res.inversa32.reshape(n, n)), 1e-5)

    nan = a.copy()
    nan[1, 1] = np.nan
    for label, args in (("order 0", (a.reshape(-1), 0)),
                        ("order -3", (a.reshape(-1), -3)),
                        ("non-square length", (a.reshape(-1)[:-1], n)),
                        ("singular", (np.ones(n * n, np.float32), n)),
                        ("NaN input", (nan.reshape(-1), n))):
        out = mi.matrix_inv_32(*args)
        check(out.size == 0, f"matrix_inv_32 on {label} not empty")
    print("  order<=0, non-square, singular, NaN: empty")

    z = np.zeros((4, 4))
    z[0, 3], z[1, 2], z[2, 1], z[3, 0] = 2.0, 4.0, 0.5, 8.0  # zero diagonal
    check(mi.matrix_inversion_no_pivots(z.reshape(-1), 4).size == 0,
          "no-pivot inversion of a zero-diagonal matrix not empty")
    inv64 = mi.matrix_inversion_fp64(z.reshape(-1), 4).reshape(4, 4)
    check(np.array_equal(inv64, np.linalg.inv(z)),
          "pivoted FP64 inverse of the zero-diagonal matrix not exact")
    print("  no-pivot on zero diagonal: empty; pivoted FP64: exact inverse")


def scoped_ops(compiled_text: str, scope: str) -> set:
    """Names of the compiled program's instructions whose op_name metadata
    lies under ``scope`` (a ``jax.named_scope``)."""
    names = set()
    for line in compiled_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*op_name=\"([^\"]*)\"",
                     line)
        if m and f"/{scope}/" in m.group(2) + "/":
            names.add(m.group(1))
    return names


def panel_chain_share(fn, a):
    """Device time of the serial panel chain (instructions under the
    ``panel_factor`` scope) against all device time, from one profiler
    trace of ``fn(a)``. Returns a dict of seconds and shares, or None where
    the trace has no device plane (CPU rehearsal)."""
    panel_ops = scoped_ops(fn.lower(a).compile().as_text(), "panel_factor")
    trace_dir = os.path.join(OUT_DIR, "smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    jax.block_until_ready(fn(a))
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(a))
    window = time.perf_counter() - t0
    jax.profiler.stop_trace()
    paths = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir)
             for f in fs if f.endswith(".xplane.pb")]
    check(paths, "profiler wrote no trace")
    pd = jax.profiler.ProfileData.from_file(paths[0])
    panel = total = 0
    spans, lines_seen = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            # Kernel launches live on the stream lines; the "XLA Ops" /
            # "XLA Modules" lines repeat them at coarser grain.
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ev.name))
                total += ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
                if op in panel_ops or "panel_factor" in str(
                        stats.get("tf_op", "")):
                    panel += ev.duration_ns
    shutil.rmtree(trace_dir, ignore_errors=True)
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > hi:
            busy, lo = busy + hi - lo, s0
        hi = max(hi, s1)
    busy += hi - lo
    return {"panel_s": panel * 1e-9, "kernel_s": total * 1e-9,
            "busy_s": busy * 1e-9, "span_s": (spans[-1][1] - spans[0][0])
            * 1e-9 if spans else 0.0, "wall_s": window,
            "share": panel / total, "lines": sorted(lines_seen)}


@phase("blocked")
def blocked():
    n = size(4096, 256)
    host = hollow_random_matrix(n, seed=1)
    a = jnp.asarray(host)
    route = _resolve("auto", a)
    print(f"  route: {route} ({n}^2 fp32)")
    check(route == "blocked", f"auto route is {route}, not blocked")
    raw = jax.jit(lambda x: blocked_inverse(x, refine=0))
    refined = jax.jit(lambda x: mi.inverse(x))
    (inv, ok), t_raw, ts_raw = timed(raw, a)
    check(bool(ok), "blocked raw flagged not ok")
    report(f"blocked raw {n}", resid(host, inv), 1e-4)
    (inv, ok), t_ref, ts_ref = timed(refined, a)
    check(bool(ok), "blocked refined flagged not ok")
    report(f"blocked refined {n}", resid(host, inv), 1e-6)
    inv_v, t_v, ts_v = timed(jax.jit(jnp.linalg.inv), a)
    report(f"jnp.linalg.inv {n}", resid(host, inv_v), 1e-4)
    print(f"  time (median of {REPS}, ms): blocked raw {t_raw * 1e3:.3f} "
          f"{fmt_ms(ts_raw)}; blocked refined {t_ref * 1e3:.3f} "
          f"{fmt_ms(ts_ref)}; jnp.linalg.inv {t_v * 1e3:.3f} {fmt_ms(ts_v)}")

    tr = panel_chain_share(raw, a)
    if tr is None:
        print("  trace: no device plane (CPU rehearsal)")
    else:
        print(f"  trace of one raw call: panel chain {tr['panel_s'] * 1e3:.3f}"
              f" ms of {tr['kernel_s'] * 1e3:.3f} ms kernel time (share "
              f"{tr['share']:.3f}); device busy {tr['busy_s'] * 1e3:.3f} ms "
              f"of wall {tr['wall_s'] * 1e3:.3f} ms (idle share "
              f"{1 - tr['busy_s'] / tr['wall_s']:.3f}); lines {tr['lines']}")

    seam = hollow_random_matrix(1950, seed=1950) if not OPTS.rehearse \
        else hollow_random_matrix(195, seed=1950)
    inv, ok = mi.inverse(seam)
    check(bool(ok), "seam input flagged not ok")
    report(f"refined hollow n={seam.shape[0]} seed=1950", resid(seam, inv),
           1e-6)

    big = size(16384, 512)
    host_big = hollow_random_matrix(big, seed=2)
    t0 = time.perf_counter()
    inv, ok = jax.block_until_ready(
        blocked_inverse(jnp.asarray(host_big), refine=0))
    t_first = time.perf_counter() - t0
    check(bool(ok), f"blocked raw {big} flagged not ok")
    report(f"blocked raw {big} (first call {t_first:.1f} s)",
           resid(host_big, inv), 1e-4)
    del inv, host_big

    with jax.enable_x64(True):
        h64 = hollow_random_matrix(n, seed=3, dtype=np.float64)
        inv, ok = mi.inverse(jnp.asarray(h64))
        check(bool(ok), "fp64 blocked flagged not ok")
        report(f"blocked fp64 {n}", resid_host(h64, inv), 1e-12)


@phase("LAPACK family")
def lapack():
    n = size(4096, 256)
    host = hollow_random_matrix(n, seed=4)
    a = jnp.asarray(host)
    inv, ok = mi.inverse(a, method="lu")
    check(bool(ok), "LU inverse flagged not ok")
    report(f"lu/getri {n}", resid(host, inv), 1e-5)

    rhs = np.random.default_rng(6).standard_normal((n, 4)).astype(np.float32)
    x, ok = mi.solve(a, jnp.asarray(rhs), method="lu", refine_iters=1)
    check(bool(ok), "LU solve flagged not ok")
    x = np.asarray(x, np.float64)
    h = host.astype(np.float64)
    r = np.linalg.norm(h @ x - rhs) / (np.linalg.norm(h) * np.linalg.norm(x))
    report(f"lu solve {n}, refine_iters=1 (||Ax-b||/(||A|| ||x||))", r, 1e-6)

    g = np.random.default_rng(2).standard_normal((n, n))
    spd = ((g @ g.T) / n + np.eye(n)).astype(np.float32)
    inv, ok = mi.cholesky_inverse(jnp.asarray(spd))
    check(bool(ok), "potri flagged an SPD input not ok")
    report(f"cholesky/potri {n}", resid(spd, inv), 1e-6)
    indef = spd.copy()
    indef[n // 2, n // 2] = -float(n)
    _, ok = mi.cholesky_inverse(jnp.asarray(indef))
    check(not bool(ok), "potri flagged an indefinite input ok")
    print("  indefinite input: ok=False")

    k = size(1024, 128)
    m = hollow_random_matrix(k, seed=8)
    sign, logabs, ok = mi.slogdet(jnp.asarray(m))
    s_np, l_np = np.linalg.slogdet(m.astype(np.float64))
    check(bool(ok) and float(sign) == s_np, "slogdet sign mismatch")
    rel = abs(float(logabs) - l_np) / abs(l_np)
    report(f"slogdet {k} (relative logdet error)", rel, 1e-5)


@phase("four cards")
def four_cards():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gpu_matrix_inversion_tpu.parallel import (make_device_mesh,
                                                   sharded_batched_inverse,
                                                   sharded_blocked_inverse)
    platform = "cpu" if OPTS.rehearse else "gpu"
    mesh = make_device_mesh(4, ("x",), platform=platform)
    devs = list(np.ravel(mesh.devices))
    check(len({d.id for d in devs}) == 4
          and all(d.platform == platform for d in devs),
          f"mesh is not four distinct {platform} devices: {devs}")
    print(f"  mesh: {mesh.shape} over {[str(d) for d in devs]}")

    n = size(16384, 512)
    host = hollow_random_matrix(n, seed=2)
    t0 = time.perf_counter()
    inv_sh, ok = jax.block_until_ready(
        sharded_blocked_inverse(host, mesh=mesh, refine=0))
    print(f"  sharded {n}^2 first call {time.perf_counter() - t0:.1f} s")
    check(bool(ok), "sharded inverse flagged not ok")
    run = lambda x: sharded_blocked_inverse(x, mesh=mesh, refine=0)  # noqa
    rep = jax.device_put(jnp.asarray(host), NamedSharding(mesh, P()))
    (inv_sh, ok), t_sh, ts_sh = timed(run, rep, reps=3)
    inv_sh = jax.device_put(inv_sh, devs[0])
    a0 = jax.device_put(jnp.asarray(host), devs[0])
    r_sh = resid(a0, inv_sh)
    report(f"sharded raw {n} on 4 cards", r_sh, 1e-4)
    single = jax.jit(lambda x: blocked_inverse(x, refine=0))
    (inv_1, ok1), t_1, ts_1 = timed(single, a0, reps=3)
    check(bool(ok1), "single-card blocked flagged not ok")
    r_1 = resid(a0, inv_1)
    report(f"single-card blocked raw {n}", r_1, 1e-4)
    with jax.enable_x64(True):
        x1 = inv_1.astype(jnp.float64)
        diff = float(jnp.linalg.norm(inv_sh.astype(jnp.float64) - x1)
                     / jnp.linalg.norm(x1))
        kappa = float(jnp.linalg.norm(a0.astype(jnp.float64))
                      * jnp.linalg.norm(x1))
    # X - A^-1 = A^-1 (AX - I), so each result's relative forward error is
    # at most its normwise residual times ||A||_F ||X||_F; two results can
    # differ by the sum (factor 2 for X standing in for A^-1).
    bound = 2 * (r_sh + r_1) * kappa
    print(f"  ||X_sharded - X_single||_F / ||X_single||_F = {diff:.3e} "
          f"(bound {bound:.3e} from the residuals and ||A||_F ||X||_F = "
          f"{kappa:.3e})")
    check(diff <= bound, f"sharded and single-card results differ: {diff}")
    print(f"  time (median of 3, ms): sharded {t_sh * 1e3:.3f} "
          f"{fmt_ms(ts_sh)}; single card {t_1 * 1e3:.3f} {fmt_ms(ts_1)}")
    del inv_sh, inv_1, a0, rep

    mesh2 = make_device_mesh((2, 2), ("dp", "tp"), platform=platform)
    nb, bsz = size(1024, 128), 8
    batch = np.stack([hollow_random_matrix(nb, seed=40 + s)
                      for s in range(bsz)])
    inv_b, ok_b = sharded_batched_inverse(batch, mesh=mesh2)
    check(bool(np.all(np.asarray(ok_b))), "dp x tp batch flagged not ok")
    inv_b = np.asarray(inv_b)
    worst = max(resid_host(batch[i], inv_b[i]) for i in range(bsz))
    report(f"dp x tp (2, 2) batch {bsz} x {nb}^2, worst", worst, 1e-4)


def main() -> int:
    d0 = device_header()
    if not OPTS.rehearse and d0.platform != "gpu":
        print(f"no GPU: JAX's first device is on {d0.platform!r}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if OPTS.four_cards:
        four_cards()
    else:
        batched()
        flat_api()
        blocked()
        lapack()
    print(f"total {time.perf_counter() - t0:.1f} s")
    if OPTS.rehearse:
        print("rehearsal passed (no result line off the card)")
        return 0
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
