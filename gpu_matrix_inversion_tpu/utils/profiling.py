"""Tracing / profiling / observability.

The reference instruments with (a) std::chrono wall-clock spans around every
phase and (b) OpenCL event profiling on the hot kernel, printing phase
traces and derived GFLOPS to stdout (``matrix_inversion_FP32.cpp:256-263``,
``matrix_inversion_FP64.cpp:751-755``; SURVEY.md section 5). Equivalents
here:

- :func:`trace`: wraps ``jax.profiler`` to capture an XLA trace viewable in
  TensorBoard/Perfetto (replaces per-kernel CL event timing -- the XLA
  profile shows every fused kernel on the device timeline).
- :func:`device_info`: the startup device-capability dump
  (FP32.cpp:304-333).
- :func:`print_phase_report`: the per-phase stdout trace from a ``Res``
  (FP32.cpp:711-723), with the reference's GFLOPS models applied
  (fixColumn total: ``4*N^3 / t``; FP64.cpp:753-755).
"""

from __future__ import annotations

import contextlib
import logging

logger = logging.getLogger("gpu_matrix_inversion_tpu")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_info() -> dict:
    """Device-capability dump (reference FP32.cpp:304-333 prints
    CL_DEVICE_* attributes: max workgroup size, global/local memory,
    compute units). Equivalents here: platform, device kind, and device
    memory limit/usage from the runtime's memory stats.
    """
    import jax
    devs = jax.devices()

    def one(d):
        entry = {
            "id": d.id,
            "platform": getattr(d, "platform", "?"),
            "device_kind": getattr(d, "device_kind", "?"),
            "num_cores_on_chip": getattr(d, "core_count", None),
        }
        try:
            stats = d.memory_stats() or {}
            entry["memory_bytes_limit"] = stats.get("bytes_limit")
            entry["memory_bytes_in_use"] = stats.get("bytes_in_use")
            entry["memory_peak_bytes_in_use"] = stats.get(
                "peak_bytes_in_use")
        except Exception:  # pragma: no cover - backends without stats
            pass
        return {k: v for k, v in entry.items() if v is not None}

    info = {
        "backend": jax.default_backend(),
        "device_count": len(devs),
        "devices": [one(d) for d in devs],
    }
    return info


def print_phase_report(res, order: int, out=None) -> None:
    """Per-phase stdout trace + derived GFLOPS (reference's verbose paths)."""
    import sys
    out = out or sys.stdout
    t = res.times
    print(f"matrix order: {order}", file=out)
    for key in ("buffers", "compile", "make_augmented", "pivot", "row",
                "column", "total_compute", "identity_check",
                "get_inverted", "total"):
        if key in t:
            print(f"  {key:>14}: {t[key] * 1e3:10.3f} ms", file=out)
    if getattr(res, "identity_error", None) is not None:
        # Strict identity self-check (reference FP32.cpp:814-835).
        print(f"  {'max|AX-I|':>14}: {res.identity_error:10.3e}", file=out)
    tc = t.get("total_compute")
    if tc:
        # The reference's fixColumn flop model: 4*N^3 total
        # (matrix_inversion_FP64.cpp:753-755).
        print(f"  {'gflops(4N^3)':>14}: {4 * order**3 / tc / 1e9:10.1f}",
              file=out)
    print(f"  {'status':>14}: {'ok' if res.ok else 'FAILED'}", file=out)
