"""Run configuration: a real flag system.

The reference selects variant/size/pivoting/seed with compile-time
``#define FP32 / N / REP / PIVOTS / RAND`` (``main_file.cpp:14-18``) and
env vars (``PYOPENCL_CTX``, ``matrix_inv_pyopencl.py:10-11``); changing any
of them means rebuilding. Here the same knobs are a dataclass, settable from
kwargs, environment, or CLI flags.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class InversionConfig:
    """All knobs of an inversion run (reference main_file.cpp:14-18)."""

    dtype: str = "float32"        # FP32/FP64 variant selection
    pivot: bool = True            # PIVOTS
    method: str = "auto"          # which algorithm family
    block_size: int = 128         # blocked-path panel width
    precision: str = "highest"    # matmul precision for trailing updates
    refine_iters: int = 0         # Newton-Schulz refinement steps
    repeat: int = 1               # REP (timed repetitions)
    seed: int = 0                 # RAND

    ENV_PREFIX = "MATINV_"

    @classmethod
    def from_env(cls, **overrides) -> "InversionConfig":
        """Read ``MATINV_*`` environment variables, then apply overrides."""
        kwargs = {}
        for field in dataclasses.fields(cls):
            raw = os.environ.get(cls.ENV_PREFIX + field.name.upper())
            if raw is None:
                continue
            if field.type == "bool":
                kwargs[field.name] = raw.lower() in ("1", "true", "yes", "on")
            elif field.type == "int":
                kwargs[field.name] = int(raw)
            else:
                kwargs[field.name] = raw
        kwargs.update(overrides)
        return cls(**kwargs)

    def validate(self) -> "InversionConfig":
        from gpu_matrix_inversion_tpu.models.solver import METHODS
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"bad dtype {self.dtype!r}")
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}")
        if self.precision not in ("default", "high", "highest"):
            raise ValueError(f"bad precision {self.precision!r}")
        if self.block_size <= 0 or self.repeat <= 0:
            raise ValueError("block_size and repeat must be positive")
        return self


_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    The benchmark drivers (bench.py, benchmarks/sweep.py, chip_smoke.py)
    compile a dozen large programs per process; the persistent cache turns
    re-runs into cache loads. The reference has no analog -- OpenCL
    JIT-compiles its kernel strings every call (``FP32_bench.cpp:280-293``).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here; otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` (a fixed path, since the path is part of the
    cache key). Disable with ``MATINV_COMPILE_CACHE=0``. Returns the
    directory in use, or None when disabled.
    """
    if os.environ.get("MATINV_COMPILE_CACHE", "1").lower() in (
            "0", "false", "no", "off"):
        return None
    import jax
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = _CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
