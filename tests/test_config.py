"""Tests of the config system, Inverter session, and observability utils
(reference #define flags -> runtime config; SURVEY.md section 5)."""

import io
import os

import numpy as np
import pytest

from gpu_matrix_inversion_tpu.models.solver import Inverter
from gpu_matrix_inversion_tpu.utils.config import InversionConfig
from gpu_matrix_inversion_tpu.utils.profiling import (
    device_info,
    print_phase_report,
)
from gpu_matrix_inversion_tpu.utils.generators import hollow_random_matrix
from gpu_matrix_inversion_tpu.utils.residual import relative_residual


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("MATINV_DTYPE", "float64")
    monkeypatch.setenv("MATINV_PIVOT", "0")
    monkeypatch.setenv("MATINV_BLOCK_SIZE", "64")
    cfg = InversionConfig.from_env()
    assert cfg.dtype == "float64" and cfg.pivot is False
    assert cfg.block_size == 64
    cfg2 = InversionConfig.from_env(pivot=True)
    assert cfg2.pivot is True  # overrides beat env


def test_config_validation():
    with pytest.raises(ValueError):
        InversionConfig(dtype="float16").validate()
    with pytest.raises(ValueError):
        InversionConfig(method="nope").validate()
    with pytest.raises(ValueError):
        InversionConfig(block_size=0).validate()


def test_inverter_session():
    a = hollow_random_matrix(64, seed=80)
    inv = Inverter(dtype="float32", method="spec")
    x, ok = inv.inverse(a)
    assert bool(ok)
    assert relative_residual(a, np.asarray(x)) < 1e-5


def test_inverter_refinement_improves():
    a = hollow_random_matrix(96, seed=81)
    raw, _ = Inverter(dtype="float32", method="spec").inverse(a)
    ref, ok = Inverter(dtype="float32", method="spec",
                       refine_iters=2).inverse(a)
    assert bool(ok)
    assert (relative_residual(a, np.asarray(ref))
            <= relative_residual(a, np.asarray(raw)) * 1.5)


def test_device_info():
    info = device_info()
    assert info["device_count"] >= 1
    assert "device_kind" in info["devices"][0]


def test_phase_report():
    from gpu_matrix_inversion_tpu import fp32_bench
    a = hollow_random_matrix(32, seed=82)
    res = fp32_bench(a.reshape(-1), 32)
    buf = io.StringIO()
    print_phase_report(res, 32, out=buf)
    text = buf.getvalue()
    assert "total_compute" in text and "gflops(4N^3)" in text and "ok" in text


def test_sweep_resume(tmp_path):
    from gpu_matrix_inversion_tpu.benchmarks.sweep import main
    out = tmp_path / "rows.txt"
    main(["--numpy-baseline", "--max-n", "30", "--out", str(out)])
    first = out.read_text().strip().splitlines()
    assert len(first) == 3
    # resume: nothing new below 30, one new row at 40
    main(["--numpy-baseline", "--max-n", "40", "--out", str(out), "--resume"])
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 4
    assert rows[-1].startswith("40 ")


def test_inverter_sharded_method():
    import jax
    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs virtual CPU devices")
    from gpu_matrix_inversion_tpu.parallel import make_device_mesh
    mesh = make_device_mesh(4, ("x",), platform="cpu")
    a = hollow_random_matrix(64, seed=83)
    inv = Inverter(dtype="float32", method="sharded", block_size=16,
                   mesh=mesh)
    x, ok = inv.inverse(a)
    assert bool(ok)
    assert relative_residual(a, np.asarray(x)) < 1e-5


def test_compile_cache_default_dir(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache lives at the fixed
    in-checkout .jax_cache, and that directory is set on JAX's config."""
    import jax
    from gpu_matrix_inversion_tpu.utils import config as C

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("MATINV_COMPILE_CACHE", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        got = C.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_respects_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code
    (JAX reads the variable itself); disabling returns None."""
    import jax
    from gpu_matrix_inversion_tpu.utils import config as C

    monkeypatch.delenv("MATINV_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    prev = jax.config.jax_compilation_cache_dir
    calls = []
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: (calls.append(k), real_update(k, v)))
    try:
        assert C.enable_compile_cache() == "/elsewhere/cache"
        assert "jax_compilation_cache_dir" not in calls
        monkeypatch.setenv("MATINV_COMPILE_CACHE", "0")
        assert C.enable_compile_cache() is None
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", prev)
