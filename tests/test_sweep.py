"""Smoke tests of the benchmark sweep CLI (reference protocol parity)."""

import io

from gpu_matrix_inversion_tpu.benchmarks.sweep import (
    reference_sizes,
    sweep_numpy,
    sweep_device,
)


def test_reference_ramp():
    # main_file.cpp:73-78: 10 -> 2000 step 10, then step 1000.
    sizes = list(reference_sizes(4000))
    assert sizes[0] == 10 and sizes[1] == 20
    assert 2000 in sizes and 3000 in sizes and 4000 in sizes
    assert 2010 not in sizes


def test_numpy_sweep_rows():
    out = io.StringIO()
    sweep_numpy(30, out)
    rows = out.getvalue().strip().splitlines()
    assert len(rows) == 3  # N = 10, 20, 30
    n, t, err, resid = rows[0].split()
    assert int(n) == 10 and float(t) >= 0 and abs(float(err)) < 1e-3


def test_device_sweep_rows():
    out = io.StringIO()
    sweep_device(20, out, method="spec", repeat=1)
    rows = out.getvalue().strip().splitlines()
    assert len(rows) == 2
    cols = rows[-1].split()
    assert int(cols[0]) == 20 and len(cols) == 8
    assert float(cols[7]) < 1e-4  # normalized residual column


def test_device_sweep_sharded_method():
    """--method sharded drives the mesh path through the same protocol
    (on the CPU suite: a mesh over the 8 virtual devices)."""
    out = io.StringIO()
    sweep_device(0, out, method="sharded", repeat=1, sizes=[64])
    cols = out.getvalue().strip().splitlines()[-1].split()
    assert int(cols[0]) == 64 and len(cols) == 8
    assert float(cols[7]) < 1e-4


def test_device_sweep_amortized_column():
    out = io.StringIO()
    sweep_device(20, out, method="spec", repeat=1, amortize=3)
    rows = out.getvalue().strip().splitlines()
    cols = rows[-1].split()
    assert len(cols) == 9  # trailing amortized per-inversion time
    assert float(cols[8]) >= 0.0


def test_device_sweep_spd_cholesky():
    """--spd generates SPD inputs so --method cholesky sweeps cleanly."""
    out = io.StringIO()
    sweep_device(0, out, method="cholesky", repeat=1, sizes=[48, 96], spd=True)
    rows = out.getvalue().strip().splitlines()
    assert len(rows) == 2
    for row in rows:
        cols = row.split()
        assert len(cols) == 8
        assert float(cols[7]) < 1e-5  # SPD potri residual tier
