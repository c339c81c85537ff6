"""Tests of the blocked (rank-b GEMM trailing update) Gauss-Jordan path."""

import numpy as np

from gpu_matrix_inversion_tpu.ops.blocked import blocked_inverse
from gpu_matrix_inversion_tpu.utils.generators import (
    hollow_random_matrix,
    well_conditioned_matrix,
)
from gpu_matrix_inversion_tpu.utils.residual import relative_residual


def test_blocked_256():
    a = hollow_random_matrix(256, seed=30)
    inv, ok = blocked_inverse(a, block_size=128)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_blocked_padding():
    a = hollow_random_matrix(200, seed=31)
    inv, ok = blocked_inverse(a, block_size=64)
    assert bool(ok)
    assert inv.shape == (200, 200)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_blocked_512_matches_numpy():
    a = hollow_random_matrix(512, seed=32)
    inv, ok = blocked_inverse(a, block_size=128)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_blocked_fp64():
    a = hollow_random_matrix(160, seed=33, dtype=np.float64)
    inv, ok = blocked_inverse(a, block_size=64)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-14


def test_blocked_singular_flagged():
    a = np.ones((128, 128), dtype=np.float32)
    _, ok = blocked_inverse(a, block_size=64)
    assert not bool(ok)


def test_blocked_no_pivot():
    a = well_conditioned_matrix(128, seed=34)
    inv, ok = blocked_inverse(a, pivot=False, block_size=64)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_blocked_batched():
    a = np.stack([hollow_random_matrix(128, seed=s) for s in (40, 41)])
    inv, ok = blocked_inverse(a, block_size=64)
    assert inv.shape == a.shape
    assert bool(np.all(np.asarray(ok)))


def test_default_group_size_divides_panels():
    """At m <= 8192 the default group divides the panel count (no unrolled
    tail group after the full ones); past 8192 the gw=1024 target stands,
    and callers without a panel count get gw~1536."""
    from gpu_matrix_inversion_tpu.ops.blocked import _default_group_size

    assert _default_group_size(128, 32) == 8      # 4096^2: gw=1024, no tail
    assert _default_group_size(128, 64) == 8      # 8192^2: gw=1024
    assert _default_group_size(64, 256) == 16     # 16384^2 b=64: gw=1024
    assert _default_group_size(128, 16) == 8      # 2048^2: divides
    assert 32 % _default_group_size(128, 32) == 0
    # Legacy callers without a panel count keep the r3 rule.
    assert _default_group_size(128) == 12
    assert _default_group_size(64) == 24
