"""Golden tests of the fused Pallas (Triton) kernel vs the jnp spec / numpy.
Runs in Pallas interpret mode on CPU; tests/test_gpu_oracle.py runs it
compiled on a CUDA device."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_matrix_inversion_tpu.ops.fused import (FUSED_MAX_N, _padded_order,
                                                fused_inverse)
from gpu_matrix_inversion_tpu.ops.gauss_jordan import gauss_jordan_inverse
from gpu_matrix_inversion_tpu.utils.generators import (hollow_random_matrix,
                                                       well_conditioned_matrix)
from gpu_matrix_inversion_tpu.utils.residual import relative_residual


def _fused(a, **kw):
    return fused_inverse(a, interpret=True, **kw)


def test_fused_128():
    a = hollow_random_matrix(128, seed=20)
    inv, ok = _fused(a)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_fused_padding_non_multiple():
    a = hollow_random_matrix(100, seed=21)
    inv, ok = _fused(a)
    assert bool(ok)
    assert inv.shape == (100, 100)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("n", [8, 16, 37, 64, 128])
def test_fused_matches_spec(n, pivot):
    """The kernel against the jnp spec at every padding regime (n=8 and 37
    pad to the next power of two, 16/64/128 are exact): same inverse to
    fp32 rounding, same ok flag."""
    if pivot:
        a = hollow_random_matrix(n, seed=200 + n)
    else:
        a = well_conditioned_matrix(n, seed=200 + n)
    inv, ok = _fused(a, pivot=pivot)
    ref, ok_ref = gauss_jordan_inverse(jnp.asarray(a), pivot=pivot)
    assert bool(ok) and bool(ok_ref)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(np.asarray(inv), np.asarray(ref),
                               atol=1e-4 * scale)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_fused_padded_order():
    """Power-of-two padding with a floor of 16 (never the old multiple of
    128: n=32 used to pay 16x the work)."""
    assert [_padded_order(n) for n in (1, 8, 16, 17, 37, 64, 100, 128)] == [
        16, 16, 16, 32, 64, 64, 128, 128]


def test_fused_batched():
    a = np.stack([hollow_random_matrix(64, seed=s) for s in range(3)])
    inv, ok = _fused(a)
    assert inv.shape == a.shape
    assert bool(np.all(np.asarray(ok)))
    for i in range(3):
        assert relative_residual(a[i], np.asarray(inv)[i]) < 1e-5


def test_fused_batch_shapes():
    """Leading batch axes of any rank, an odd batch, and a padded order:
    each system is its own program, so nothing pads the batch."""
    a = np.stack([hollow_random_matrix(24, seed=s) for s in range(6)])
    a = a.reshape(3, 2, 24, 24)
    inv, ok = _fused(a)
    assert inv.shape == a.shape and np.asarray(ok).shape == (3, 2)
    assert bool(np.all(np.asarray(ok)))
    flat = a.reshape(6, 24, 24)
    for i in range(6):
        assert relative_residual(flat[i],
                                 np.asarray(inv).reshape(6, 24, 24)[i]) < 1e-5


def test_fused_singular_flagged():
    a = np.zeros((32, 32), dtype=np.float32)
    _, ok = _fused(a)
    assert not bool(ok)


def test_fused_nan_and_singular_member_flagged():
    """Only the bad members of a batch are flagged: an all-ones matrix
    (exact zero pivot) and a NaN matrix (non-finite result)."""
    good = hollow_random_matrix(16, seed=9)
    ones = np.ones((16, 16), np.float32)
    nan = good.copy()
    nan[3, 5] = np.nan
    _, ok = _fused(np.stack([good, ones, nan, good]))
    assert np.asarray(ok).tolist() == [True, False, False, True]


def test_fused_rejects_fp64():
    a = hollow_random_matrix(32, seed=22, dtype=np.float64)
    with pytest.raises(NotImplementedError):
        _fused(a)


def test_fused_rejects_oversize():
    a = np.eye(FUSED_MAX_N + 1, dtype=np.float32)
    with pytest.raises(NotImplementedError):
        _fused(a)


def test_fused_requires_gpu_without_interpret():
    """Off CUDA the kernel never runs quietly in the interpreter: without
    interpret=True it refuses."""
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_inverse(hollow_random_matrix(16, seed=1))


def test_fused_no_pivot():
    a = well_conditioned_matrix(64, seed=23)
    inv, ok = _fused(a, pivot=False)
    assert bool(ok)
    assert relative_residual(a, np.asarray(inv)) < 1e-5


def test_fused_bfloat16_smoke():
    a = hollow_random_matrix(64, seed=24).astype(jnp.bfloat16)
    inv, ok = _fused(a)
    assert bool(ok)
    assert inv.dtype == jnp.bfloat16
    # bf16 has ~3 significant digits; loose gate.
    assert relative_residual(np.asarray(a, np.float64),
                             np.asarray(inv, np.float64)) < 1e-2


def test_blocked_bfloat16_io():
    """bf16 blocked path: bf16 in/out, fp32 compute."""
    from gpu_matrix_inversion_tpu.ops.blocked import blocked_inverse
    a = hollow_random_matrix(160, seed=31).astype(jnp.bfloat16)
    inv, ok = blocked_inverse(a, block_size=64, refine=0)
    assert bool(ok) and inv.dtype == jnp.bfloat16
    a64 = np.asarray(a, np.float64)
    inv64 = np.asarray(inv, np.float64)
    r = np.linalg.norm(a64 @ inv64 - np.eye(160)) / (
        np.linalg.norm(a64) * np.linalg.norm(inv64))
    assert r < 5e-3  # bf16 output quantization floor
