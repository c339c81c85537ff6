"""Solver families: Gauss-Jordan (fused/blocked), LU, Cholesky (SPD),
Newton-Schulz, mixed-precision refinement."""
import numpy as np
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu as mi
from gpu_matrix_inversion_tpu.ops import (lu_factor_blocked, lu_solve_fast,
                                          lu_inverse_refined)

n = 512
a = np.random.default_rng(2).uniform(0, 100, (n, n)).astype(np.float32)
np.fill_diagonal(a, 0)

x_gj, _ = mi.inverse(a, method="blocked")     # blocked GEMM Gauss-Jordan
x_lu, _ = mi.inverse(a, method="lu")          # blocked getrf + getri

# Solve without forming the inverse (the reference can't):
b = np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32)
lu, perm, ok = lu_factor_blocked(a)
x, ok2 = lu_solve_fast(lu, perm, b)

# FP32 factor, FP64-level residual (BASELINE configs[3]):
x_ref, _ = lu_inverse_refined(a, iters=2)

# SPD input: Cholesky potri -- half the LU MACs, no pivot search, and the
# determinant falls out of either factorization:
spd = (a @ a.T) / n + n * np.eye(n, dtype=np.float32)
x_spd, ok_spd = mi.inverse(spd, method="cholesky")
sign, logabs, _ = mi.slogdet(a)

# Config-driven session (the reference's #define knobs at runtime):
inv = mi.Inverter(dtype="float32", method="blocked", refine_iters=1)
x_best, ok3 = inv.inverse(a)
print("done:", bool(ok), bool(ok2), bool(ok3))
