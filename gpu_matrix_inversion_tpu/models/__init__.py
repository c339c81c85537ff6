"""Solver families and algorithm dispatch.

The reference ships one algorithm family (Gauss-Jordan, pivoted/unpivoted,
FP32/FP64) selected by compile-time ``#define``s (``main_file.cpp:14-18``).
Here, families are first-class: the dispatcher in ``solver.py`` picks between
the pure-jnp spec, the fused Pallas kernel, the blocked GEMM path, and the
LU+getri path based on size, batch, and dtype -- or an explicit ``method=``.
"""

from gpu_matrix_inversion_tpu.models.solver import inverse, solve, METHODS

__all__ = ["inverse", "solve", "METHODS"]
