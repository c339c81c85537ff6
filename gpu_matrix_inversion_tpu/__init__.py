"""Dense matrix-inversion library for NVIDIA GPUs (JAX / XLA / Pallas).

Re-implements the capabilities of the OpenCL reference
``MarchesiGabriele/gpu_matrix_inversion`` (see ``SURVEY.md``):

- Gauss-Jordan inversion of the augmented ``[A|I]`` system with partial
  pivoting (reference ``matrix_inversion_FP32.cpp`` / ``_FP64.cpp``) and
  without pivoting (``matrix_inversion_no_pivots.cpp``), at FP32 and FP64.
- The ``matrix_inv_32``-style product API: flat row-major vector + order in,
  inverse as flat vector out, *empty vector* on invalid or singular input
  (reference ``Matlab/mat_inv_32.h:4``, ``mat_inv_32.cpp:206-215``).
- Benchmark variants returning a ``Res``-style phase-timing record
  (reference ``FP32_bench.cpp``, ``res_struct.h``).
- A verification GEMM + Frobenius residual (reference ``matrix_multiply.cpp``).

The design replaces the reference's per-iteration kernel quintuple (argmax
-> swap -> normalize -> eliminate, launched N times from the host) with a
fused Pallas (Triton) kernel that runs every step of a small system in one
program, a blocked right-looking variant whose trailing updates are rank-k
GEMMs, an LU+getri path with iterative refinement, Cholesky for SPD input,
and a panel-sharded multi-device path over a device mesh.
"""

from gpu_matrix_inversion_tpu.api import (
    Res,
    matrix_inv_32,
    matrix_inversion_fp32,
    matrix_inversion_fp64,
    matrix_inversion_no_pivots,
    fp32_bench,
    fp64_bench,
    no_pivots_bench,
    matrix_multiply,
)
from gpu_matrix_inversion_tpu.ops.gauss_jordan import gauss_jordan_inverse
from gpu_matrix_inversion_tpu.ops.cholesky import (
    cholesky_factor,
    cholesky_inverse,
    cholesky_solve,
)
from gpu_matrix_inversion_tpu.ops.lu import det, invert_triangular, slogdet
from gpu_matrix_inversion_tpu.models.solver import inverse, solve, Inverter
from gpu_matrix_inversion_tpu.utils.config import InversionConfig

__version__ = "0.1.0"

__all__ = [
    "Res",
    "matrix_inv_32",
    "matrix_inversion_fp32",
    "matrix_inversion_fp64",
    "matrix_inversion_no_pivots",
    "fp32_bench",
    "fp64_bench",
    "no_pivots_bench",
    "matrix_multiply",
    "gauss_jordan_inverse",
    "cholesky_factor",
    "cholesky_inverse",
    "cholesky_solve",
    "det",
    "slogdet",
    "invert_triangular",
    "inverse",
    "solve",
    "Inverter",
    "InversionConfig",
    "__version__",
]
