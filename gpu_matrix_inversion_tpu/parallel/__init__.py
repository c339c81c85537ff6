"""Multi-chip execution: device meshes and panel-sharded inversion.

The reference runs on exactly one GPU (``platforms[0]/devices[0]``,
matrix_inversion_FP32.cpp:293; SURVEY.md section 2 parallelism checklist).
This package is the scaling story the reference never had: the augmented
system column-sharded over a device mesh via ``shard_map``, one pivot-strip
broadcast (``psum``) per panel group, trailing updates as local GEMMs
(BASELINE.md configs[4], 16384^2 and beyond one device's memory).
"""

from gpu_matrix_inversion_tpu.parallel.mesh import make_device_mesh
from gpu_matrix_inversion_tpu.parallel.sharded import (
    sharded_blocked_inverse,
    sharded_batched_inverse,
)

__all__ = [
    "make_device_mesh",
    "sharded_blocked_inverse",
    "sharded_batched_inverse",
]
