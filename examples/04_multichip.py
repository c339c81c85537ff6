"""Multi-device: panel-sharded inversion over a device mesh (BASELINE
configs[4]). Run on the cards of one host, or simulate with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu."""
import jax
import numpy as np
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu as mi
from gpu_matrix_inversion_tpu.parallel import (make_device_mesh,
                                               sharded_batched_inverse)

nd = len(jax.devices())
mesh = make_device_mesh(nd, ("x",))                # 1D tensor-parallel
n = 512
a = np.random.default_rng(4).uniform(0, 100, (n, n)).astype(np.float32)
np.fill_diagonal(a, 0)
x, ok = mi.inverse(a, method="sharded", mesh=mesh, block_size=64)
print("sharded ok:", bool(ok))

# 2D dp x tp mesh: batch over dp, columns over tp.
mesh2 = make_device_mesh((2, nd // 2), ("dp", "tp"))
batch = np.stack([a[:128, :128]] * 4) + np.eye(128, dtype=np.float32)
xb, okb = sharded_batched_inverse(batch, mesh=mesh2, block_size=32)
print("dp x tp ok:", bool(np.all(np.asarray(okb))))
