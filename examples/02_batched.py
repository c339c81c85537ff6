"""Batched inversion: 4096 matrices of 128x128 in one kernel launch
(BASELINE.md configs[2] -- the reference has no batched mode)."""
import numpy as np
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu as mi

batch = np.random.default_rng(1).uniform(0, 100, (64, 128, 128)).astype(np.float32)
inv, ok = mi.inverse(batch)            # one Triton program per system on a GPU
print("all ok:", bool(np.all(np.asarray(ok))), "shape:", inv.shape)
