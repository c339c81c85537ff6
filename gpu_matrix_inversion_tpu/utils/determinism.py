"""Determinism checking: the accelerator-era analog of race detection.

The reference has no sanitizers; its correctness rests on in-order queue
semantics and in-kernel barriers, with known fragilities SURVEY.md section 5
says not to replicate (barrier inside divergent control flow, out-of-bounds
padding writes). Here the equivalent failure mode is nondeterminism from
unstable reductions, uninitialized scratch, or races in hand-written
kernels. This utility catches all of those the same way a race detector
would: run the computation twice (optionally with a scratch-poisoning run in
between) and demand bit-identical results.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import jax


def check_deterministic(fn: Callable, *args, runs: int = 3,
                        perturb: bool = True) -> Tuple[bool, float]:
    """Run ``fn(*args)`` ``runs`` times; return ``(bit_identical, max_diff)``.

    ``perturb=True`` interleaves a differently-shaped dummy computation
    between runs so reused scratch buffers hold garbage -- an
    uninitialized-read bug then shows up as run-to-run drift.
    """
    outs = []
    for i in range(runs):
        if perturb and i > 0:
            # Poison device scratch with an unrelated computation.
            import jax.numpy as jnp
            junk = jnp.full((257, 129), np.nan, jnp.float32)
            jax.block_until_ready(junk * junk)
        out = fn(*args)
        outs.append([np.asarray(x) for x in jax.tree.leaves(out)])
    max_diff = 0.0
    identical = True
    first = outs[0]
    for other in outs[1:]:
        for a, b in zip(first, other):
            if a.dtype.kind in "fc":
                if not np.array_equal(a, b, equal_nan=True):
                    identical = False
                    diff = np.abs(a.astype(np.float64) -
                                  b.astype(np.float64))
                    max_diff = max(max_diff, float(np.nanmax(diff)))
            elif not np.array_equal(a, b):
                identical = False
                max_diff = float("inf")
    return identical, max_diff
