"""Tests of the Newton-Schulz solver family."""

import numpy as np
import pytest

from gpu_matrix_inversion_tpu.models.newton_schulz import newton_schulz_inverse
from gpu_matrix_inversion_tpu.models.solver import inverse
from gpu_matrix_inversion_tpu.utils.generators import (
    well_conditioned_matrix, hollow_random_matrix)
from gpu_matrix_inversion_tpu.utils.residual import relative_residual


def test_newton_schulz_well_conditioned():
    a = well_conditioned_matrix(96, seed=90)
    x, ok = newton_schulz_inverse(a, iters=25)
    assert bool(ok)
    assert relative_residual(a, np.asarray(x)) < 1e-5


def test_newton_schulz_mixed_precision():
    a = well_conditioned_matrix(128, seed=91)
    x, ok = newton_schulz_inverse(a, iters=30, mixed=True)
    assert bool(ok)
    assert relative_residual(a, np.asarray(x)) < 1e-5


def test_newton_schulz_flags_nonconvergence():
    # Singular matrix: NS cannot converge; ok must be False.
    a = np.ones((32, 32), dtype=np.float32)
    _, ok = newton_schulz_inverse(a, iters=10)
    assert not bool(ok)


def test_newton_schulz_gate_is_scale_invariant():
    """VERDICT r3 weak #6: the ok gate must be the normwise RELATIVE
    backward error, so (a) a non-converged ill-conditioned input reports
    ok=False, and (b) rescaling A never flips the verdict (the old
    ``rnorm < 1e-3 * n`` absolute gate did both wrong)."""
    rng = np.random.default_rng(93)
    n = 192
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((q * np.logspace(0, -7, n)) @ q.T).astype(np.float32)  # cond ~1e7
    x, ok = newton_schulz_inverse(a, iters=8)
    assert relative_residual(a, np.asarray(x)) > 1e-3  # truly unconverged
    assert not bool(ok)
    # Scaling the unconverged input down must not buy an ok=True.
    _, ok_dn = newton_schulz_inverse(a * np.float32(1e-6), iters=8)
    assert not bool(ok_dn)
    # A converged inverse must stay ok=True under heavy rescaling in both
    # directions (the absolute gate failed the up-scaled one).
    b = well_conditioned_matrix(96, seed=94)
    for s in (1e-6, 1e6):
        _, ok_s = newton_schulz_inverse((b * s).astype(np.float32), iters=30)
        assert bool(ok_s), f"converged inverse flagged not-ok at scale {s}"


def test_solver_ns_method():
    a = well_conditioned_matrix(64, seed=92)
    x, ok = inverse(a, method="ns")
    assert bool(ok)
    assert relative_residual(a, np.asarray(x)) < 1e-5


def test_refine_keeps_miscompile_barrier():
    """The optimization_barrier guards in ops/refine.py are load-bearing:
    they pin the fusion seam that a compiler rewrite once crossed,
    corrupting refined inverses by orders of magnitude (hollow n=1950,
    invisible on CPU -- see the comment at the guard; chip_smoke.py checks
    that input on the card). CPU tests cannot observe the numeric failure,
    so assert the barrier survives in the traced program structurally."""
    import jax
    import jax.numpy as jnp
    from gpu_matrix_inversion_tpu.ops.refine import (newton_schulz_refine,
                                                     refine_solve)

    def barrier_eqns(jaxpr):
        """All optimization_barrier eqns, each with its enclosing jaxpr
        (recursing into pjit/scan/cond sub-jaxprs)."""
        found = [(e, jaxpr) for e in jaxpr.eqns
                 if e.primitive.name == "optimization_barrier"]
        for eqn in jaxpr.eqns:
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        found.extend(barrier_eqns(inner))
        return found

    a = jnp.eye(8, dtype=jnp.float32)
    x = jnp.eye(8, dtype=jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda a, x: newton_schulz_refine(a, x, iters=1))(a, x)
    found = barrier_eqns(jaxpr.jaxpr)
    assert found
    # Placement, not just presence (ADVICE r2): the guarded seam is the
    # refine ENTRY x -- some barrier must consume a function argument of
    # its enclosing jaxpr directly, which is where the producer's gather
    # chain meets the refine GEMMs.
    assert any(any(iv in j.invars for iv in e.invars) for e, j in found)

    # refine_solve barriers its entry x AND every per-iteration correction
    # d (each reaches the loop through lu_solve's gather chain): expect
    # iters + 1 barriers, not just "one somewhere".
    b = jnp.ones((8, 2), jnp.float32)
    xb = jnp.ones((8, 2), jnp.float32)
    perm = jnp.arange(8, dtype=jnp.int32)
    for iters in (1, 3):
        jaxpr = str(jax.make_jaxpr(
            lambda a, b, x, lu, perm: refine_solve(a, b, x, lu, perm,
                                                   iters=iters))(
                a, b, xb, a, perm))
        assert jaxpr.count("optimization_barrier") >= iters + 1
