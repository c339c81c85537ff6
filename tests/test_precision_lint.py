"""Static lint: every device dot must carry an explicit ``precision=``.

On accelerators the *default* f32 ``dot_general`` may round its data
operands to lower precision (TF32 on an NVIDIA GPU keeps ~3 decimal
digits) — including inside Pallas kernels, and including dots with a
one-hot operand (the one-hot does not make the contraction exact).  That
silent rounding caused two real bugs in this repo:

- round 1: default-precision GEMMs cost ~4 digits of residual
  (DESIGN.md "performance facts");
- round 2: two unguarded ``lax.dot_general`` calls inside the sub-blocked
  pivot-search kernel corrupted the search working set (exact on CPU
  interpret, so tests never saw it).

CPU tests cannot catch this class (CPU default precision is exact), so we
enforce it statically: walk EVERY module in the package (recursively —
api.py's verification GEMM runs on device too) and require a
``precision`` keyword on every jnp/lax dot-family call, whether invoked
as an attribute (``jnp.matmul``) or a bare imported name.  The ``@``
operator cannot carry a precision argument at all, so any MatMult in
package code is flagged outright.  Host-side ``np.*`` dots are exempt
(NumPy is exact).  Intentionally lower tiers (e.g. the Newton-Schulz
correction GEMM one tier down) still pass — the requirement is that the choice be *explicit*.
"""

from __future__ import annotations

import ast
import pathlib

import gpu_matrix_inversion_tpu as pkg

DOT_NAMES = {"matmul", "dot", "dot_general", "einsum", "tensordot", "vdot"}
# Host-side numpy is exact; only these roots route to the device.
EXEMPT_ROOTS = {"np", "numpy"}


def _imports_jax(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(alias.name.split(".")[0] == "jax" for alias in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "jax":
                return True
    return False


def _dot_offences(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    uses_jax = _imports_jax(tree)
    bad = []
    for node in ast.walk(tree):
        # '@' can never carry a precision choice; in a host-numpy-only
        # module (no jax import) it is exact and fine.
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if uses_jax:
                bad.append(f"{path.name}:{node.lineno} '@' operator "
                           "(cannot carry precision=)")
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in DOT_NAMES:
            # Resolve the BASE name of the dotted chain (ADVICE r2: matching
            # the last attribute segment flagged host-side nested calls like
            # np.linalg.tensordot via root='linalg').
            base = func.value
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and base.id in EXEMPT_ROOTS:
                continue
        elif isinstance(func, ast.Name) and func.id in DOT_NAMES:
            pass  # bare imported name: require precision= too
        else:
            continue
        if not any(kw.arg == "precision" for kw in node.keywords):
            bad.append(f"{path.name}:{node.lineno} {ast.unparse(func)}")
    return bad


def test_every_device_dot_has_explicit_precision():
    root = pathlib.Path(pkg.__file__).parent
    offenders = []
    for path in sorted(root.rglob("*.py")):
        offenders.extend(_dot_offences(path))
    assert not offenders, (
        "device dots without explicit precision= (the default may silently "
        "rounds f32 operands to bf16):\n  " + "\n  ".join(offenders))
