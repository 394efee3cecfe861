"""The import guard: nothing of the benchmark imports JAX or the JAX
package (top-level names compared whole, so breakmer_tpu_torch passes),
the references import nothing of the program, and a run leaves neither
in sys.modules."""

import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "breakmer_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                yield arg.values[0].value


def test_no_module_imports_jax_or_the_jax_package():
    found = [(p.name, m) for p in PKG.rglob("*.py") for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not found, found
    # the program's own name passes: it is compared whole
    assert any(m.split(".")[0] == "breakmer_tpu_torch" for m in _imports(PKG / "harness.py"))


def test_the_references_import_nothing_of_the_program():
    for p in (PKG / "reference").rglob("*.py"):
        mods = [m.split(".")[0] for m in _imports(p)]
        assert not set(mods) & (FORBIDDEN | {"breakmer_tpu_torch", "torch"}), (p, mods)


def test_a_run_leaves_no_forbidden_module_loaded():
    code = ("import sys; from svbench import run; rc = run.main(['--rehearse', '--workload', "
            "'oncopanel_t.sv_dense']); bad = {m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r}); print('BAD', sorted(bad)); sys.exit(rc or bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "BAD []" in out.stdout
