"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``deepim_tpu_torch`` begins with ``deepim_tpu``."""

import ast
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepim_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(PORTBENCH.rglob("*.py"))


def test_every_module_is_walked():
    rel = {p.relative_to(PORTBENCH).as_posix() for p in MODULES}
    assert {"run.py", "spec.py", "reference/network.py", "drivers/refine.py",
            "metrics/poses_per_s.py"} <= rel


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(PORTBENCH).as_posix())
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "deepim_tpu_torch" not in imported(path)
    assert not {n for n in imported(path) if n.startswith("deepim")}


def test_guard_sees_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from deepim_tpu.geometry import se3\n    import jax.numpy\n")
    assert imported(bad) & FORBIDDEN == {"deepim_tpu", "jax"}
    ok = tmp_path / "ok.py"
    ok.write_text("import deepim_tpu_torch.refine\n")
    assert not imported(ok) & FORBIDDEN
