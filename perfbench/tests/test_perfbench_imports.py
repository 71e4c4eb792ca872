"""What runs on the card imports neither JAX nor the JAX package, by the
whole top-level name (the port's name begins with the JAX package's),
and the reference side imports nothing of the program."""
import ast
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
# the reference, its chunking rules, the comparison and the yardstick:
# no program in them
INDEPENDENT = ["reference.py", "check.py", "traffic.py", "roofline.py",
               "devtrace.py"] + sorted(
    str(p.relative_to(HERE)) for p in (HERE / "chunkers").glob("*.py"))


def imported(path: Path):
    """Top-level names of every import in a file, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", None)) \
                in ("import_module", "__import__"):
            out.add(node.args[0].value.split(".")[0])
    return out


def test_checker_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.core\nfrom repro.core import sai\n"
                 "def g():\n    __import__('jax.numpy')\n")
    assert imported(f) == {"repro_torch", "repro", "jax"}
    assert imported(f) & BANNED == {"repro", "jax"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in HERE.rglob("*.py")))
def test_no_jax_and_no_jax_package(path):
    assert not imported(ROOT / path) & BANNED


@pytest.mark.parametrize("name", INDEPENDENT)
def test_reference_side_imports_no_program(name):
    assert not {n for n in imported(HERE / name)
                if n.startswith("repro")}


def test_run_refuses_a_loaded_jax(monkeypatch):
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("perfbench_run",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    import repro_torch.core  # noqa: F401
    assert "repro_torch" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.banned_modules()
