"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports the JAX package ``repro``, JAX itself, or the
JAX package's ``benchmarks`` — at any depth, function-level imports and
``importlib``/``__import__`` calls with a literal name included."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("repro", "jax", "jaxlib", "benchmarks")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def banned_imports(source: str, filename: str = "<src>"):
    """(line, module) of every import of a banned top-level package."""
    out = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if called in ("import_module", "__import__"):
                names = [node.args[0].value]
        out += [(node.lineno, n) for n in names
                if n.split(".")[0] in BANNED]
    return out


def test_checker_sees_every_form():
    src = ("import os\n"
           "def f():\n"
           "    from repro.core import sai\n"
           "    import jax.numpy as jnp\n"
           "class C:\n"
           "    def g(self):\n"
           "        import importlib\n"
           "        importlib.import_module('repro.serve.transport')\n"
           "        __import__('jaxlib')\n"
           "from repro_torch.core import sai\n"
           "from . import repro\n"
           "import benchmarks.common\n")
    assert banned_imports(src) == [
        (12, "benchmarks.common"), (3, "repro.core"), (4, "jax.numpy"),
        (8, "repro.serve.transport"), (9, "jaxlib")]


def test_every_port_module_is_checked():
    rel = {str(f.relative_to(ROOT)) for f in FILES}
    for want in ("src/repro_torch/core/noderuntime.py",
                 "src/repro_torch/serve/storage_client.py",
                 "src/repro_torch/serve/transport.py",
                 "src/repro_torch/obs/httpexport.py",
                 "src/repro_torch/configs/__init__.py",
                 "src/repro_torch/configs/llama3_8b.py",
                 "src/repro_torch/roofline/analysis.py",
                 "src/repro_torch/analysis/engine.py",
                 "src/repro_torch/analysis/__main__.py",
                 "src/repro_torch/compat.py",
                 "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/models/model.py",
                 "src/repro_torch/serve/servestep.py",
                 "src/repro_torch/serve/scheduler.py",
                 "src/repro_torch/launch/presets.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/optim/__init__.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/optim/adafactor.py",
                 "src/repro_torch/optim/schedule.py",
                 "src/repro_torch/models/stacked.py",
                 "src/repro_torch/data/__init__.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/train/trainstep.py",
                 "src/repro_torch/train/fault.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/models/sharding.py",
                 "src/repro_torch/optim/grad_compress.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/roofline/hlo_analysis.py",
                 "src/repro_torch/roofline/reanalyze.py",
                 "src/repro_torch/kernels/candidates.py", "chip_smoke.py"):
        assert want in rel


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_reference_or_jax(path):
    assert banned_imports(path.read_text(), str(path)) == []


def test_importing_the_port_loads_no_reference_or_jax():
    """Import every module of the port in a fresh interpreter: nothing
    of ``repro`` or JAX lands in ``sys.modules``."""
    mods = [".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
            .removesuffix(".__init__") for f in FILES[:-1]]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {BANNED!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
