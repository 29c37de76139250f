"""The port stands alone: every ``repro_torch`` module imports with JAX
blocked, and no source under ``src/repro_torch/`` (nor the port's
examples, ``examples/torch_*.py``) imports ``jax`` or the JAX package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(MODULES)


EXAMPLES = [ROOT / "examples" / f"{name}.py" for name in (
    "torch_quickstart", "torch_train_lm", "torch_tracking_pipeline",
    "torch_mot_demo", "torch_serve_lm")]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + EXAMPLES,
                         ids=lambda p: str(p.relative_to(
                             PKG if PKG in p.parents else ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_needs_a_card():
    """device='cuda' (the default) never quietly becomes the CPU."""
    from repro_torch import resolve_device
    from repro_torch.core.bank import init_bank
    from repro_torch.core.filters import get_filter

    if torch.cuda.is_available():
        assert init_bank(get_filter("lkf"), 4).x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            init_bank(get_filter("lkf"), 4)
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
