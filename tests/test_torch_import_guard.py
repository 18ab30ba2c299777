"""The PyTorch port stands alone: no module of ``speechbrain_tpu_torch``
and not ``chip_smoke.py`` imports JAX, Flax, Optax or the JAX package,
and importing the port leaves ``jax`` out of ``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speechbrain_tpu")


def _port_files():
    files = sorted((REPO / "speechbrain_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_forbidden_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, speechbrain_tpu_torch, speechbrain_tpu_torch.asr, "
        "speechbrain_tpu_torch.bridge; "
        "bad = [m for m in ('jax', 'flax', 'optax', 'speechbrain_tpu') "
        "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
