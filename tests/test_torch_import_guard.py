"""The PyTorch port stands alone: no module of ``speechbrain_tpu_torch``
(its subpackages ``dataio``, ``native``, ``pretrained``, ``recipes``,
``tokenizers`` and the rest) and not ``chip_smoke.py`` imports JAX, Flax,
Optax or the JAX package, nor PyYAML or soundfile, which the card's
machine does not have; ``tqdm`` only behind ``core.Brain``'s optional
progress bar.  Importing the port leaves ``jax`` and ``yaml`` out of
``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speechbrain_tpu", "yaml",
             "soundfile", "tqdm")
# the one import of an optional package: Brain's progress bar, inside a
# try that falls back to no bar where tqdm is not installed
OPTIONAL = {"speechbrain_tpu_torch/core.py": {"tqdm"}}
SUBPACKAGES = ("dataio", "native", "pretrained", "recipes", "tokenizers",
               "utils")


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
    for sub in SUBPACKAGES:  # the guard walks the subpackages too
        assert any(f.parent.name == sub for f in files), sub


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_forbidden_import(path):
    rel = str(path.relative_to(REPO))
    allowed = OPTIONAL.get(rel, set())
    bad = sorted({r for r in _imported_roots(path)
                  if r in FORBIDDEN and r not in allowed})
    assert not bad, f"{rel} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, speechbrain_tpu_torch, speechbrain_tpu_torch.asr, "
        "speechbrain_tpu_torch.bridge, speechbrain_tpu_torch.ops.transducer, "
        "speechbrain_tpu_torch.nnet.loss.transducer_loss, "
        "speechbrain_tpu_torch.nnet.embedding, speechbrain_tpu_torch.nnet.RNN, "
        "speechbrain_tpu_torch.nnet.transducer.transducer_joint, "
        "speechbrain_tpu_torch.recipes.librispeech_asr, "
        "speechbrain_tpu_torch.recipes.librispeech_transducer, "
        "speechbrain_tpu_torch.recipes.timit_ctc, "
        "speechbrain_tpu_torch.recipes.gsc_xvector, "
        "speechbrain_tpu_torch.recipes.voxceleb_speaker, "
        "speechbrain_tpu_torch.recipes.wsj0mix_separation, "
        "speechbrain_tpu_torch.lobes.models.CRDNN, "
        "speechbrain_tpu_torch.native, speechbrain_tpu_torch.dataio.dataloader, "
        "speechbrain_tpu_torch.tokenizers.SentencePiece; "
        "bad = [m for m in ('jax', 'flax', 'optax', 'speechbrain_tpu', "
        "'yaml', 'soundfile') "
        "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
