"""The examples in the port's docstrings run and give what they show
(the suite collects doctests only from the JAX package's tree)."""

import doctest
import importlib
from pathlib import Path

import pytest

from .test_torch_kernels import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "speechbrain_tpu_torch").rglob("*.py")
    if p.name != "__init__.py"
)


@pytest.mark.parametrize("name", MODULES)
def test_docstring_examples(name):
    module = importlib.import_module(name)
    result = doctest.testmod(
        module, optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    )
    assert result.failed == 0, f"{result.failed} failing examples in {name}"
