"""Saving a trained Brain's modules in the form the inference scripts
load.

Counterpart of ``speechbrain_tpu/pretrained/training.py``
(``save_for_pretrained``), which writes Flax msgpack files; here each
module's file is a ``torch.save`` of its ``state_dict``.
"""

import json
import os

import torch

__all__ = ["save_for_pretrained"]


def save_for_pretrained(brain, savedir, module_names=None, hparams=None):
    """Write ``<savedir>/<name>.ckpt`` for each module of ``brain.modules``
    named in ``module_names`` (all of them by default): a ``torch.save``
    of its ``state_dict`` (parameters and buffers, such as the BatchNorm
    statistics), moved to the CPU so that any device reads it, and
    ``hparams`` (a dict: the port's recipes hold their yaml's values as
    one; the JAX function copies the yaml file) to ``hyperparams.json``.
    Returns the paths written.

    Example
    -------
    >>> import tempfile
    >>> from types import SimpleNamespace
    >>> brain = SimpleNamespace(modules=torch.nn.ModuleDict(
    ...     {"lin": torch.nn.Linear(2, 1)}))
    >>> d = tempfile.mkdtemp()
    >>> [os.path.basename(p) for p in save_for_pretrained(
    ...     brain, d, hparams={"lr": 0.1})]
    ['lin.ckpt', 'hyperparams.json']
    >>> sorted(torch.load(f"{d}/lin.ckpt", weights_only=True))
    ['bias', 'weight']
    """
    os.makedirs(savedir, exist_ok=True)
    names = module_names or list(brain.modules.keys())
    paths = []
    for name in names:
        state = {k: v.detach().cpu()
                 for k, v in brain.modules[name].state_dict().items()}
        path = os.path.join(savedir, f"{name}.ckpt")
        torch.save(state, path)
        paths.append(path)
    if hparams is not None:
        path = os.path.join(savedir, "hyperparams.json")
        with open(path, "w") as f:
            json.dump(hparams, f, indent=2, default=str)
        paths.append(path)
    return paths
