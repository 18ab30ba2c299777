"""Checkpoint saving and loading with named recoverables and keep-best
retention.

A copy of ``speechbrain_tpu/utils/checkpoints.py`` (the port imports
nothing of the JAX package), with tensors in place of JAX pytrees:

- A checkpoint is a DIRECTORY ``CKPT+<timestamp>/`` holding one file per
  registered "recoverable" plus a ``CKPT.yaml`` metadata file with
  arbitrary keys (epoch, WER, unixtime...).  ``CKPT.yaml`` is written
  as JSON, which is valid YAML: the port reads it with ``json`` (no
  YAML library needed) and the JAX package's ``yaml.safe_load`` reads
  it too.  Floats are written with a decimal point, so YAML 1.1 parsers
  read ``1.0e-05`` as a float and not as a string.
- Objects opt in per-class via ``@register_checkpoint_hooks`` with
  ``@mark_as_saver`` / ``@mark_as_loader`` / ``@mark_as_transfer``
  methods, or are wrapped in :class:`Recoverable` (a tensor, or a
  nested dict of tensors, written with ``torch.save`` and read with
  ``torch.load(weights_only=True)``).
- Retention: ``save_and_keep_only`` keeps the N most recent and/or the
  best by metadata keys (``min_keys`` / ``max_keys``).
- One process: ``utils.distributed.if_main_process`` is always true.
  ``average_checkpoints`` is not ported.

Example
-------
>>> import tempfile
>>> d = tempfile.mkdtemp()
>>> params = Recoverable({"w": torch.ones(2, 2)})
>>> ckptr = Checkpointer(d, recoverables={"params": params})
>>> ckpt = ckptr.save_checkpoint(meta={"WER": 3.0})
>>> params.value = {"w": torch.zeros(2, 2)}
>>> _ = ckptr.recover_if_possible()
>>> float(params.value["w"].sum())
4.0
"""

import collections
import inspect
import json
import logging
import math
import os
import pathlib
import shutil
import time

import torch

from .distributed import if_main_process

logger = logging.getLogger(__name__)

CKPT_PREFIX = "CKPT"
METAFNAME = f"{CKPT_PREFIX}.yaml"

__all__ = [
    "Checkpointer",
    "Checkpoint",
    "Recoverable",
    "register_checkpoint_hooks",
    "mark_as_saver",
    "mark_as_loader",
    "mark_as_transfer",
    "get_default_hook",
    "ckpt_recency",
]


# ---------------------------------------------------------------------------
# Hook registration
# ---------------------------------------------------------------------------

def mark_as_saver(method):
    """Mark ``method(self, path)`` as the checkpoint saver for its class."""
    sig = inspect.signature(method)
    try:
        sig.bind(object(), pathlib.Path("testpath"))
    except TypeError:
        raise TypeError("Checkpoint saver must take (self, path)")
    method._speechbrain_saver = True
    return method


def mark_as_loader(method):
    """Mark ``method(self, path, end_of_epoch=True)`` as the loader."""
    sig = inspect.signature(method)
    try:
        sig.bind(object(), pathlib.Path("testpath"), True)
    except TypeError:
        raise TypeError(
            "Checkpoint loader must take (self, path, end_of_epoch)"
        )
    method._speechbrain_loader = True
    return method


def mark_as_transfer(method):
    """Mark ``method(self, path)`` as the parameter-transfer hook.

    For loading parameters without the training state.
    """
    sig = inspect.signature(method)
    try:
        sig.bind(object(), pathlib.Path("testpath"))
    except TypeError:
        raise TypeError("Transfer hook must take (self, path)")
    method._speechbrain_transfer = True
    return method


def register_checkpoint_hooks(cls):
    """Class decorator collecting marked saver/loader/transfer methods."""
    global DEFAULT_SAVE_HOOKS, DEFAULT_LOAD_HOOKS, DEFAULT_TRANSFER_HOOKS
    for name, method in cls.__dict__.items():
        if getattr(method, "_speechbrain_saver", False):
            DEFAULT_SAVE_HOOKS[cls] = method
        if getattr(method, "_speechbrain_loader", False):
            DEFAULT_LOAD_HOOKS[cls] = method
        if getattr(method, "_speechbrain_transfer", False):
            DEFAULT_TRANSFER_HOOKS[cls] = method
    return cls


DEFAULT_SAVE_HOOKS = {}
DEFAULT_LOAD_HOOKS = {}
DEFAULT_TRANSFER_HOOKS = {}


def get_default_hook(obj, default_hooks):
    """Resolve the hook for obj by MRO (closest class wins)."""
    for cls in type(obj).__mro__:
        if cls in default_hooks:
            return default_hooks[cls]
    return None


# ---------------------------------------------------------------------------
# Tensor recoverable
# ---------------------------------------------------------------------------

def _first_device(value):
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, dict):
        for v in value.values():
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


@register_checkpoint_hooks
class Recoverable:
    """Wraps a mutable slot holding a tensor or a nested dict of tensors
    so it can checkpoint.

    ``torch.load`` puts the loaded tensors on the device of the current
    value's first tensor (the CPU when it holds none).
    """

    def __init__(self, value):
        self.value = value

    @mark_as_saver
    def _save(self, path):
        torch.save(self.value, path)

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        self.value = torch.load(
            path, map_location=_first_device(self.value) or "cpu",
            weights_only=True)

    @mark_as_transfer
    def _transfer(self, path):
        self._load(path)


# ---------------------------------------------------------------------------
# Checkpoint record
# ---------------------------------------------------------------------------

Checkpoint = collections.namedtuple(
    "Checkpoint", ["path", "meta", "paramfiles"]
)


def ckpt_recency(ckpt):
    """Importance key: recency (the default keep predicate)."""
    return ckpt.meta["unixtime"]


def _ranked(ckpts, key):
    """``ckpts`` most important first by ``key``; ties go to the newest
    (``ckpt_recency``), then to the later directory name, so the order
    never depends on the order the directory lists them in."""
    return sorted(ckpts, key=lambda c: (key(c), ckpt_recency(c), c.path.name),
                  reverse=True)


class Checkpointer:
    """Saves, lists, filters, deletes and restores checkpoints.

    Arguments
    ---------
    checkpoints_dir : str | Path
        Root directory for checkpoint subdirectories.
    recoverables : dict, optional
        name -> object with registered hooks (or a :class:`Recoverable`).
    allow_partial_load : bool
        If True, a checkpoint may omit some registered recoverables.
    """

    def __init__(
        self, checkpoints_dir, recoverables=None, allow_partial_load=False
    ):
        self.checkpoints_dir = pathlib.Path(checkpoints_dir)
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        self.recoverables = {}
        if recoverables is not None:
            self.add_recoverables(recoverables)
        self.allow_partial_load = allow_partial_load

    def add_recoverable(self, name, obj):
        """Register one recoverable under ``name``."""
        self.recoverables[name] = obj

    def add_recoverables(self, recoverables):
        """Register a dict of recoverables."""
        if hasattr(recoverables, "items"):
            self.recoverables.update(recoverables)
        else:
            raise AttributeError(
                "Checkpointer needs a mapping (e.g. dict), "
                f"got {recoverables} instead."
            )

    # -- saving ------------------------------------------------------------

    def save_checkpoint(self, meta={}, end_of_epoch=True, name=None):
        """Save a new checkpoint; returns the Checkpoint record."""
        if name is None:
            ckpt_dir = self._new_checkpoint_dirpath()
        else:
            ckpt_dir = self._custom_checkpoint_dirpath(name)
        if if_main_process():
            os.makedirs(ckpt_dir, exist_ok=True)
            saved_meta = self._save_checkpoint_metafile(
                ckpt_dir / METAFNAME, meta, end_of_epoch
            )
        else:
            saved_meta = dict(meta)
        saved_paramfiles = {}
        for name_, obj in self.recoverables.items():
            objfname = f"{name_}.ckpt"
            savepath = ckpt_dir / objfname
            saved_paramfiles[name_] = savepath
            if not if_main_process():
                continue
            hook = get_default_hook(obj, DEFAULT_SAVE_HOOKS)
            if hook is not None:
                hook(obj, savepath)
            elif callable(getattr(obj, "_save", None)):
                obj._save(savepath)
            else:
                raise RuntimeError(
                    f"Don't know how to save {type(obj)}. Register default "
                    "hooks via @register_checkpoint_hooks or wrap the tensors "
                    "in Recoverable."
                )
        logger.info(f"Saved a checkpoint in {ckpt_dir}")
        return Checkpoint(ckpt_dir, saved_meta, saved_paramfiles)

    def save_and_keep_only(
        self,
        meta={},
        end_of_epoch=True,
        name=None,
        num_to_keep=1,
        keep_recent=True,
        importance_keys=[],
        max_keys=[],
        min_keys=[],
        ckpt_predicate=None,
    ):
        """Save a checkpoint, then delete all but the best/most recent."""
        if keep_recent:
            importance_keys = list(importance_keys) + [ckpt_recency]
        self.save_checkpoint(meta=meta, end_of_epoch=end_of_epoch, name=name)
        self.delete_checkpoints(
            num_to_keep=num_to_keep,
            max_keys=max_keys,
            min_keys=min_keys,
            importance_keys=importance_keys,
            ckpt_predicate=ckpt_predicate,
        )

    # -- finding -----------------------------------------------------------

    def find_checkpoint(
        self,
        importance_key=None,
        max_key=None,
        min_key=None,
        ckpt_predicate=None,
    ):
        """The single most important checkpoint (None if none exist)."""
        ckpts = self.find_checkpoints(
            importance_key=importance_key,
            max_key=max_key,
            min_key=min_key,
            ckpt_predicate=ckpt_predicate,
            max_num_checkpoints=1,
        )
        return ckpts[0] if ckpts else None

    def find_checkpoints(
        self,
        importance_key=None,
        max_key=None,
        min_key=None,
        ckpt_predicate=None,
        max_num_checkpoints=None,
    ):
        """Checkpoints sorted most-important-first, filtered by predicate.

        Exactly one of importance_key / max_key / min_key may be given;
        defaults to recency.
        """
        if importance_key is None and min_key is None and max_key is None:
            importance_key = ckpt_recency
        if max_key and not importance_key:
            importance_key = lambda ckpt: ckpt.meta[max_key]  # noqa: E731
        elif min_key and not importance_key:
            importance_key = lambda ckpt: -ckpt.meta[min_key]  # noqa: E731
        elif (max_key or min_key) and importance_key:
            raise ValueError(
                "Pass only one of importance_key, max_key, min_key"
            )
        ckpts = self.list_checkpoints()
        if ckpt_predicate is not None:
            ckpts = list(filter(ckpt_predicate, ckpts))
        if max_key or min_key:
            key_name = max_key or min_key
            ckpts = [c for c in ckpts if key_name in c.meta]
        ckpts = _ranked(ckpts, importance_key)
        if max_num_checkpoints is not None:
            ckpts = ckpts[:max_num_checkpoints]
        return ckpts

    def list_checkpoints(self):
        """All checkpoints found in the top level of checkpoints_dir."""
        return self._construct_checkpoint_objects(
            self._list_checkpoint_dirs()
        )

    # -- loading -----------------------------------------------------------

    def recover_if_possible(
        self,
        importance_key=None,
        max_key=None,
        min_key=None,
        ckpt_predicate=None,
    ):
        """Load the most important checkpoint, if any exist."""
        ckpt = self.find_checkpoint(
            importance_key, max_key, min_key, ckpt_predicate
        )
        if ckpt is not None:
            self.load_checkpoint(ckpt)
        return ckpt

    def load_checkpoint(self, checkpoint):
        """Load every recoverable from the given checkpoint."""
        self._call_load_hooks(checkpoint)

    def _call_load_hooks(self, checkpoint):
        end_of_epoch = checkpoint.meta["end-of-epoch"]
        for name, obj in self.recoverables.items():
            objfname = f"{name}.ckpt"
            loadpath = checkpoint.path / objfname
            if not loadpath.exists():
                if self.allow_partial_load:
                    continue
                raise RuntimeError(
                    f"Loading checkpoint from {checkpoint.path}, but missing "
                    f"a load path for {name}"
                )
            hook = get_default_hook(obj, DEFAULT_LOAD_HOOKS)
            if hook is not None:
                hook(obj, loadpath, end_of_epoch)
                continue
            raise RuntimeError(
                f"Don't know how to load {type(obj)}. Register default hooks."
            )

    # -- deleting ----------------------------------------------------------

    def delete_checkpoints(
        self,
        *,
        num_to_keep=1,
        min_keys=None,
        max_keys=None,
        importance_keys=[ckpt_recency],
        ckpt_predicate=None,
        verbosity=logging.INFO,
    ):
        """Delete checkpoints, keeping the top num_to_keep by EACH key.

        The union of the keep-sets survives (a checkpoint that is best
        by any one criterion is kept).
        """
        if num_to_keep < 0:
            raise ValueError("Number of checkpoints to keep must be >= 0.")
        keys = list(importance_keys)
        if min_keys:
            keys.extend(
                (lambda c, k=key: -c.meta[k]) for key in min_keys
            )
        if max_keys:
            keys.extend((lambda c, k=key: c.meta[k]) for key in max_keys)
        potential = self.list_checkpoints()
        if ckpt_predicate is not None:
            potential = list(filter(ckpt_predicate, potential))
        protected = set()
        for key in keys:
            scored = [c for c in potential if _has_key(c, key)]
            scored = _ranked(scored, key)
            protected.update(c.path for c in scored[:num_to_keep])
        if not if_main_process():
            return
        for ckpt in potential:
            if ckpt.path not in protected:
                Checkpointer._delete_checkpoint(ckpt, verbosity=verbosity)

    @staticmethod
    def _delete_checkpoint(checkpoint, verbosity=logging.INFO):
        if not Checkpointer._is_checkpoint_dir(checkpoint.path):
            raise RuntimeError("Checkpoint does not appear valid for deletion.")
        shutil.rmtree(checkpoint.path)
        logger.log(verbosity, f"Deleted checkpoint in {checkpoint.path}")

    # -- internals ---------------------------------------------------------

    def _list_checkpoint_dirs(self):
        return [
            x
            for x in self.checkpoints_dir.iterdir()
            if Checkpointer._is_checkpoint_dir(x)
        ]

    @staticmethod
    def _construct_checkpoint_objects(checkpoint_dirs):
        checkpoints = []
        for ckpt_dir in checkpoint_dirs:
            with open(ckpt_dir / METAFNAME) as fi:
                meta = json.load(fi)
            paramfiles = {}
            for ckptfile in ckpt_dir.iterdir():
                if ckptfile.suffix == ".ckpt":
                    paramfiles[ckptfile.stem] = ckptfile
            checkpoints.append(Checkpoint(ckpt_dir, meta, paramfiles))
        return checkpoints

    @staticmethod
    def _is_checkpoint_dir(path):
        path = pathlib.Path(path)
        if not path.is_dir():
            return False
        if not path.name.startswith(CKPT_PREFIX):
            return False
        return (path / METAFNAME).exists()

    def _new_checkpoint_dirpath(self):
        t = time.time()
        stamp = time.strftime("%Y-%m-%d+%H-%M-%S", time.localtime(t))
        suffix_num = 0
        while (
            self.checkpoints_dir / f"{CKPT_PREFIX}+{stamp}+{suffix_num:02d}"
        ).exists():
            suffix_num += 1
        return self.checkpoints_dir / f"{CKPT_PREFIX}+{stamp}+{suffix_num:02d}"

    def _custom_checkpoint_dirpath(self, name):
        return self.checkpoints_dir / f"{CKPT_PREFIX}+{name}"

    def _save_checkpoint_metafile(
        self, fpath, meta_to_include={}, end_of_epoch=True
    ):
        meta = {"unixtime": time.time(), "end-of-epoch": end_of_epoch}
        meta.update(meta_to_include)
        with open(fpath, "w") as fo:
            fo.write(_meta_json(_sanitize_meta(meta)) + "\n")
        return meta


def _sanitize_meta(meta):
    """Make metadata serializable (numpy/torch scalars -> python)."""
    out = {}
    for k, v in meta.items():
        if hasattr(v, "item"):
            try:
                v = v.item()
            except Exception:
                v = float(v)
        out[k] = v
    return out


def _has_key(ckpt, key):
    try:
        key(ckpt)
        return True
    except KeyError:
        return False


def _json_float(v):
    """A float as JSON that YAML 1.1 also reads as a float."""
    if not math.isfinite(v):
        return json.dumps(v)  # NaN / Infinity: JSON's spelling
    text = repr(float(v))
    if "e" in text and "." not in text:
        text = text.replace("e", ".0e")
    return text


def _meta_json(meta):
    """A flat dict of scalars as one JSON object."""
    items = []
    for k, v in meta.items():
        if isinstance(v, float):
            value = _json_float(v)
        else:
            value = json.dumps(v)
        items.append(f"{json.dumps(str(k))}: {value}")
    return "{" + ", ".join(items) + "}"
