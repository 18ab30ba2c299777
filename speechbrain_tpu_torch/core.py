"""Training and evaluation engine.

Counterpart of ``speechbrain_tpu/core.py`` (``Brain``: ``fit_batch``,
``fit_batches``, ``evaluate_batch``, lazy loss sync, non-finite
patience, gradient accumulation), written in PyTorch's idiom: eager
autograd and a ``torch.optim`` optimizer in place of the jitted step
and the optax chain.

Precision ``"bf16"`` means bfloat16 activations with float32 parameters
and float32 optimizer state, as in the JAX package: the modules keep
f32 parameters and cast them to the activation dtype per op
(``compute_forward`` casts the features to ``self.dtype``).  It is
neither ``torch.autocast`` nor ``model.to(torch.bfloat16)``.
"""

import logging
from enum import Enum
from types import SimpleNamespace

import numpy as np
import torch

from .device import resolve_device
from .nnet.dropout import Dropout

__all__ = ["Stage", "Brain", "clip_by_global_norm_"]

logger = logging.getLogger(__name__)


class Stage(Enum):
    """Which stage a batch is run for."""

    TRAIN = 1
    VALID = 2
    TEST = 3


def clip_by_global_norm_(grads, max_norm):
    """Scale ``grads`` in place by ``min(1, max_norm / ||grads||_2)``, the
    global norm over all of them, as ``optax.clip_by_global_norm`` does
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).  Returns the
    norm (a device scalar: no host sync).

    Example
    -------
    >>> g = [torch.tensor([3.0]), torch.tensor([4.0])]
    >>> float(clip_by_global_norm_(g, 1.0)), [round(float(x), 4) for x in g]
    (5.0, [0.6, 0.8])
    """
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Brain:
    """Training/evaluation engine.  Subclass and override
    ``compute_forward(batch, stage)`` and
    ``compute_objectives(predictions, batch, stage)``.

    Arguments
    ---------
    modules : dict of ``torch.nn.Module``
        Exposed as ``self.modules`` (a ``ModuleDict``), moved to the
        device with float32 parameters.
    opt_class : callable(params) -> ``torch.optim.Optimizer``, optional
        Its learning rate is overwritten with ``self.lr`` before every
        step.  The recipes' optax ``adamw(b1=0.9, b2=0.98, eps=1e-9)`` is
        ``torch.optim.AdamW(params, betas=(0.9, 0.98), eps=1e-9,
        weight_decay=1e-4)``: optax's default decay 1e-4, not torch's 1e-2.
    hparams : dict, exposed as ``self.hparams.<key>``.
    run_opts : dict of engine options: ``device`` (None: the CUDA card;
        ``"cpu"`` must be asked for), ``precision`` ("fp32" or "bf16"),
        ``seed``, ``grad_accumulation_factor``, ``max_grad_norm``,
        ``nonfinite_patience``, ``loss_sync_interval``.

    Training steps: the caller advances ``self.step`` before each
    ``fit_batch`` (as ``Brain.fit`` does in the JAX package); the
    optimizer steps when ``step % grad_accumulation_factor == 0``.
    Before it, a loss that is not finite zeroes the gradients (the
    optimizer still steps, as JAX's ``where(finite, g, 0)`` does), then
    the gradients are clipped to ``max_grad_norm``.  Losses stay on the
    device and are fetched every ``loss_sync_interval`` steps, where the
    non-finite ones count toward ``nonfinite_patience``.

    Dropout masks come from ``self.generator``, a ``torch.Generator`` on
    the device seeded from ``seed`` and set on every ``Dropout`` module;
    the global RNG is never used.

    Example
    -------
    >>> class Fit(Brain):
    ...     def compute_forward(self, batch, stage):
    ...         return self.modules.lin(batch["x"])
    ...     def compute_objectives(self, pred, batch, stage):
    ...         return ((pred - batch["y"]) ** 2).mean()
    >>> brain = Fit({"lin": torch.nn.Linear(2, 1)},
    ...     lambda p: torch.optim.SGD(p, lr=0.1), {"lr": 0.1},
    ...     {"device": "cpu", "loss_sync_interval": 1})
    >>> batch = {"x": np.ones((4, 2), np.float32),
    ...          "y": np.zeros((4, 1), np.float32)}
    >>> brain.step += 1; first = brain.fit_batch(batch)
    >>> brain.step += 1; brain.fit_batch(batch) < first
    True
    """

    RUN_OPT_DEFAULTS = {
        "device": None,
        "precision": "fp32",
        "seed": 1234,
        "grad_accumulation_factor": 1,
        "max_grad_norm": 5.0,
        "nonfinite_patience": 3,
        "loss_sync_interval": 10,
    }

    def __init__(self, modules=None, opt_class=None, hparams=None,
                 run_opts=None):
        run_opts = run_opts or {}
        hparams = dict(hparams or {})
        for arg, default in self.RUN_OPT_DEFAULTS.items():
            if arg in run_opts:
                setattr(self, arg, run_opts[arg])
            elif arg in hparams:
                setattr(self, arg, hparams[arg])
            else:
                setattr(self, arg, default)
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision {self.precision!r}: fp32 or bf16")
        self.hparams = SimpleNamespace(**hparams)
        self.device = resolve_device(self.device)
        self.dtype = torch.bfloat16 if self.precision == "bf16" else torch.float32
        self.modules = torch.nn.ModuleDict(modules or {}).to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        for m in self.modules.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self.opt_class = opt_class
        self.optimizer = None
        self.lr = getattr(self.hparams, "lr", 1e-3)
        self.step = 0
        self.optimizer_step = 0
        self.nonfinite_count = 0
        self.avg_train_loss = 0.0
        self._pending_losses = []
        self._synced_loss_sum = 0.0
        self._synced_loss_count = 0
        self.init_optimizers()

    # ------------------------------------------------------------ hooks

    def compute_forward(self, batch, stage):
        """Forward pass: batch dict -> predictions."""
        raise NotImplementedError

    def compute_objectives(self, predictions, batch, stage):
        """Predictions -> scalar loss."""
        raise NotImplementedError

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """Called after each training batch (e.g. to step a scheduler)."""

    def on_stage_start(self, stage, epoch=None):
        """Called at the start of each TRAIN/VALID/TEST stage (by the
        caller: the port has no ``fit``/``evaluate`` loop yet)."""

    def init_optimizers(self):
        """Build the optimizer over every trainable parameter."""
        if self.opt_class is None:
            return
        params = [p for p in self.modules.parameters() if p.requires_grad]
        self.optimizer = self.opt_class(params)

    # ------------------------------------------------------------ batches

    def prepare_batch(self, batch):
        """Host dict (numpy arrays or tensors) -> dict of device tensors,
        copied through pinned memory with ``non_blocking`` on CUDA; adds
        ``batch_mask`` (ones: every row is real) when absent."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            if not isinstance(v, torch.Tensor):
                continue
            if self.device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory()
            out[k] = v.to(self.device, non_blocking=True)
        if "batch_mask" not in out:
            B = next(iter(out.values())).shape[0]
            out["batch_mask"] = torch.ones(B, device=self.device)
        return out

    def _loss(self, batch, stage):
        result = self.compute_objectives(
            self.compute_forward(batch, stage), batch, stage)
        return result[0] if isinstance(result, tuple) else result

    def _grads(self):
        return [p.grad for group in self.optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    def _apply(self, finite):
        """Zero the gradients unless ``finite`` (a device bool), clip,
        and step the optimizer at ``self.lr``."""
        grads = self._grads()
        for g in grads:
            g.masked_fill_(~finite, 0.0)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            clip_by_global_norm_(grads, self.max_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.optimizer_step += 1

    def _train_step(self, batch):
        """Forward, backward and (when due) the optimizer step; returns
        the loss as a device scalar."""
        self.modules.train()
        gaf = self.grad_accumulation_factor
        loss = self._loss(batch, Stage.TRAIN)
        if gaf == 1:
            loss.backward()
            self._apply(torch.isfinite(loss.detach()))
        else:
            (loss * (1.0 / gaf)).backward()
            if self.step % gaf == 0:
                total = torch.stack(torch._foreach_norm(self._grads(), 1)).sum()
                self._apply(torch.isfinite(total))
        return loss.detach()

    def fit_batch(self, batch):
        """One training batch.  Returns the loss: a device scalar between
        sync points, a python float on every ``loss_sync_interval``-th
        step (no host sync in between)."""
        if self.optimizer is None:
            raise RuntimeError("fit_batch needs an opt_class")
        batch = self.prepare_batch(batch)
        should_step = self.step % self.grad_accumulation_factor == 0
        loss = self._train_step(batch)
        self._pending_losses.append(loss)
        if len(self._pending_losses) >= max(1, int(self.loss_sync_interval)):
            loss = self._sync_losses()
        self.on_fit_batch_end(batch, None, loss, should_step)
        return loss

    def fit_batches(self, batches):
        """K training batches back to back, as ``fit_batch`` K times but
        with the learning rate taken once at the window's start and
        ``on_fit_batch_end`` called once at its end (the JAX package's
        fused window).  Needs ``grad_accumulation_factor == 1``.  Returns
        the (K,) device vector of losses."""
        if self.grad_accumulation_factor != 1:
            raise ValueError(
                "fit_batches requires grad_accumulation_factor == 1; "
                "use fit_batch for accumulation.")
        if self.optimizer is None:
            raise RuntimeError("fit_batches needs an opt_class")
        losses = torch.stack([self._train_step(self.prepare_batch(b))
                              for b in batches])
        self._pending_losses.append(losses)
        last = losses
        pending = sum(t.numel() for t in self._pending_losses)
        if pending >= max(1, int(self.loss_sync_interval)):
            last = self._sync_losses()
        self.on_fit_batch_end(batches[-1], None, last, True)
        return losses

    def _sync_losses(self):
        """Fetch the pending losses (one host sync); update the average
        and the non-finite patience.  Returns the last loss as a float."""
        if not self._pending_losses:
            return None
        vals = torch.cat([t.reshape(-1).float() for t in self._pending_losses])
        vals = vals.tolist()
        self._pending_losses = []
        for v in vals:
            if np.isfinite(v):
                self._synced_loss_sum += v
                self._synced_loss_count += 1
            else:
                self.nonfinite_count += 1
                logger.warning(f"Loss is {v}; ({self.nonfinite_count}/"
                               f"{self.nonfinite_patience})")
                if self.nonfinite_count > self.nonfinite_patience:
                    raise ValueError(
                        "Loss is not finite and patience is exhausted.")
        if self._synced_loss_count:
            self.avg_train_loss = self._synced_loss_sum / self._synced_loss_count
        return vals[-1]

    @torch.no_grad()
    def evaluate_batch(self, batch, stage):
        """One evaluation batch in eval mode; returns the loss as a float."""
        self.modules.eval()
        return float(self._loss(self.prepare_batch(batch), stage))
