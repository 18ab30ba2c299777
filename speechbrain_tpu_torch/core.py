"""Training and evaluation engine.

Counterpart of ``speechbrain_tpu/core.py`` (``Brain``: ``fit``/
``evaluate`` with their stage hooks, checkpoint recovery and
intra-epoch checkpoints, the staging thread, ``fit_batch``,
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

import json
import logging
import queue
import threading
import time
from enum import Enum
from types import SimpleNamespace

import numpy as np
import torch

from .dataio.batch import PaddedBatch
from .dataio.dataloader import DataLoader, SaveableDataLoader, make_dataloader
from .device import resolve_device
from .nnet.dropout import Dropout
from .utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)
from .utils.distributed import run_on_main
from .utils.epoch_loop import EpochCounter

__all__ = ["Stage", "Brain", "clip_by_global_norm_"]

logger = logging.getLogger(__name__)

INTRA_EPOCH_CKPT_FLAG = "brain_intra_epoch_ckpt"


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


@register_checkpoint_hooks
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
        ``nonfinite_patience``, ``loss_sync_interval``; and those of
        ``fit``: ``debug`` (stop after ``debug_batches`` batches and
        ``debug_epochs`` epochs), ``optimizer_step_limit`` (stop at the
        end of the epoch that reaches it), ``ckpt_interval_minutes``
        (intra-epoch checkpoints; 0: none), ``staging_depth`` (batches
        that a thread prepares ahead; 0: prepare inline),
        ``steps_per_execute`` (``fit_batches`` windows of that many
        same-shape batches) and ``noprogressbar``.
    checkpointer : ``utils.checkpoints.Checkpointer``, optional
        The Brain registers its counters as ``"brain"`` and its train
        state (the modules' and the optimizer's ``state_dict`` and the
        random generator's state) as ``"train_state"``; ``fit`` adds the
        train loader and the epoch counter.  A run resumed on the same
        device type so draws the dropout masks and augmentations that the
        uninterrupted run would have drawn (the JAX package restarts its
        key from the seed).

    Training steps: ``fit`` (or a caller driving ``fit_batch`` itself)
    advances ``self.step`` before each ``fit_batch``; the optimizer
    steps when ``step % grad_accumulation_factor == 0``.
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
        "debug": False,
        "debug_batches": 2,
        "debug_epochs": 2,
        "optimizer_step_limit": None,
        "ckpt_interval_minutes": 0,
        "staging_depth": 2,
        "steps_per_execute": 1,
        "noprogressbar": False,
    }

    def __init__(self, modules=None, opt_class=None, hparams=None,
                 run_opts=None, checkpointer=None):
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
        self.staging_wait_seconds = 0.0
        self._last_ckpt_time = time.time()
        self.init_optimizers()
        self.checkpointer = checkpointer
        if checkpointer is not None:
            checkpointer.add_recoverable("brain", self)
            checkpointer.add_recoverable("train_state",
                                         _TrainStateRecoverable(self))

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
        """Called at the start of each TRAIN/VALID/TEST stage."""

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """Called at the end of each stage with its average loss."""

    def on_fit_start(self):
        """Called once before training: recovers the latest checkpoint."""
        if self.checkpointer is not None:
            self._recovered_ckpt = self.checkpointer.recover_if_possible()

    def on_evaluate_start(self, max_key=None, min_key=None):
        """Called at ``evaluate`` start: recovers the best checkpoint."""
        if self.checkpointer is not None:
            self._recovered_ckpt = self.checkpointer.recover_if_possible(
                max_key=max_key, min_key=min_key)

    def init_optimizers(self):
        """Build the optimizer over every trainable parameter."""
        if self.opt_class is None:
            return
        params = [p for p in self.modules.parameters() if p.requires_grad]
        self.optimizer = self.opt_class(params)

    # ------------------------------------------------------------ batches

    def prepare_batch(self, batch):
        """Host dict (numpy arrays or tensors) or ``PaddedBatch`` (its
        ``numeric_dict()``, with ``batch_mask`` when the batch has dummy
        rows) -> dict of device tensors, copied through pinned memory
        with ``non_blocking`` on CUDA, on the calling thread's current
        stream; adds ``batch_mask`` (ones: every row is real) when
        absent.  Tensors already on the device pass through."""
        if isinstance(batch, PaddedBatch):
            batch = batch.numeric_dict()
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

    # ------------------------------------------------------------ loops

    def make_dataloader(self, dataset, stage, **loader_kwargs):
        """A loader for ``dataset`` (a loader passes through); override
        for custom sampling."""
        if isinstance(dataset, DataLoader):
            return dataset
        return make_dataloader(dataset, **loader_kwargs)

    def fit(self, epoch_counter, train_set, valid_set=None, progressbar=None,
            train_loader_kwargs={}, valid_loader_kwargs={}):
        """The epoch loop: per epoch, the training stage over
        ``train_set`` and the validation stage over ``valid_set``, with
        their stage hooks.  The checkpointer (when given) gets the train
        loader and the epoch counter, and ``on_fit_start`` recovers the
        latest checkpoint.  Gradients accumulated before ``fit`` are
        dropped.  Stops after the epoch at which ``optimizer_step``
        reaches ``optimizer_step_limit``, or after ``debug_epochs`` in
        debug mode."""
        train_set = self.make_dataloader(train_set, Stage.TRAIN,
                                         **train_loader_kwargs)
        if valid_set is not None:
            valid_set = self.make_dataloader(valid_set, Stage.VALID,
                                             **valid_loader_kwargs)
        if self.checkpointer is not None:
            recoverables = self.checkpointer.recoverables
            if (isinstance(train_set, SaveableDataLoader)
                    and "train_loader" not in recoverables):
                self.checkpointer.add_recoverable("train_loader", train_set)
            if (isinstance(epoch_counter, EpochCounter)
                    and "epoch_counter" not in recoverables):
                self.checkpointer.add_recoverable("epoch_counter",
                                                  epoch_counter)
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)
        self.on_fit_start()
        if progressbar is None:
            progressbar = not self.noprogressbar
        for epoch in epoch_counter:
            self._fit_train(train_set, epoch, progressbar)
            self._fit_valid(valid_set, epoch)
            if (self.optimizer_step_limit is not None
                    and self.optimizer_step >= self.optimizer_step_limit):
                logger.info("Optimizer step limit reached; stopping fit")
                break
            if self.debug and epoch >= self.debug_epochs:
                logger.info("Debug mode: stopping after debug epochs")
                break

    def _staged_iter(self, iterator, loader=None):
        """Batches prepared ahead by a thread: it runs ``prepare_batch``
        up to ``staging_depth`` batches ahead of training, so the host
        to device copy of batch N+1 overlaps batch N's compute.  Yields
        the device batches in order and adds the seconds spent waiting
        for each to ``self.staging_wait_seconds``; exceptions reach the
        consumer.

        On CUDA the thread copies on a stream of its own and records an
        event after each batch; the consumer's stream waits on that
        event, and each tensor is marked as used by the consumer's
        stream (``record_stream``), so the caching allocator does not
        hand its memory out again before the consumer's work is done.

        The loader's position runs ahead of training by up to
        ``staging_depth`` batches, so the position of the batch being
        yielded (taken when it was staged) is handed to the loader as
        ``_speechbrain_staged_position``, which its saver records: a
        mid-epoch checkpoint resumes with exactly the batches not yet
        trained on.
        """
        q = queue.Queue(maxsize=max(1, int(self.staging_depth)))
        stop = threading.Event()
        sentinel = object()
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stager():
            try:
                for batch in iterator:
                    pos = getattr(loader, "_speechbrain_iterator_position",
                                  None)
                    event = None
                    if cuda:
                        with torch.cuda.stream(side):
                            prepared = self.prepare_batch(batch)
                            event = torch.cuda.Event()
                            event.record(side)
                    else:
                        prepared = self.prepare_batch(batch)
                    if not put((prepared, pos, event)):
                        break
            except Exception as e:
                put(e)
                return
            finally:
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
            put(sentinel)

        thread = threading.Thread(target=stager, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.staging_wait_seconds += time.perf_counter() - t0
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                prepared, pos, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for v in prepared.values():
                        v.record_stream(consumer)
                if loader is not None:
                    loader._speechbrain_staged_position = pos
                yield prepared
        finally:
            stop.set()
            thread.join()
            if loader is not None:
                loader._speechbrain_staged_position = None

    @staticmethod
    def _progress(iterable, total):
        """A ``tqdm`` bar over ``iterable`` where tqdm is installed; the
        iterable itself where it is not (no code path needs it)."""
        try:
            from tqdm import tqdm
        except ImportError:
            return iterable
        return tqdm(iterable, total=total, dynamic_ncols=True)

    def _fit_train(self, train_set, epoch, progressbar):
        self.on_stage_start(Stage.TRAIN, epoch)
        for attr in ("sampler", "batch_sampler"):
            sampler = getattr(train_set, attr, None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
        self.avg_train_loss = 0.0
        self._synced_loss_sum = 0.0
        self._synced_loss_count = 0
        self._pending_losses = []
        use_staging = int(self.staging_depth or 0) > 0
        source = (self._staged_iter(iter(train_set), train_set)
                  if use_staging else train_set)
        iterator = source
        if progressbar:
            iterator = self._progress(
                source, len(train_set) if hasattr(train_set, "__len__")
                else None)
        spe = max(1, int(self.steps_per_execute or 1))
        fused = (spe > 1 and self.grad_accumulation_factor == 1
                 and type(self).fit_batch is Brain.fit_batch)
        window, window_key = [], None

        def flush_window():
            nonlocal window, window_key
            if window:
                self.step += len(window)
                self.fit_batches(window)
                window, window_key = [], None

        try:
            for batch in iterator:
                if fused:
                    prepared = self.prepare_batch(batch)
                    key = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                                       for k, v in prepared.items()))
                    if window and key != window_key:
                        flush_window()  # the bucket changed mid-window
                    window.append(prepared)
                    window_key = key
                    if len(window) < spe and not (
                            self.debug
                            and self.step + len(window) >= self.debug_batches):
                        continue
                    flush_window()
                else:
                    self.step += 1
                    loss = self.fit_batch(batch)
                    if isinstance(loss, float) and hasattr(iterator,
                                                           "set_postfix"):
                        iterator.set_postfix(train_loss=self.avg_train_loss)
                if (self.checkpointer is not None
                        and self.ckpt_interval_minutes > 0
                        and time.time() - self._last_ckpt_time
                        >= self.ckpt_interval_minutes * 60.0):
                    self._save_intra_epoch_ckpt()
                if self.debug and self.step >= self.debug_batches:
                    break
            flush_window()
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()  # stops the staging thread after an early break
        self._sync_losses()  # the tail of the pending losses
        self.on_stage_end(Stage.TRAIN, self.avg_train_loss, epoch)
        self.train_loss = self.avg_train_loss
        self.step = 0

    def _evaluate_stage(self, dataset, stage, epoch):
        self.on_stage_start(stage, epoch)
        avg_loss, step = 0.0, 0
        for batch in dataset:
            step += 1
            loss = self.evaluate_batch(batch, stage)
            avg_loss += (loss - avg_loss) / step
            if self.debug and step >= self.debug_batches:
                break
        run_on_main(self.on_stage_end, args=[stage, avg_loss, epoch])
        return avg_loss

    def _fit_valid(self, valid_set, epoch):
        if valid_set is not None:
            self._evaluate_stage(valid_set, Stage.VALID, epoch)

    def evaluate(self, test_set, max_key=None, min_key=None,
                 progressbar=None, test_loader_kwargs={}):
        """The TEST stage over ``test_set``, after ``on_evaluate_start``
        recovers the checkpoint that is best by ``max_key``/``min_key``
        (the latest when neither is given); returns the average loss."""
        test_set = self.make_dataloader(test_set, Stage.TEST,
                                        **test_loader_kwargs)
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        avg_test_loss = self._evaluate_stage(test_set, Stage.TEST, None)
        self.step = 0
        return avg_test_loss

    def _save_intra_epoch_ckpt(self):
        self._last_ckpt_time = time.time()
        self.checkpointer.save_and_keep_only(
            end_of_epoch=False,
            num_to_keep=1,
            ckpt_predicate=lambda c: INTRA_EPOCH_CKPT_FLAG in c.meta,
            meta={INTRA_EPOCH_CKPT_FLAG: True},
        )

    # ------------------------------------------------------------ checkpoints

    @mark_as_saver
    def _save(self, path):
        with open(path, "w") as w:
            json.dump({
                "step": self.step,
                "optimizer_step": self.optimizer_step,
                "avg_train_loss": self.avg_train_loss,
                "lr": float(self.lr),
            }, w)

    @mark_as_loader
    def _recover(self, path, end_of_epoch=True):
        with open(path) as f:
            save_dict = json.load(f)
        self.step = save_dict["step"]
        self.optimizer_step = save_dict["optimizer_step"]
        self.avg_train_loss = save_dict["avg_train_loss"]
        self.lr = save_dict.get("lr", self.lr)
        if end_of_epoch:
            self.step = 0


@register_checkpoint_hooks
class _TrainStateRecoverable:
    """Checkpoints the Brain's train state: the modules' ``state_dict``,
    the optimizer's and the generator's state, in one ``torch.save``
    file, read back with ``weights_only=True`` onto the Brain's device.
    The generator's state is kept with its device type and restored only
    into a generator of that type (a CUDA generator's Philox state and a
    CPU generator's mt19937 state do not convert): a checkpoint moved
    between the card and the CPU, or one without the generator's state,
    leaves the generator as it is.  The optimizer's state is keyed by
    parameter order, which the ``ModuleDict`` fixes."""

    def __init__(self, brain):
        self.brain = brain

    @mark_as_saver
    def _save(self, path):
        opt = self.brain.optimizer
        torch.save({
            "modules": self.brain.modules.state_dict(),
            "optimizer": None if opt is None else opt.state_dict(),
            "generator": {"device": self.brain.generator.device.type,
                          "state": self.brain.generator.get_state()},
        }, path)

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        state = torch.load(path, map_location=self.brain.device,
                           weights_only=True)
        self.brain.modules.load_state_dict(state["modules"])
        if state["optimizer"] is not None and self.brain.optimizer is not None:
            self.brain.optimizer.load_state_dict(state["optimizer"])
        saved = state.get("generator")
        if saved is not None and (
                saved["device"] == self.brain.generator.device.type):
            self.brain.generator.set_state(saved["state"].cpu())
