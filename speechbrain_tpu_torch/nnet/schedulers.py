"""Learning-rate schedulers (host-side, checkpointable).

Counterpart of ``speechbrain_tpu/nnet/schedulers.py`` (``NewBobScheduler``,
``NoamScheduler``, ``ReduceLROnPlateau`` and ``CyclicLRScheduler``, each with ``_save``/``_load``
through copies of ``_save_attrs`` and ``_load_attrs``).  The linear and
step schedulers are not ported.
"""

import json
import math

from ..utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)

__all__ = ["NewBobScheduler", "NoamScheduler", "ReduceLROnPlateau",
           "CyclicLRScheduler"]


def _save_attrs(obj, path, attrs):
    with open(path, "w") as f:
        json.dump({a: getattr(obj, a) for a in attrs}, f)


def _load_attrs(obj, path, attrs):
    with open(path) as f:
        data = json.load(f)
    for a in attrs:
        if a in data:
            setattr(obj, a, data[a])


@register_checkpoint_hooks
class NewBobScheduler:
    """Metric-driven annealing, called once an epoch with the validation
    metric (lower is better): when the relative improvement over the
    previous call's metric is below ``improvement_threshold`` and
    ``patient`` calls have already waited, the value is multiplied by
    ``annealing_factor``.  Returns ``(old value, new value)``.  A
    checkpoint holds ``hyperparam_value``, ``metric_values`` and
    ``current_patient``.

    Example
    -------
    >>> scheduler = NewBobScheduler(initial_value=1.0)
    >>> scheduler(0.5)
    (1.0, 1.0)
    >>> scheduler(0.5)
    (1.0, 0.5)
    """

    def __init__(self, initial_value, annealing_factor=0.5,
                 improvement_threshold=0.0025, patient=0):
        self.hyperparam_value = initial_value
        self.annealing_factor = annealing_factor
        self.improvement_threshold = improvement_threshold
        self.patient = patient
        self.metric_values = []
        self.current_patient = self.patient

    def __call__(self, metric_value):
        old_value = new_value = self.hyperparam_value
        if len(self.metric_values) > 0:
            prev_metric = self.metric_values[-1]
            if prev_metric == 0:
                improvement = 0
            else:
                improvement = (prev_metric - metric_value) / prev_metric
            if improvement < self.improvement_threshold:
                if self.current_patient == 0:
                    new_value = old_value * self.annealing_factor
                    self.current_patient = self.patient
                else:
                    self.current_patient -= 1
        self.metric_values.append(float(metric_value))
        self.hyperparam_value = new_value
        return old_value, new_value

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path,
                    ["hyperparam_value", "metric_values", "current_patient"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        _load_attrs(self, path,
                    ["hyperparam_value", "metric_values", "current_patient"])


@register_checkpoint_hooks
class NoamScheduler:
    """``lr_initial * normalize * min(step^-0.5, step * n_warmup^-1.5)``,
    stepped once per optimizer step (the transformer recipes' schedule);
    ``normalize`` is ``n_warmup^0.5``, or ``model_size^-0.5`` when
    ``model_size`` is given.

    Each call advances the step and returns ``(previous lr, new lr)``.
    A checkpoint holds ``current_lr`` and ``n_steps``.

    Example
    -------
    >>> s = NoamScheduler(lr_initial=1.0, n_warmup_steps=10)
    >>> _, lr1 = s()
    >>> _, lr2 = s()
    >>> lr2 > lr1
    True
    """

    def __init__(self, lr_initial, n_warmup_steps, model_size=None):
        self.lr_initial = lr_initial
        self.n_warmup_steps = n_warmup_steps
        self.current_lr = lr_initial
        self.n_steps = 0
        self.normalize = n_warmup_steps ** 0.5
        if model_size is not None:
            self.normalize = model_size ** (-0.5)

    def __call__(self, opt_or_none=None):
        self.n_steps += 1
        current_lr = self.current_lr
        lr = self.lr_initial * self._get_lr_scale()
        self.current_lr = lr
        return current_lr, lr

    def _get_lr_scale(self):
        n_steps, n_warmup_steps = self.n_steps, self.n_warmup_steps
        return self.normalize * min(
            n_steps ** (-0.5), n_steps * n_warmup_steps ** (-1.5)
        )

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path, ["current_lr", "n_steps"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        _load_attrs(self, path, ["current_lr", "n_steps"])


@register_checkpoint_hooks
class ReduceLROnPlateau:
    """Halves (``factor``) the rate when the loss stops improving, called
    once an epoch as ``(current_lr, current_epoch, current_loss)`` and
    returning ``(current_lr, next_lr)``.  Up to epoch
    ``dont_halve_until_epoch`` the rate is kept and the loss becomes the
    ``anchor``; after it, a loss at or below the anchor becomes the anchor
    and resets the patience, a higher one waits ``patience`` calls and
    then multiplies the rate by ``factor`` (the anchor stays).  The rate
    never goes below ``lr_min``.  A checkpoint holds ``losses``,
    ``anchor`` and ``patience_counter``.

    Example
    -------
    >>> s = ReduceLROnPlateau(lr_min=0.1, factor=0.5, patience=0)
    >>> s(1.0, current_epoch=1, current_loss=10.0)
    (1.0, 1.0)
    >>> s(1.0, current_epoch=2, current_loss=11.0)
    (1.0, 0.5)
    """

    def __init__(self, lr_min=1e-8, factor=0.5, patience=2,
                 dont_halve_until_epoch=0):
        self.lr_min = lr_min
        self.factor = factor
        self.patience = patience
        self.patience_counter = 0
        self.losses = []
        self.dont_halve_until_epoch = dont_halve_until_epoch
        self.anchor = 99999.0

    def __call__(self, current_lr, current_epoch, current_loss):
        if current_epoch <= self.dont_halve_until_epoch:
            next_lr = current_lr
            self.anchor = current_loss
        elif current_loss <= self.anchor:
            self.patience_counter = 0
            next_lr = current_lr
            self.anchor = current_loss
        elif self.patience_counter < self.patience:
            self.patience_counter += 1
            next_lr = current_lr
        else:
            next_lr = current_lr * self.factor
            self.patience_counter = 0
        next_lr = max(self.lr_min, next_lr)
        self.losses.append(float(current_loss))
        return current_lr, next_lr

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path, ["losses", "anchor", "patience_counter"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        _load_attrs(self, path, ["losses", "anchor", "patience_counter"])


@register_checkpoint_hooks
class CyclicLRScheduler:
    """Cyclic rate between ``base_lr`` and ``max_lr``, stepped once per
    optimizer step: a triangle of half-period ``step_size`` steps, its
    height scaled by 1 (``"triangular"``), halved every cycle
    (``"triangular2"``) or ``gamma ** cycle`` (``"exp_range"``, any other
    mode).  Each call advances ``clr_iterations`` and returns
    ``(previous lr, new lr)``; a checkpoint holds ``clr_iterations`` and
    ``current_lr``.

    Example
    -------
    >>> s = CyclicLRScheduler(base_lr=0.1, max_lr=0.5, step_size=2)
    >>> [round(s()[1], 3) for _ in range(5)]
    [0.3, 0.5, 0.3, 0.1, 0.3]
    """

    def __init__(self, base_lr=0.001, max_lr=0.006, step_size=2000,
                 mode="triangular", gamma=1.0):
        self.base_lr = base_lr
        self.max_lr = max_lr
        self.step_size = step_size
        self.mode = mode
        self.gamma = gamma
        self.clr_iterations = 0
        self.current_lr = base_lr

    def _scale(self, x):
        if self.mode == "triangular":
            return 1.0
        if self.mode == "triangular2":
            return 1 / (2.0 ** (x - 1))
        return self.gamma ** x

    def __call__(self, opt_or_none=None):
        self.clr_iterations += 1
        current = self.current_lr
        cycle = math.floor(1 + self.clr_iterations / (2 * self.step_size))
        x = abs(self.clr_iterations / self.step_size - 2 * cycle + 1)
        lr = self.base_lr + (self.max_lr - self.base_lr) * max(
            0, 1 - x) * self._scale(cycle)
        self.current_lr = lr
        return current, lr

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path, ["clr_iterations", "current_lr"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        _load_attrs(self, path, ["clr_iterations", "current_lr"])
