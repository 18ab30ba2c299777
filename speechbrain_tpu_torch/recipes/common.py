"""What the port's recipes share: the folders and manifests of their
``build``, the Brain of the recipes whose rate NewBob anneals, and the
dtype their log-softmax runs in."""

import os

from ..asr import at_least_f32
from ..core import Brain, Stage
from ..nnet.schedulers import NewBobScheduler

__all__ = ["recipe_hparams", "NewBobBrain", "at_least_f32"]


def recipe_hparams(defaults, data_folder, output_folder, overrides=None,
                   manifests=()):
    """The values a recipe's ``build`` runs with: ``defaults`` with the
    two folders, then ``overrides``; unless set there, ``save_folder``
    is ``<output_folder>/save``, ``train_log`` is
    ``<output_folder>/train_log.txt`` and each ``(key, name)`` of
    ``manifests`` gives ``hp[key] = <save_folder>/<name>.json``.  Makes
    the output and save folders."""
    hp = dict(defaults, data_folder=data_folder, output_folder=output_folder)
    hp.update(overrides or {})
    hp.setdefault("save_folder", os.path.join(output_folder, "save"))
    hp.setdefault("train_log", os.path.join(output_folder, "train_log.txt"))
    for key, name in manifests:
        hp.setdefault(key, os.path.join(hp["save_folder"], f"{name}.json"))
    os.makedirs(output_folder, exist_ok=True)
    os.makedirs(hp["save_folder"], exist_ok=True)
    return hp


class NewBobBrain(Brain):
    """A recipe's ``Brain`` whose rate ``NewBobScheduler`` anneals once an
    epoch on a validation number, and whose checkpoints keep the best by
    a validation metric.

    A subclass names the metric (``metric``, e.g. "PER"), whether the
    best has its ``"min"`` or ``"max"`` (``best``), whether NewBob reads
    the metric or the validation loss (``anneal_on_loss``), and gives
    the stage's metric from ``summarize_metric``.  ``hparams`` must hold
    ``lr``, ``annealing_factor``, ``improvement_threshold`` and
    ``patient``.

    With a ``checkpointer`` the schedule is registered as
    ``"lr_annealing"``.  ``on_stage_end`` outside training keeps the
    stage's loss and metric in ``self.stage_stats[stage.name]``; at
    VALID it sets ``self.lr`` from the schedule, writes the line of
    ``hparams["train_logger"]`` (when given) and, with a checkpointer,
    saves one with the metric in its meta and keeps the best.
    """

    metric = None
    best = "min"
    anneal_on_loss = False

    def __init__(self, modules, opt_class, hparams, run_opts,
                 checkpointer=None):
        super().__init__(modules=modules, opt_class=opt_class,
                         hparams=hparams, run_opts=run_opts,
                         checkpointer=checkpointer)
        self.lr_annealing = NewBobScheduler(
            hparams["lr"], annealing_factor=hparams["annealing_factor"],
            improvement_threshold=hparams["improvement_threshold"],
            patient=hparams["patient"])
        if (checkpointer is not None
                and "lr_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("lr_annealing", self.lr_annealing)
        self.stage_stats = {}

    def summarize_metric(self):
        """The metric of the stage that ends."""
        raise NotImplementedError

    def extra_stats(self):
        """Further stats of the stage that ends, logged and kept beside
        the metric (none by default)."""
        return {}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The stage's stats; at VALID, NewBob, the log line and the
        keep-best checkpoint."""
        if stage == Stage.TRAIN:
            return
        value = self.summarize_metric()
        stats = {"loss": stage_loss, self.metric: value, **self.extra_stats()}
        self.stage_stats[stage.name] = stats
        if stage != Stage.VALID:
            return
        _, self.lr = self.lr_annealing(
            stage_loss if self.anneal_on_loss else value)
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            train_logger.log_stats(
                {"epoch": epoch, "lr": self.lr},
                train_stats={"loss": self.avg_train_loss},
                valid_stats=stats)
        if self.checkpointer is not None:
            self.checkpointer.save_and_keep_only(
                meta={self.metric: value},
                **{f"{self.best}_keys": [self.metric]})
