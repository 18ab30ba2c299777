"""Epoch-level training loggers.

Copies of ``speechbrain_tpu/utils/train_logger.py``'s ``TrainLogger``
and ``FileTrainLogger``, with the same line format (the port imports
nothing of the JAX package).  The TensorBoard and WandB loggers and
``ProgressSampleLogger`` are not ported.

Example
-------
>>> import os, tempfile
>>> path = os.path.join(tempfile.mkdtemp(), "train_log.txt")
>>> FileTrainLogger(path).log_stats({"epoch": 1, "lr": 1e-3},
...     train_stats={"loss": 2.5}, verbose=False)
>>> print(open(path).read(), end="")
epoch: 1, lr: 1.00e-03 - train loss: 2.50
"""

import logging

logger = logging.getLogger(__name__)

__all__ = ["TrainLogger", "FileTrainLogger"]


class TrainLogger:
    """Abstract interface: log one train/valid/test report per call."""

    def log_stats(
        self,
        stats_meta,
        train_stats=None,
        valid_stats=None,
        test_stats=None,
        verbose=False,
    ):
        """Log one stats entry (epoch/train/valid/test)."""
        raise NotImplementedError


class FileTrainLogger(TrainLogger):
    """One line per epoch in a text file.

    Example line:
    ``epoch: 2, lr: 1.00e-03 - train loss: 2.31 - valid loss: 2.10``
    """

    def __init__(self, save_file, precision=2):
        self.save_file = save_file
        self.precision = precision

    def _item_to_string(self, key, value, dataset=None):
        if isinstance(value, float) and 1.0 < value < 100.0:
            value = f"{value:.{self.precision}f}"
        elif isinstance(value, float):
            value = f"{value:.{self.precision}e}"
        if dataset is not None:
            key = f"{dataset} {key}"
        return f"{key}: {value}"

    def _stats_to_string(self, stats, dataset=None):
        return ", ".join(
            self._item_to_string(k, v, dataset) for k, v in stats.items()
        )

    def log_stats(
        self,
        stats_meta,
        train_stats=None,
        valid_stats=None,
        test_stats=None,
        verbose=True,
    ):
        """Log one stats entry (epoch/train/valid/test)."""
        string_summary = self._stats_to_string(stats_meta)
        for dataset, stats in [
            ("train", train_stats),
            ("valid", valid_stats),
            ("test", test_stats),
        ]:
            if stats is not None:
                string_summary += " - " + self._stats_to_string(stats, dataset)
        with open(self.save_file, "a") as fout:
            print(string_summary, file=fout)
        if verbose:
            logger.info(string_summary)
