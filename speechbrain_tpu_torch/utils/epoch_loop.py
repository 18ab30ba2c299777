"""Checkpoint-recoverable epoch iteration.

A copy of ``speechbrain_tpu/utils/epoch_loop.py``'s ``EpochCounter``
(the port imports nothing of the JAX package);
``EpochCounterWithStopper`` is not ported.

Example
-------
>>> counter = EpochCounter(3)
>>> [e for e in counter]
[1, 2, 3]
"""

import logging

from .checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)

logger = logging.getLogger(__name__)

__all__ = ["EpochCounter"]


@register_checkpoint_hooks
class EpochCounter:
    """Iterator yielding epoch numbers 1..limit; resumes from checkpoints."""

    def __init__(self, limit):
        self.current = 0
        self.limit = int(limit)

    def __iter__(self):
        return self

    def __next__(self):
        if self.current < self.limit:
            self.current += 1
            logger.info(f"Going into epoch {self.current}")
            return self.current
        raise StopIteration

    @mark_as_saver
    def _save(self, path):
        with open(path, "w") as fo:
            fo.write(str(self.current))

    @mark_as_loader
    def _recover(self, path, end_of_epoch=True):
        with open(path) as fi:
            saved_value = int(fi.read())
            if end_of_epoch:
                self.current = saved_value
            else:
                # Mid-epoch recovery: the saved epoch did not complete.
                self.current = saved_value - 1
