"""Learning-rate schedulers.

Counterpart of ``speechbrain_tpu/nnet/schedulers.py`` (``NoamScheduler``).
"""

__all__ = ["NoamScheduler"]


class NoamScheduler:
    """``lr_initial * n_warmup^0.5 * min(step^-0.5, step * n_warmup^-1.5)``,
    stepped once per optimizer step (the transformer recipes' schedule).

    Each call advances the step and returns ``(previous lr, new lr)``.

    Example
    -------
    >>> s = NoamScheduler(lr_initial=1.0, n_warmup_steps=10)
    >>> _, lr1 = s()
    >>> _, lr2 = s()
    >>> lr2 > lr1
    True
    """

    def __init__(self, lr_initial, n_warmup_steps):
        self.lr_initial = lr_initial
        self.n_warmup_steps = n_warmup_steps
        self.current_lr = lr_initial
        self.n_steps = 0
        self.normalize = n_warmup_steps ** 0.5

    def __call__(self):
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
