"""Dropout with an explicit generator.

Counterpart of ``flax.linen.Dropout`` as the JAX package uses it
(``speechbrain_tpu/nnet/dropout.py``): in training, each element is
kept with probability 1 - p and scaled by 1 / (1 - p); otherwise the
input passes unchanged.  ``Dropout2d`` drops whole channels: one keep
mask of shape (B, 1, ..., 1, C).  The mask is drawn from ``generator``, a
``torch.Generator`` on the input's device that the trainer owns and
seeds (``core.Brain`` sets it on every ``Dropout`` it trains), never
from PyTorch's global generator.  The masks cannot equal JAX's.
"""

import torch

__all__ = ["Dropout", "Dropout2d"]


class Dropout(torch.nn.Module):
    """Inverted dropout drawing its mask from ``self.generator``.

    Example
    -------
    >>> drop = Dropout(0.5)
    >>> drop.generator = torch.Generator().manual_seed(0)
    >>> y = drop(torch.ones(1000))
    >>> sorted(set(y.tolist())), 400 < int((y > 0).sum()) < 600
    ([0.0, 2.0], True)
    >>> drop.eval()(torch.ones(3)).tolist()
    [1.0, 1.0, 1.0]
    """

    def __init__(self, p=0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} outside [0, 1)")
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        """x: any shape; returns x's shape and dtype."""
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "Dropout in training needs a generator (set by core.Brain)"
            )
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u >= self.p, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2d(Dropout):
    """Channel dropout over (B, ..., C): one keep mask of shape
    (B, 1, ..., 1, C), drawn from ``self.generator``, scaled by
    1 / (1 - p); a ``Dropout`` (``core.Brain`` sets its generator).

    Example
    -------
    >>> drop = Dropout2d(0.5)
    >>> drop.generator = torch.Generator().manual_seed(0)
    >>> y = drop(torch.ones(2, 5, 3, 8))
    >>> bool((y == y[:, :1, :1]).all()), sorted(set(y.flatten().tolist()))
    (True, [0.0, 2.0])
    """

    def forward(self, x):
        """x: (B, ..., C); returns x's shape and dtype."""
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "Dropout2d in training needs a generator (set by core.Brain)"
            )
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        u = torch.rand(shape, generator=self.generator, device=x.device)
        keep = (u >= self.p).to(x.dtype)
        return x * keep / (1.0 - self.p)
