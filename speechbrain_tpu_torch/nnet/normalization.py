"""Normalization layers, channels-last.

Counterpart of ``speechbrain_tpu/nnet/normalization.py`` (``BatchNorm1d``,
a ``flax.linen.BatchNorm`` with momentum 0.1 on the running statistics).
"""

import torch
import torch.nn.functional as F

__all__ = ["BatchNorm1d"]


class BatchNorm1d(torch.nn.Module):
    """BatchNorm over the last (channel) axis of any-rank input.

    In eval mode it normalizes with the running statistics.  In training
    mode it normalizes with the batch statistics over every axis but the
    last, computed in float32 as Flax computes them (mean of x and of
    x^2, var = max(0, E[x^2] - E[x]^2)), and updates the running
    statistics the way Flax does: ``running = 0.9 running + 0.1 batch``
    with the **biased** batch variance.  (``F.batch_norm(training=True)``
    would update ``running_var`` with the unbiased one.)

    Example
    -------
    >>> bn = BatchNorm1d(8)
    >>> bn(torch.ones(4, 10, 8)).shape
    torch.Size([4, 10, 8])
    >>> bn2 = BatchNorm1d(1).train()
    >>> _ = bn2(torch.tensor([[0.0], [2.0]]))  # mean 1, biased var 1
    >>> bn2.running_mean.tolist(), bn2.running_var.tolist()
    ([0.10000000149011612], [1.0])
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = torch.nn.Parameter(torch.ones(num_features))
        self.bias = torch.nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        """x: (..., C)."""
        if self.training:
            return self._train_forward(x)
        shape = x.shape
        y = F.batch_norm(
            x.reshape(-1, shape[-1]), self.running_mean.to(x.dtype),
            self.running_var.to(x.dtype), self.weight.to(x.dtype),
            self.bias.to(x.dtype), training=False, eps=self.eps,
        )
        return y.reshape(shape)

    def _train_forward(self, x):
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        var = ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
            self.running_var.mul_(1.0 - m).add_(m * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)
