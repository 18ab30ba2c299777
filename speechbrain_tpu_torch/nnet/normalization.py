"""Normalization layers, channels-last.

Counterpart of ``speechbrain_tpu/nnet/normalization.py``: ``BatchNorm1d``
(a ``flax.linen.BatchNorm`` with momentum 0.1 on the running statistics)
and ``LayerNorm`` (a ``flax.linen.LayerNorm`` over every axis after
(batch, time)).
"""

import torch
import torch.nn.functional as F

__all__ = ["BatchNorm1d", "LayerNorm"]


class BatchNorm1d(torch.nn.Module):
    """BatchNorm over the last (channel) axis of any-rank input.

    In eval mode it normalizes with the running statistics.  In training
    mode it normalizes with the batch statistics over every axis but the
    last, computed in float32 (float64 for a float64 input) as Flax
    computes them (mean of x and of x^2, var = max(0, E[x^2] - E[x]^2)),
    and updates the running statistics the way Flax does: ``running =
    0.9 running + 0.1 batch``
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
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        var = ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
            self.running_var.mul_(1.0 - m).add_(m * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).to(x.dtype)


class LayerNorm(torch.nn.Module):
    """LayerNorm over every axis after (batch, time), as the JAX module
    normalizes (the reference's ``normalized_shape = input_shape[2:]``):
    a (B, T, F, C) input is normalized jointly over (F, C), with affine
    parameters of shape (F, C); a 2-d input over its last axis.

    ``shape`` is the normalized shape, e.g. ``(F, C)``.  The statistics
    are computed in at least float32 (float64 stays float64) as Flax
    computes them (mean of x and of x^2, var = max(0, E[x^2] - E[x]^2)),
    and the result is cast back to the input's dtype (Flax's
    ``dtype=x.dtype``).  eps is 1e-5.

    Example
    -------
    >>> ln = LayerNorm((3, 2))
    >>> with torch.no_grad():
    ...     y = ln(torch.arange(24.0).reshape(2, 2, 3, 2))
    >>> y.shape, round(float(y[0, 0].mean()), 6), round(float(y[0, 0].std(unbiased=False)), 4)
    (torch.Size([2, 2, 3, 2]), 0.0, 1.0)
    """

    def __init__(self, shape, eps=1e-5):
        super().__init__()
        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(self.shape))
        self.bias = torch.nn.Parameter(torch.zeros(self.shape))

    def forward(self, x):
        """x: (B, T, *shape), or (B, *shape) for a 1-d ``shape``."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - len(self.shape), x.dim()))
        mean = xf.mean(axes, keepdim=True)
        var = ((xf * xf).mean(axes, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).to(x.dtype)
