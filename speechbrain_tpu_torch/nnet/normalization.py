"""Normalization layers, channels-last.

Counterpart of ``speechbrain_tpu/nnet/normalization.py``.  Only eval
mode (running statistics) is ported: serving never updates them.
"""

import torch
import torch.nn.functional as F

__all__ = ["BatchNorm1d"]


class BatchNorm1d(torch.nn.Module):
    """BatchNorm over the last (channel) axis of any-rank input, from
    running statistics: ``(x - mean) / sqrt(var + eps) * weight + bias``.

    Example
    -------
    >>> bn = BatchNorm1d(8)
    >>> bn(torch.ones(4, 10, 8)).shape
    torch.Size([4, 10, 8])
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(num_features))
        self.bias = torch.nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        """x: (..., C)."""
        shape = x.shape
        y = F.batch_norm(
            x.reshape(-1, shape[-1]), self.running_mean.to(x.dtype),
            self.running_var.to(x.dtype), self.weight.to(x.dtype),
            self.bias.to(x.dtype), training=False, eps=self.eps,
        )
        return y.reshape(shape)
