"""Linear layer over the last axis.

Counterpart of ``speechbrain_tpu/nnet/linear.py`` (``Linear``): the JAX
``(in, out)`` kernel becomes ``weight (out, in)`` through ``bridge.py``.
"""

import torch

__all__ = ["Linear"]


class Linear(torch.nn.Linear):
    """``y = x W^T + b`` over the last axis; the computation runs in the
    input's dtype (parameters are cast to it, as the JAX module does).

    Example
    -------
    >>> Linear(8, 4)(torch.ones(2, 10, 8)).shape
    torch.Size([2, 10, 4])
    """

    def forward(self, x):
        """x: (..., in_features)."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return torch.nn.functional.linear(x, self.weight.to(x.dtype), bias)
