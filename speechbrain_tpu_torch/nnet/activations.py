"""Activations with parameters.

Counterpart of Flax's ``nn.PReLU``, which the JAX package's separation
models use (``lobes/models/dual_path.py``, ``lobes/models/conv_tasnet.py``).
"""

import torch

__all__ = ["PReLU"]


class PReLU(torch.nn.Module):
    """``x`` where ``x >= 0``, else ``a x``, with one learned slope ``a``
    (``weight``, a scalar: Flax's ``negative_slope``) that starts at
    ``init``; the slope is cast to the input's dtype.

    Example
    -------
    >>> PReLU(0.25)(torch.tensor([-2.0, 0.0, 3.0])).tolist()
    [-0.5, 0.0, 3.0]
    """

    def __init__(self, init=0.01):
        super().__init__()
        self.init = init
        self.weight = torch.nn.Parameter(torch.tensor(float(init)))

    def reset_parameters(self):
        """The slope back to ``init``."""
        with torch.no_grad():
            self.weight.fill_(self.init)

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)
