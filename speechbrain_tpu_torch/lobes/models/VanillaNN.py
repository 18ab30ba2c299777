"""A stack of dense blocks.

Counterpart of ``speechbrain_tpu/lobes/models/VanillaNN.py``
(``VanillaNN``): ``dnn_blocks`` x (Linear + leaky relu, slope 0.01).
The JAX ``Dense_{i}`` layers are ``linears.{i}`` here (``bridge.py``).
The JAX module's ``activation`` field goes unused (it applies leaky relu
whatever the field says), so the port has none.
"""

import torch

from ...nnet.linear import Linear

__all__ = ["VanillaNN"]


class VanillaNN(torch.nn.Module):
    """``dnn_blocks`` x (``Linear`` to ``dnn_neurons`` + ``leaky_relu``).

    Example
    -------
    >>> VanillaNN(16, dnn_blocks=2, dnn_neurons=32)(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 32])
    """

    def __init__(self, input_size, dnn_blocks=2, dnn_neurons=512):
        super().__init__()
        sizes = [input_size] + [dnn_neurons] * dnn_blocks
        self.linears = torch.nn.ModuleList(
            Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:]))
        self.output_size = dnn_neurons

    def forward(self, x):
        """x: (..., input_size), in its dtype."""
        for lin in self.linears:
            x = torch.nn.functional.leaky_relu(lin(x), 0.01)
        return x
