"""X-vector embedding model (TDNN + statistics pooling) and its
classifier head.

Counterpart of ``speechbrain_tpu/lobes/models/Xvector.py`` (``Xvector``,
``Classifier``), the model of the Google Speech Commands recipe
(``hparams/xvect.yaml``).  The modules are built from their input's
width (``input_size``), since a torch module's parameters exist before
its first call (Flax infers them then).  ``Discriminator`` is not
ported.
"""

import torch
import torch.nn.functional as F

from ...nnet.CNN import Conv1d
from ...nnet.linear import Linear
from ...nnet.normalization import BatchNorm1d
from ...nnet.pooling import StatisticsPooling

__all__ = ["Xvector", "Classifier"]


class TDNNBlock(torch.nn.Module):
    """``Conv1d`` ("same", reflect) -> ``leaky_relu(0.01)`` ->
    ``BatchNorm1d`` (momentum 0.1), over (B, T, C)."""

    def __init__(self, in_channels, channels, kernel_size, dilation):
        super().__init__()
        self.conv = Conv1d(in_channels, channels, kernel_size,
                           dilation=dilation)
        self.norm = BatchNorm1d(channels)

    def forward(self, x):
        return self.norm(F.leaky_relu(self.conv(x), 0.01))


class Xvector(torch.nn.Module):
    """TDNN blocks -> ``StatisticsPooling`` over each row's frames ->
    ``Linear``: (B, T, input_size) features -> (B, 1, lin_neurons).

    Arguments as in the JAX module, with ``input_size`` the feature bins
    (``n_mels``).  BatchNorm updates its statistics in training mode
    only.

    Example
    -------
    >>> model = Xvector(24, tdnn_channels=(8,) * 5, lin_neurons=4).eval()
    >>> model(torch.ones(2, 40, 24), lengths=torch.tensor([1.0, 0.5])).shape
    torch.Size([2, 1, 4])
    """

    def __init__(self, input_size, tdnn_blocks=5,
                 tdnn_channels=(512, 512, 512, 512, 1500),
                 tdnn_kernel_sizes=(5, 3, 3, 1, 1),
                 tdnn_dilations=(1, 2, 3, 1, 1), lin_neurons=512):
        super().__init__()
        blocks, width = [], input_size
        for i in range(tdnn_blocks):
            blocks.append(TDNNBlock(width, tdnn_channels[i],
                                    tdnn_kernel_sizes[i], tdnn_dilations[i]))
            width = tdnn_channels[i]
        self.blocks = torch.nn.ModuleList(blocks)
        self.pooling = StatisticsPooling()
        self.lin = Linear(2 * width, lin_neurons)

    def forward(self, x, lengths=None):
        """x (B, T, input_size); lengths (B,) relative or None."""
        for block in self.blocks:
            x = block(x)
        return self.lin(self.pooling(x, lengths))


class Classifier(torch.nn.Module):
    """``lin_blocks`` of (``Linear`` -> ``leaky_relu(0.01)`` ->
    ``BatchNorm1d``) over embeddings, then either a ``Linear`` to
    ``out_neurons`` and ``log_softmax``, or (``cosine``) the cosine
    similarity of each embedding with each class's centroid (the
    ``centroids`` parameter, (lin_neurons, out_neurons) as in JAX; both
    norms floored at 1e-8).

    Example
    -------
    >>> head = Classifier(8, out_neurons=3, lin_neurons=4).eval()
    >>> logp = head(torch.ones(2, 8))
    >>> logp.shape, bool(torch.allclose(logp.exp().sum(-1), torch.ones(2)))
    (torch.Size([2, 3]), True)
    >>> cos = Classifier(8, out_neurons=3, lin_neurons=4, cosine=True).eval()
    >>> bool((cos(torch.ones(2, 8)).abs() <= 1.0 + 1e-6).all())
    True
    """

    def __init__(self, input_size, out_neurons, lin_blocks=1, lin_neurons=512,
                 cosine=False):
        super().__init__()
        blocks, width = [], input_size
        for _ in range(lin_blocks):
            blocks.append(torch.nn.ModuleDict({
                "linear": Linear(width, lin_neurons),
                "norm": BatchNorm1d(lin_neurons)}))
            width = lin_neurons
        self.blocks = torch.nn.ModuleList(blocks)
        self.cosine = cosine
        if cosine:
            self.centroids = torch.nn.Parameter(
                torch.randn(lin_neurons, out_neurons) / lin_neurons ** 0.5)
        else:
            self.out = Linear(width, out_neurons)

    def forward(self, x):
        """x (..., input_size)."""
        for block in self.blocks:
            x = block["norm"](F.leaky_relu(block["linear"](x), 0.01))
        if self.cosine:
            w = self.centroids.to(x.dtype)
            x_norm = x / torch.linalg.vector_norm(
                x, dim=-1, keepdim=True).clamp(min=1e-8)
            w_norm = w / torch.linalg.vector_norm(
                w, dim=0, keepdim=True).clamp(min=1e-8)
            return x_norm @ w_norm
        return torch.log_softmax(self.out(x), -1)
