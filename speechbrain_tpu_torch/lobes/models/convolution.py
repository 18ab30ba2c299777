"""Convolutional front end for transformer ASR (time subsampling).

Counterpart of ``speechbrain_tpu/lobes/models/convolution.py``
(``ConvolutionFrontEnd``), eval mode, batchnorm blocks.
"""

import torch

from ...nnet.CNN import Conv2d
from ...nnet.normalization import BatchNorm1d

__all__ = ["ConvolutionFrontEnd"]


class ConvolutionFrontEnd(torch.nn.Module):
    """Blocks of Conv2d -> BatchNorm -> ReLU over (B, T, F[, C]), then
    flatten to (B, T', F' * C) with channels fastest.

    Example
    -------
    >>> fe = ConvolutionFrontEnd(num_blocks=2, out_channels=(16, 32))
    >>> fe(torch.ones(2, 100, 80)).shape
    torch.Size([2, 25, 640])
    """

    def __init__(self, num_blocks=3, num_layers_per_block=1,
                 out_channels=(128, 256, 512), kernel_sizes=((3, 3),) * 8,
                 strides=(2, 2, 1, 1, 1, 1, 1, 1), in_channels=1):
        super().__init__()
        self.convs = torch.nn.ModuleList()
        self.norms = torch.nn.ModuleList()
        c_in = in_channels
        for b in range(num_blocks):
            for layer in range(num_layers_per_block):
                last = layer == num_layers_per_block - 1
                stride = strides[b] if last else 1
                self.convs.append(Conv2d(
                    c_in, out_channels[b], kernel_size=kernel_sizes[b],
                    stride=(stride, stride),
                ))
                self.norms.append(BatchNorm1d(out_channels[b]))
                c_in = out_channels[b]

    def forward(self, x):
        """x: (B, T, F) features."""
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x)))
        b, t, f, c = x.shape
        return x.reshape(b, t, f * c)
