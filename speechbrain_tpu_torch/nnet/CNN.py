"""2-d convolution over (batch, time, feature[, channels]) with the JAX
package's "same" padding semantics (the only padding the front end uses).

Counterpart of ``speechbrain_tpu/nnet/CNN.py`` (``Conv2d``,
``_pad2d_same``, ``get_padding_elem``).  Input and output keep the JAX
layout (B, T, F, C); the convolution runs as ``F.conv2d`` over
(B, C, T, F), with the kernel's first spatial axis on time.
"""

import torch
import torch.nn.functional as F

__all__ = ["Conv2d", "get_padding_elem"]


def get_padding_elem(L_in, stride, kernel_size, dilation):
    """Symmetric "same" padding: floor(k/2) each side when stride > 1,
    else what keeps the length.

    Example
    -------
    >>> get_padding_elem(100, 1, 3, 1), get_padding_elem(100, 2, 3, 1)
    ([1, 1], [1, 1])
    """
    if stride > 1:
        return [kernel_size // 2, kernel_size // 2]
    L_out = (L_in - dilation * (kernel_size - 1) - 1) // stride + 1
    return [(L_in - L_out) // 2, (L_in - L_out) // 2]


def _pad2d_same(x, kh, kw, sh, sw):
    """x: (B, C, T, F); reflect-pads T by get_padding_elem(kh) and F by
    get_padding_elem(kw)."""
    ph = get_padding_elem(x.shape[2], sh, kh, 1)
    pw = get_padding_elem(x.shape[3], sw, kw, 1)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), mode="reflect")


class Conv2d(torch.nn.Module):
    """2-d convolution with "same" padding, (B, T, F[, C]) ->
    (B, T', F', out_channels).

    ``kernel_size``/``stride`` are given as in the JAX module: index 0
    acts on the feature axis and index 1 on time (the reference's
    quirk), and ``weight`` is (out, in, k_time, k_freq).  Padding is
    reflect-mode ``get_padding_elem`` per axis: floor(k/2) each side
    when the stride is above 1, not PyTorch's own "same".

    Example
    -------
    >>> conv = Conv2d(1, 4, kernel_size=(3, 3), stride=(2, 2))
    >>> conv(torch.ones(2, 20, 40)).shape
    torch.Size([2, 10, 20, 4])
    """

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3),
                 stride=(1, 1)):
        super().__init__()
        self.kw, self.kh = kernel_size
        self.sw, self.sh = stride
        self.weight = torch.nn.Parameter(
            torch.empty(out_channels, in_channels, self.kh, self.kw)
        )
        self.bias = torch.nn.Parameter(torch.zeros(out_channels))
        torch.nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        """x: (B, T, F) or (B, T, F, C)."""
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # (B, C, T, F)
        x = _pad2d_same(x, self.kh, self.kw, self.sh, self.sw)
        y = F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=(self.sh, self.sw))
        return y.permute(0, 2, 3, 1)
