"""Convolutions, channels-last, with the JAX package's padding semantics.

Counterpart of ``speechbrain_tpu/nnet/CNN.py``: ``Conv1d`` over (batch,
time, channels) with its ``_pad_1d`` ("same", reflect by default;
"causal"; "valid"), and ``Conv2d`` over (batch, time, feature[,
channels]) with "same" padding (``_pad2d_same``, the only padding the
front end uses), ``ConvTranspose1d``, ``get_padding_elem`` and
``get_padding_elem_transposed``.  Inputs and outputs keep the JAX layout;
the convolutions run as ``F.conv1d``/``F.conv_transpose1d`` over (B, C, T)
and ``F.conv2d`` over (B, C, T, F), with the 2-d kernel's first spatial
axis on time.
"""

import torch
import torch.nn.functional as F

__all__ = ["Conv1d", "Conv2d", "ConvTranspose1d", "get_padding_elem",
           "get_padding_elem_transposed"]


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


def get_padding_elem_transposed(L_out, L_in, stride, kernel_size, dilation,
                                output_padding):
    """The padding a transposed convolution needs to reach ``L_out``.

    Example
    -------
    >>> get_padding_elem_transposed(100, 50, 2, 4, 1, 0)
    1
    """
    padding = -0.5 * (L_out - (L_in - 1) * stride - dilation * (kernel_size - 1)
                      - output_padding - 1)
    return int(padding)


def _pad_1d(x, kernel_size, dilation, stride, padding, padding_mode="reflect"):
    """x: (B, C, T), padded along T as the JAX ``_pad_1d`` pads: "same"
    symmetrically by ``get_padding_elem``, in reflect mode or (any other
    mode) with zeros; "causal" with (k - 1) d zeros on the left; "valid"
    not at all."""
    if padding == "same":
        left, right = get_padding_elem(x.shape[-1], stride, kernel_size,
                                       dilation)
        mode = "reflect" if padding_mode == "reflect" else "constant"
        return F.pad(x, (left, right), mode=mode)
    if padding == "causal":
        return F.pad(x, ((kernel_size - 1) * dilation, 0))
    if padding == "valid":
        return x
    raise ValueError(f"Unknown padding {padding}")


class Conv1d(torch.nn.Module):
    """1-d convolution over (B, T, in_channels) -> (B, T', out_channels)
    (a (B, T) input is one channel), padded by ``_pad_1d``, then a VALID
    convolution with ``stride``, ``dilation`` and ``groups``; it runs in
    the input's dtype.  ``weight`` is (out, in / groups, k): the JAX
    kernel (k, in / groups, out) through ``bridge.conv1d``.

    Example
    -------
    >>> conv = Conv1d(16, 8, kernel_size=3)
    >>> conv(torch.ones(2, 40, 16)).shape
    torch.Size([2, 40, 8])
    >>> Conv1d(16, 8, kernel_size=3, padding="valid")(torch.ones(2, 40, 16)).shape
    torch.Size([2, 38, 8])
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 dilation=1, padding="same", groups=1, bias=True,
                 padding_mode="reflect"):
        super().__init__()
        if padding not in ("same", "causal", "valid"):
            raise ValueError(f"Unknown padding {padding}")
        self.kernel_size, self.stride = kernel_size, stride
        self.dilation, self.groups = dilation, groups
        self.padding, self.padding_mode = padding, padding_mode
        self.weight = torch.nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = (torch.nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)
        torch.nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        """x: (B, T, in_channels) or (B, T)."""
        if x.dim() == 2:
            x = x[..., None]
        x = _pad_1d(x.transpose(1, 2), self.kernel_size, self.dilation,
                    self.stride, self.padding, self.padding_mode)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x, self.weight.to(x.dtype), bias, stride=self.stride,
                     dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


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


class ConvTranspose1d(torch.nn.Module):
    """Transposed 1-d convolution over (B, T, in_channels) -> (B, T',
    out_channels) (a (B, T) input is one channel), with the JAX module's
    length: the full transposed convolution ((T - 1) stride + k frames)
    cut to ``[padding, padding + target)``, ``target`` being PyTorch's
    ``(T - 1) stride - 2 padding + k + output_padding``, so an
    ``output_padding`` above ``padding`` gives fewer frames than
    ``target``, as in JAX.  ``weight`` is PyTorch's (in, out, k): the
    JAX kernel (k, in, out), which Flax applies without flipping its
    taps, with its taps reversed (``bridge.conv_transpose1d``).

    Example
    -------
    >>> up = ConvTranspose1d(8, 4, kernel_size=4, stride=2, padding=1)
    >>> up(torch.ones(1, 10, 8)).shape
    torch.Size([1, 20, 4])
    """

    weight_in_out = True  # fan-in on weight.shape[0] (``asr._random_init``)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, bias=True):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.output_padding = padding, output_padding
        self.weight = torch.nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = (torch.nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)
        torch.nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        """x: (B, T, in_channels) or (B, T)."""
        if x.dim() == 2:
            x = x[..., None]
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight.to(x.dtype),
                               bias, stride=self.stride)
        target = ((x.shape[1] - 1) * self.stride - 2 * self.padding
                  + self.kernel_size + self.output_padding)
        return y[..., self.padding:self.padding + target].transpose(1, 2)
