"""ECAPA-TDNN speaker embedding model and its AAM-softmax head.

Counterpart of ``speechbrain_tpu/lobes/models/ECAPA_TDNN.py``:
``TDNNBlock``, ``Res2NetBlock``, ``SEBlock``,
``AttentiveStatisticsPooling``, ``ECAPA_TDNN``, ``Classifier`` and
``SERes2NetBlock``, over (B, T, C) as the JAX modules.  The modules are
built from their input's width, since a torch module's parameters exist
before its first call (Flax infers them then).  The convolutions are the
port's ``nnet/CNN.Conv1d`` ("same" padding in reflect mode) and run on
cuDNN; the JAX package computes them with ``nn.Conv`` outside any Pallas
kernel, so this model runs no TPU kernel.

Two masks read the relative ``lengths`` as JAX reads them: frame t
counts when ``t < lengths * T`` (not rounded), in the SE blocks' time
mean and in the attentive pooling.
"""

import torch
import torch.nn.functional as F

from ...nnet.CNN import Conv1d
from ...nnet.linear import Linear
from ...nnet.normalization import BatchNorm1d

__all__ = [
    "TDNNBlock",
    "Res2NetBlock",
    "SEBlock",
    "AttentiveStatisticsPooling",
    "ECAPA_TDNN",
    "Classifier",
    "SERes2NetBlock",
]


def _length_mask(x, lengths):
    """(B, T, 1) in x's dtype: frame t of row b counts when
    ``t < lengths[b] * T``."""
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)
    return (ar[None, :] < (lengths.float() * T)[:, None]).to(x.dtype)[..., None]


class TDNNBlock(torch.nn.Module):
    """``Conv1d`` -> ReLU -> ``BatchNorm1d``, over (B, T, C).

    Example
    -------
    >>> TDNNBlock(4, 6, kernel_size=3, dilation=2)(torch.ones(2, 9, 4)).shape
    torch.Size([2, 9, 6])
    """

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           dilation=dilation)
        self.norm = BatchNorm1d(out_channels)

    def forward(self, x):
        return self.norm(F.relu(self.conv(x)))


class Res2NetBlock(torch.nn.Module):
    """The channels in ``scale`` chunks: the first passes through, the
    second goes through a ``TDNNBlock``, and chunk i >= 2 through one
    applied to ``x_i + y_{i-1}``; the outputs concatenated.  ``blocks[i -
    1]`` is chunk i's block (JAX ``block_{i}``).

    Example
    -------
    >>> Res2NetBlock(8, 8, scale=4, dilation=3)(torch.ones(2, 9, 8)).shape
    torch.Size([2, 9, 8])
    """

    def __init__(self, in_channels, out_channels, scale=8, kernel_size=3,
                 dilation=1):
        super().__init__()
        self.scale = scale
        self.blocks = torch.nn.ModuleList(
            TDNNBlock(in_channels // scale, out_channels // scale,
                      kernel_size, dilation)
            for _ in range(scale - 1))

    def forward(self, x):
        chunks = torch.chunk(x, self.scale, dim=-1)
        y = chunks[0]
        outputs = [y]
        for i, block in enumerate(self.blocks, start=1):
            y = block(chunks[i] if i == 1 else chunks[i] + y)
            outputs.append(y)
        return torch.cat(outputs, -1)


class SEBlock(torch.nn.Module):
    """Squeeze-excitation: the time mean over each row's frames (all of
    them without ``lengths``) -> ``Conv1d`` to ``se_channels`` -> ReLU ->
    ``Conv1d`` to ``out_channels`` -> sigmoid, gating the input's
    channels.

    Example
    -------
    >>> se = SEBlock(6, 3, 6)
    >>> se(torch.ones(2, 5, 6), torch.tensor([1.0, 0.4])).shape
    torch.Size([2, 5, 6])
    """

    def __init__(self, in_channels, se_channels, out_channels):
        super().__init__()
        self.conv1 = Conv1d(in_channels, se_channels, 1)
        self.conv2 = Conv1d(se_channels, out_channels, 1)

    def forward(self, x, lengths=None):
        if lengths is not None:
            mask = _length_mask(x, lengths)
            s = (x * mask).sum(1, keepdim=True) / mask.sum(
                1, keepdim=True).clamp(min=1.0)
        else:
            s = x.mean(1, keepdim=True)
        s = torch.sigmoid(self.conv2(F.relu(self.conv1(s))))
        return x * s


class AttentiveStatisticsPooling(torch.nn.Module):
    """Attention-weighted mean and std over time: (B, T, C) -> (B, 1,
    2C).  With ``global_context`` the attention also sees each row's
    masked mean and std (``sqrt(var + eps)``) broadcast over time; the
    attention logits of frames past a row's length are -1e20 before the
    softmax over time.

    Example
    -------
    >>> asp = AttentiveStatisticsPooling(6, attention_channels=4)
    >>> asp(torch.randn(2, 7, 6), torch.tensor([1.0, 0.5])).shape
    torch.Size([2, 1, 12])
    """

    def __init__(self, channels, attention_channels=128, global_context=True,
                 eps=1e-12):
        super().__init__()
        self.global_context = global_context
        self.eps = eps
        width = 3 * channels if global_context else channels
        self.tdnn = TDNNBlock(width, attention_channels, 1)
        self.conv = Conv1d(attention_channels, channels, 1)

    def forward(self, x, lengths=None):
        if lengths is None:
            lengths = torch.ones(x.shape[0], device=x.device)
        mask = _length_mask(x, lengths)
        if self.global_context:
            denom = mask.sum(1, keepdim=True).clamp(min=1.0)
            mean = (x * mask).sum(1, keepdim=True) / denom
            std = torch.sqrt(((x - mean) ** 2 * mask).sum(1, keepdim=True)
                             / denom + self.eps)
            attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], -1)
        else:
            attn_in = x
        attn = self.conv(torch.tanh(self.tdnn(attn_in)))
        attn = torch.where(mask > 0, attn, torch.full_like(attn, -1e20))
        attn = torch.softmax(attn, dim=1)
        mean = (attn * x).sum(1)
        std = torch.sqrt((attn * (x - mean[:, None, :]) ** 2).sum(1)
                         + self.eps)
        return torch.cat([mean, std], -1)[:, None, :]


class SERes2NetBlock(torch.nn.Module):
    """``TDNNBlock`` (1x1) -> ``Res2NetBlock`` -> ``TDNNBlock`` (1x1) ->
    ``SEBlock``, plus the input (through the 1x1 ``shortcut`` conv when
    the widths differ).  ``ECAPA_TDNN``'s three middle blocks are these.

    Example
    -------
    >>> blk = SERes2NetBlock(12, 16, res2net_scale=4, se_channels=8)
    >>> blk(torch.ones(2, 10, 12)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, in_channels, out_channels, res2net_scale=8,
                 se_channels=128, kernel_size=1, dilation=1):
        super().__init__()
        self.shortcut = (Conv1d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1)
        self.res2net = Res2NetBlock(out_channels, out_channels, res2net_scale,
                                    kernel_size, dilation)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1)
        self.se = SEBlock(out_channels, se_channels, out_channels)

    def forward(self, x, lengths=None):
        residual = x if self.shortcut is None else self.shortcut(x)
        y = self.tdnn2(self.res2net(self.tdnn1(x)))
        return self.se(y, lengths) + residual


class ECAPA_TDNN(torch.nn.Module):
    """The ECAPA-TDNN embedding extractor: (B, T, input_size) features ->
    (B, 1, lin_neurons).

    ``blocks[0]`` is a ``TDNNBlock`` (``channels[0]``, ``kernel_sizes[0]``,
    ``dilations[0]``), ``blocks[1:]`` the ``SERes2NetBlock``s of the
    middle channels; ``mfa`` a ``TDNNBlock`` over their outputs
    concatenated; ``asp`` the ``AttentiveStatisticsPooling``, ``asp_bn``
    a ``BatchNorm1d`` over its (B, 1, 2 channels[-1]) and ``fc`` a 1x1
    ``Conv1d`` to ``lin_neurons``.  Other arguments as in the JAX module.

    Example
    -------
    >>> model = ECAPA_TDNN(40, channels=(16, 16, 16, 16, 48), lin_neurons=8,
    ...                    attention_channels=8, res2net_scale=4,
    ...                    se_channels=8).eval()
    >>> model(torch.ones(2, 30, 40), torch.tensor([1.0, 0.6])).shape
    torch.Size([2, 1, 8])
    """

    def __init__(self, input_size, lin_neurons=192,
                 channels=(512, 512, 512, 512, 1536),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=128, res2net_scale=8, se_channels=128,
                 global_context=True):
        super().__init__()
        blocks = [TDNNBlock(input_size, channels[0], kernel_sizes[0],
                            dilations[0])]
        for i in range(1, len(channels) - 1):
            blocks.append(SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale, se_channels,
                kernel_sizes[i], dilations[i]))
        self.blocks = torch.nn.ModuleList(blocks)
        self.mfa = TDNNBlock(sum(channels[1:-1]), channels[-1],
                             kernel_sizes[-1], dilations[-1])
        self.asp = AttentiveStatisticsPooling(channels[-1], attention_channels,
                                              global_context)
        self.asp_bn = BatchNorm1d(2 * channels[-1])
        self.fc = Conv1d(2 * channels[-1], lin_neurons, 1)

    def forward(self, x, lengths=None):
        """x (B, T, input_size); lengths (B,) relative or None."""
        x = self.blocks[0](x)
        xl = []
        for block in self.blocks[1:]:
            x = block(x, lengths)
            xl.append(x)
        x = self.mfa(torch.cat(xl, -1))
        return self.fc(self.asp_bn(self.asp(x, lengths)))


class Classifier(torch.nn.Module):
    """The AAM-softmax head: ``lin_blocks`` of (``Linear`` ->
    ``BatchNorm1d``), then the cosine of each embedding with each class's
    column of ``weight`` (lin_neurons, out_neurons), as in JAX; both
    norms floored at 1e-8.  (B, 1, C) or (B, C) -> (B, 1, out_neurons).

    Example
    -------
    >>> head = Classifier(8, out_neurons=5, lin_neurons=8).eval()
    >>> cos = head(torch.randn(3, 1, 8))
    >>> cos.shape, bool((cos.abs() <= 1 + 1e-6).all())
    (torch.Size([3, 1, 5]), True)
    """

    # ``weight`` is (in, out): its fan-in is its first axis
    weight_in_out = True

    def __init__(self, input_size, out_neurons, lin_blocks=0, lin_neurons=192):
        super().__init__()
        blocks, width = [], input_size
        for _ in range(lin_blocks):
            blocks.append(torch.nn.ModuleDict({
                "linear": Linear(width, lin_neurons),
                "norm": BatchNorm1d(lin_neurons)}))
            width = lin_neurons
        self.blocks = torch.nn.ModuleList(blocks)
        self.weight = torch.nn.Parameter(
            torch.randn(lin_neurons, out_neurons) / lin_neurons ** 0.5)

    def forward(self, x):
        if x.dim() == 3:
            x = x[:, 0, :]
        for block in self.blocks:
            x = block["norm"](block["linear"](x))
        w = self.weight.to(x.dtype)
        x_norm = x / torch.linalg.vector_norm(
            x, dim=-1, keepdim=True).clamp(min=1e-8)
        w_norm = w / torch.linalg.vector_norm(
            w, dim=0, keepdim=True).clamp(min=1e-8)
        return (x_norm @ w_norm)[:, None, :]
