"""CRDNN: CNN blocks, a light GRU and DNN blocks, channels-last.

Counterpart of ``speechbrain_tpu/lobes/models/CRDNN.py`` (``CNN_Block``,
``DNN_Block``, ``CRDNN``): the encoder of the LibriSpeech transducer
recipe's ``hparams/train.yaml`` and of the TIMIT CRDNN recipes.  The
modules are built from their input's widths, since a torch module's
parameters exist before its first call (Flax infers them then).
Pooling is a max over VALID windows of the frequency axis, inlined as
the JAX module inlines it (``nnet/pooling.py`` is not ported).  The
recurrence is any of the JAX module's ``rnn_class`` values ("ligru",
"lstm", "gru"), with the optional ``projection_dim`` Linear before it;
none of the JAX module's options that no recipe sets is ported: time
pooling, 2-d pooling, other kernel sizes, ``rnn_layers`` 0 and the CNN
blocks' BatchNorm.
"""

import torch
import torch.nn.functional as F

from ...nnet.CNN import Conv2d
from ...nnet.dropout import Dropout, Dropout2d
from ...nnet.linear import Linear
from ...nnet.normalization import BatchNorm1d, LayerNorm
from ...nnet.RNN import GRU, LSTM, LiGRU

__all__ = ["CNN_Block", "DNN_Block", "CRDNN"]


class CNN_Block(torch.nn.Module):
    """Two (Conv2d 3x3 "same" -> LayerNorm over (F, C) ->
    leaky_relu(0.01)), then a max pool over VALID windows of
    ``pooling_size`` frequency bins, then one ``Dropout2d``.

    Arguments
    ---------
    in_channels, n_freq : the input's channels (1 for a (B, T, F) input)
        and frequency bins, which size the LayerNorms' (F, C) parameters.
    channels, pooling_size, dropout : as in the JAX module.

    Example
    -------
    >>> block = CNN_Block(1, 40, channels=8).eval()
    >>> block(torch.ones(2, 10, 40)).shape
    torch.Size([2, 10, 20, 8])
    """

    def __init__(self, in_channels, n_freq, channels, pooling_size=2,
                 dropout=0.15):
        super().__init__()
        self.convs = torch.nn.ModuleList(
            Conv2d(in_channels if i == 0 else channels, channels)
            for i in range(2))
        self.norms = torch.nn.ModuleList(
            LayerNorm((n_freq, channels)) for _ in range(2))
        self.pooling_size = pooling_size
        self.drop = Dropout2d(dropout)

    def forward(self, x):
        """x: (B, T, F) or (B, T, F, C) -> (B, T, F // pool, channels)."""
        for conv, norm in zip(self.convs, self.norms):
            x = F.leaky_relu(norm(conv(x)), 0.01)
        p = self.pooling_size
        x = F.max_pool2d(x.permute(0, 3, 1, 2), (1, p), (1, p))
        return self.drop(x.permute(0, 2, 3, 1))


class DNN_Block(torch.nn.Module):
    """Linear (with bias) -> BatchNorm1d (momentum 0.1) -> leaky_relu(0.01)
    -> Dropout.

    Example
    -------
    >>> DNN_Block(16, 8).eval()(torch.ones(2, 5, 16)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, input_size, neurons, dropout=0.15):
        super().__init__()
        self.linear = Linear(input_size, neurons)
        self.norm = BatchNorm1d(neurons)
        self.drop = Dropout(dropout)

    def forward(self, x):
        """x: (..., input_size)."""
        return self.drop(F.leaky_relu(self.norm(self.linear(x)), 0.01))


_RNN_CLASSES = {"ligru": LiGRU, "lstm": LSTM, "gru": GRU}


class CRDNN(torch.nn.Module):
    """CNN blocks -> (B, T, F * C) -> [Linear(projection_dim)] -> the
    recurrence (bidirectional by default) -> DNN blocks, over (B, T,
    input_size) features.

    Arguments as in the JAX module, with ``input_size`` the feature bins
    (``n_mels``); the CNN block ``i`` pools the frequency axis by
    ``inter_layer_pooling_size[i]`` (80 -> 40 -> 20 at the recipe's
    widths), so the recurrence sees ``F * cnn_channels[-1]`` inputs
    (2560), or ``projection_dim`` of them when it is positive (JAX's
    ``Dense_0``, with a bias).  ``rnn_class``: "ligru" (``LiGRU``),
    "lstm" (``LSTM``) or "gru" (``GRU``), each with dropout ``dropout``
    (the LSTM's and GRU's between layers).  ``forward(x, lengths=None)``
    returns (B, T, dnn_neurons); ``lengths`` is accepted, as in JAX, and
    unused.

    Example
    -------
    >>> net = CRDNN(input_size=40, cnn_channels=(4, 4), rnn_neurons=8,
    ...             rnn_layers=1, dnn_neurons=8).eval()
    >>> net(torch.ones(2, 12, 40)).shape
    torch.Size([2, 12, 8])
    """

    def __init__(self, input_size, cnn_blocks=2, cnn_channels=(128, 256),
                 rnn_class="ligru", inter_layer_pooling_size=(2, 2),
                 rnn_layers=4, rnn_neurons=512, rnn_bidirectional=True,
                 dnn_blocks=2, dnn_neurons=512, dropout=0.15,
                 projection_dim=-1):
        super().__init__()
        if rnn_class not in _RNN_CLASSES:
            raise ValueError(f"CRDNN rnn_class {rnn_class!r}: one of "
                             f"{sorted(_RNN_CLASSES)}")
        blocks, n_freq, in_ch = [], input_size, 1
        for i in range(cnn_blocks):
            blocks.append(CNN_Block(in_ch, n_freq, cnn_channels[i],
                                    inter_layer_pooling_size[i], dropout))
            n_freq //= inter_layer_pooling_size[i]
            in_ch = cnn_channels[i]
        self.cnn = torch.nn.ModuleList(blocks)
        width = n_freq * in_ch
        self.proj = None
        if projection_dim > 0:
            self.proj = Linear(width, projection_dim)
            width = projection_dim
        self.rnn = _RNN_CLASSES[rnn_class](
            width, rnn_neurons, num_layers=rnn_layers,
            bidirectional=rnn_bidirectional, dropout=dropout)
        width = rnn_neurons * (2 if rnn_bidirectional else 1)
        dnn = []
        for _ in range(dnn_blocks):
            dnn.append(DNN_Block(width, dnn_neurons, dropout))
            width = dnn_neurons
        self.dnn = torch.nn.ModuleList(dnn)
        self.output_size = width

    def forward(self, x, lengths=None):
        """x: (B, T, input_size)."""
        for block in self.cnn:
            x = block(x)
        if x.dim() == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)  # (B, T, F * C)
        if self.proj is not None:
            x = self.proj(x)
        x, _ = self.rnn(x)
        for block in self.dnn:
            x = block(x)
        return x
