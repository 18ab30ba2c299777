"""The recurrent language model of the CRDNN seq2seq recipes' shallow
fusion.

Counterpart of ``speechbrain_tpu/lobes/models/RNNLM.py`` (``RNNLM``):
Embedding -> ``nnet/RNN.LSTM`` (cuDNN on the card) -> ``dnn_blocks`` x
(Linear -> LayerNorm -> leaky_relu(0.01) -> Dropout) -> Linear.  Two
differences: ``forward`` honours ``hx`` (JAX drops it, so a JAX caller
reruns the whole prefix every decode step), and ``step`` carries the
LSTM's (h, c) from one token to the next.  An LSTM is causal, so the
carried step gives the logits that the whole prefix gives at its last
position.
"""

import torch
import torch.nn.functional as F

from ...nnet.dropout import Dropout
from ...nnet.embedding import Embedding
from ...nnet.linear import Linear
from ...nnet.normalization import LayerNorm
from ...nnet.RNN import LSTM

__all__ = ["RNNLM"]


class RNNLM(torch.nn.Module):
    """Embedding -> LSTM -> DNN blocks -> logits.

    Arguments as in JAX: ``output_neurons`` (the vocabulary),
    ``embedding_dim``, ``dropout`` (between the LSTM's layers and after
    each DNN block, in training), ``rnn_layers``, ``rnn_neurons``,
    ``dnn_blocks``, ``dnn_neurons``, ``return_hidden``.  JAX's
    ``activation``, ``rnn_class`` and ``rnn_re_init`` change nothing
    there (leaky_relu and an LSTM always); here only those values are
    accepted.

    ``forward(x (B, L) ints, hx=None, dtype=None)`` -> logits (B, L, V),
    or with ``return_hidden`` ``(logits, (h, c))``, each (rnn_layers, B, H), the
    state after the last token; ``hx`` starts the LSTM from such a state.
    ``step(tokens (n,), state)`` -> ``(logits (n, V), state)`` feeds one
    token a row; its state is ``{"h", "c"}``, each (n, rnn_layers, H),
    row-major so that a beam search can reorder it by predecessor
    (``None``: zeros).

    Example
    -------
    >>> lm = RNNLM(output_neurons=12, embedding_dim=4, rnn_neurons=8,
    ...            dnn_neurons=6).eval()
    >>> x = torch.tensor([[0, 3, 5]])
    >>> logits = lm(x)
    >>> state = None
    >>> for t in range(3):
    ...     last, state = lm.step(x[:, t], state)
    >>> logits.shape, bool(torch.allclose(last, logits[:, -1], atol=1e-6))
    (torch.Size([1, 3, 12]), True)
    """

    def __init__(self, output_neurons, embedding_dim=128,
                 activation="leaky_relu", dropout=0.15, rnn_class="lstm",
                 rnn_layers=2, rnn_neurons=1024, rnn_re_init=False,
                 return_hidden=False, dnn_blocks=1, dnn_neurons=512):
        super().__init__()
        if activation != "leaky_relu" or rnn_class != "lstm":
            raise ValueError("RNNLM runs leaky_relu and an LSTM (as JAX's "
                             f"does), not {activation!r}, {rnn_class!r}")
        self.return_hidden = return_hidden
        self.emb = Embedding(output_neurons, embedding_dim)
        self.rnn = LSTM(embedding_dim, rnn_neurons, num_layers=rnn_layers,
                        dropout=dropout)
        self.dnn = torch.nn.ModuleList()
        width = rnn_neurons
        for _ in range(dnn_blocks):
            block = torch.nn.Module()
            block.linear = Linear(width, dnn_neurons)
            block.norm = LayerNorm(dnn_neurons)
            block.drop = Dropout(dropout)
            self.dnn.append(block)
            width = dnn_neurons
        self.out = Linear(width, output_neurons)

    def _head(self, y):
        for block in self.dnn:
            y = block.drop(F.leaky_relu(block.norm(block.linear(y)), 0.01))
        return self.out(y)

    def forward(self, x, hx=None, dtype=None):
        """See the class; ``dtype`` (None: the embedding's) is the
        activation dtype of the LSTM's input and of the head (the LSTM
        itself runs in its parameters' dtype)."""
        emb = self.emb(x)
        y, hidden = self.rnn(emb if dtype is None else emb.to(dtype), hx)
        logits = self._head(y)
        return (logits, hidden) if self.return_hidden else logits

    def step(self, tokens, state=None):
        """One token per row; see the class."""
        hx = None if state is None else (
            state["h"].transpose(0, 1), state["c"].transpose(0, 1))
        y, (h, c) = self.rnn(self.emb(tokens[:, None]), hx)
        return (self._head(y[:, 0]),
                {"h": h.transpose(0, 1), "c": c.transpose(0, 1)})
