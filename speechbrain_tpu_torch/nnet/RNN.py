"""Recurrent layers: the gated recurrent unit.

Counterpart of ``speechbrain_tpu/nnet/RNN.py`` (``GRU`` and the
multi-layer / bidirectional plumbing of ``_RecurrentBase``).  The JAX
GRU is a ``lax.scan`` (no kernel); each of its layers here is a
one-layer ``torch.nn.GRU``, the same formula:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h = (1 - z) * n + z * h

with the gates in the order r, z, n in both (``bridge.gru`` maps the
Flax ``l{i}_wx`` Dense (in, 3H) + bias, ``l{i}_u`` (H, 3H) and
``l{i}_u_bias`` onto ``weight_ih``/``bias_ih``, ``weight_hh`` and
``bias_hh``).  Dropout between layers is the port's ``Dropout``, whose
mask comes from the trainer's generator (``nn.GRU(dropout=...)`` would
draw from the global RNG).  LSTM, LiGRU and QuasiRNN are not ported.
"""

import torch

from .dropout import Dropout

__all__ = ["GRU"]


class GRU(torch.nn.Module):
    """Multi-layer, optionally bidirectional GRU over (B, T, C) (a 4-d
    input is flattened to (B, T, C1 * C2)).

    ``forward(x, hx=None)`` returns ``(y, h)``: y (B, T, H * D), D = 2 if
    bidirectional else 1, and the last states h (num_layers * D, B, H) in
    torch's layout, which ``hx`` also takes, so a sequence can be resumed
    step by step (transducer prediction networks).  The recurrence runs
    in the parameters' dtype (float32); y and h come back in x's dtype
    (the JAX module would run a bfloat16 input in bfloat16; the transducer
    recipe feeds it float32 embeddings).

    Example
    -------
    >>> gru = GRU(4, 8, num_layers=2, bidirectional=True)
    >>> y, h = gru(torch.ones(2, 5, 4))
    >>> y.shape, h.shape
    (torch.Size([2, 5, 16]), torch.Size([4, 2, 8]))
    >>> y2, _ = gru(torch.ones(2, 1, 4), hx=h)
    >>> y2.shape
    torch.Size([2, 1, 16])
    """

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = 2 if bidirectional else 1
        self.rnns = torch.nn.ModuleList(
            torch.nn.GRU(input_size if i == 0 else hidden_size * self.directions,
                         hidden_size, batch_first=True,
                         bidirectional=bidirectional)
            for i in range(num_layers))
        self.drop = Dropout(dropout)

    def forward(self, x, hx=None):
        """x: (B, T, C) or (B, T, C1, C2); hx: (num_layers * D, B, H)."""
        if x.dim() == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)
        dtype = x.dtype
        wdtype = self.rnns[0].weight_ih_l0.dtype
        y = x.to(wdtype)
        D = self.directions
        states = []
        for i, rnn in enumerate(self.rnns):
            h0 = None if hx is None else (
                hx[i * D:(i + 1) * D].to(wdtype).contiguous())
            y, h = rnn(y, h0)
            states.append(h)
            if i != self.num_layers - 1:
                y = self.drop(y)
        return y.to(dtype), torch.cat(states, 0).to(dtype)
