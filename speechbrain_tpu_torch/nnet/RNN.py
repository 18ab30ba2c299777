"""Recurrent layers: the GRU, the LSTM, the plain RNN and the light GRU.

Counterpart of ``speechbrain_tpu/nnet/RNN.py`` (``GRU``, ``LSTM``,
``RNN`` and the multi-layer / bidirectional plumbing of
``_RecurrentBase``).  The JAX layers are ``lax.scan``s (no kernel); each
of their layers here is a one-layer ``torch.nn.GRU``/``LSTM``/``RNN``
(cuDNN on the card), the same formulas with the gates in the same order:

    GRU (r, z, n):  r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
                    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
                    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
                    h = (1 - z) * n + z * h
    LSTM (i, f, g, o):  c = sigmoid(f) * c + sigmoid(i) * tanh(g)
                        h = sigmoid(o) * tanh(c)
                        (each gate W_i* x + b_i* + W_h* h)
    RNN:            h = tanh(W_ih x + b_ih + W_hh h)  (or relu)

``bridge.gru``/``lstm``/``rnn`` map the Flax ``l{i}_wx`` Dense (in, G H)
+ bias, ``l{i}_u`` (H, G H) and the GRU's ``l{i}_u_bias`` onto
``weight_ih``/``bias_ih``, ``weight_hh`` and ``bias_hh`` (``_bwd`` onto
the ``_reverse`` direction).  JAX's LSTM and RNN have no recurrent bias:
their ``bias_hh`` here is a zero buffer, not a parameter, so that no
optimizer moves it and no gradient clip counts it (a trained ``bias_hh``
would take the same gradient as ``bias_ih``: Adam would move their sum
twice as far as JAX moves its one bias).  Dropout between layers is the
port's ``Dropout``, whose mask comes from the trainer's generator
(``nn.GRU(dropout=...)`` would draw from the global RNG).

``LiGRU`` is the light GRU of the CRDNN encoder (JAX ``LiGRU``, also a
``lax.scan``): the input projection of every step is one GEMM followed
by a BatchNorm, and the recurrence is a PyTorch loop over time inside an
autograd ``Function`` whose backward is the loop run backwards (one
``addmm`` a step each way), so autograd records two nodes a layer, not
several per step.

The single-step cells (``GRUCell``, ``LSTMCell``, ``RNNCell``) and the
``AttentionalRNNDecoder`` built on them are JAX's formulas on plain
``Linear`` layers (``wx.{i}``, ``u.{i}``: the bridge is a transpose); the
decoder's teacher-forced ``forward`` is a Python loop over the tokens
(JAX's ``nn.scan``), each step the arithmetic of ``forward_step``.
QuasiRNN is not ported.
"""

import torch

from .attention import (
    ContentBasedAttention,
    KeyValueAttention,
    LocationAwareAttention,
)
from .dropout import Dropout
from .linear import Linear
from .normalization import BatchNorm1d

__all__ = ["GRU", "LSTM", "RNN", "LiGRU", "GRUCell", "LSTMCell", "RNNCell",
           "AttentionalRNNDecoder"]


def _zero_recurrent_bias(rnn):
    """Turn each ``bias_hh_l0[_reverse]`` parameter of a one-layer
    ``torch.nn`` recurrence into a zero buffer of the same name (cuDNN
    still reads it; the state_dict still holds it)."""
    for name in list(rnn._flat_weights_names):
        if name.startswith("bias_hh"):
            shape = getattr(rnn, name).shape
            delattr(rnn, name)
            rnn.register_buffer(name, torch.zeros(shape))
    rnn._init_flat_weights()


class _Recurrent(torch.nn.Module):
    """The layer stack of ``GRU``, ``LSTM`` and ``RNN``: one one-layer
    ``torch.nn`` recurrence (``_cell``) a layer, the port's ``Dropout``
    between layers.  ``forward(x, hx=None)`` returns ``(y, state)``: y
    (B, T, H * D), D = 2 if bidirectional else 1, and the last state in
    torch's stacked layout (num_layers * D, B, H), which ``hx`` also
    takes (the LSTM's is the pair ``(h, c)``), so a sequence can be
    resumed step by step.  ``cell_kwargs`` go to the ``torch.nn`` layers
    (the RNN's ``nonlinearity``).  The recurrence runs in the parameters'
    dtype (float32); y and the state come back in x's dtype (the JAX
    modules would run a bfloat16 input in bfloat16)."""

    _cell = None
    _recurrent_bias = True

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0, **cell_kwargs):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = 2 if bidirectional else 1
        self.rnns = torch.nn.ModuleList(
            self._cell(input_size if i == 0
                       else hidden_size * self.directions,
                       hidden_size, batch_first=True,
                       bidirectional=bidirectional, **cell_kwargs)
            for i in range(num_layers))
        if not self._recurrent_bias:
            for rnn in self.rnns:
                _zero_recurrent_bias(rnn)
        self.drop = Dropout(dropout)

    def forward(self, x, hx=None):
        """x: (B, T, C) or (B, T, C1, C2); hx: (num_layers * D, B, H), or
        a pair of them for the LSTM."""
        if x.dim() == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)
        dtype = x.dtype
        wdtype = self.rnns[0].weight_ih_l0.dtype
        y = x.to(wdtype)
        D = self.directions
        pair = isinstance(hx, tuple)
        states = []
        for i, rnn in enumerate(self.rnns):
            h0 = None
            if hx is not None:
                h0 = tuple(part[i * D:(i + 1) * D].to(wdtype).contiguous()
                           for part in (hx if pair else (hx,)))
                h0 = h0 if pair else h0[0]
            y, state = rnn(y, h0)
            states.append(state if isinstance(state, tuple) else (state,))
            if i != self.num_layers - 1:
                y = self.drop(y)
        state = tuple(torch.cat(parts, 0).to(dtype) for parts in zip(*states))
        return y.to(dtype), (state if len(state) == 2 else state[0])


class GRU(_Recurrent):
    """Multi-layer, optionally bidirectional GRU over (B, T, C) (a 4-d
    input is flattened to (B, T, C1 * C2)); the state is h (num_layers *
    D, B, H).  See ``_Recurrent``.

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

    _cell = torch.nn.GRU


class LSTM(_Recurrent):
    """Multi-layer, optionally bidirectional LSTM (JAX ``LSTM``) over (B,
    T, C); the state is the pair (h, c), each (num_layers * D, B, H).  No
    recurrent bias: each ``bias_hh`` is a zero buffer.  See
    ``_Recurrent``.

    Example
    -------
    >>> lstm = LSTM(4, 8, num_layers=2, bidirectional=True)
    >>> y, (h, c) = lstm(torch.ones(2, 5, 4))
    >>> y.shape, h.shape, c.shape
    (torch.Size([2, 5, 16]), torch.Size([4, 2, 8]), torch.Size([4, 2, 8]))
    >>> sorted(n for n, _ in lstm.named_buffers())[:2]
    ['rnns.0.bias_hh_l0', 'rnns.0.bias_hh_l0_reverse']
    """

    _cell = torch.nn.LSTM
    _recurrent_bias = False


class RNN(_Recurrent):
    """Multi-layer, optionally bidirectional plain RNN (JAX ``RNN``) with
    ``nonlinearity`` "tanh" (the default) or "relu"; the state is h
    (num_layers * D, B, H).  No recurrent bias: each ``bias_hh`` is a
    zero buffer.  See ``_Recurrent``.

    Example
    -------
    >>> rnn = RNN(4, 8, nonlinearity="relu")
    >>> y, h = rnn(torch.ones(2, 5, 4))
    >>> y.shape, h.shape
    (torch.Size([2, 5, 8]), torch.Size([1, 2, 8]))
    """

    _cell = torch.nn.RNN
    _recurrent_bias = False


class _LiGRURecurrence(torch.autograd.Function):
    """The LiGRU recurrence over time-major inputs.

    forward(wx (T, N, 2H), u (2H, H), h0 (N, H), mask (N, H)) ->
    h (T, N, H), with, per step,

        at, zt = chunk(wx_t + h_{t-1} u^T)
        h_t = sigmoid(zt) h_{t-1} + (1 - sigmoid(zt)) relu(at) mask

    The forward keeps the gates' pre-activations and the sigmoids; the
    backward walks the steps in reverse (the carried dh times z plus one
    ``addmm`` with u a step), then forms du in one GEMM over all steps.
    """

    @staticmethod
    def forward(ctx, wx, u, h0, mask):
        T, N, H2 = wx.shape
        H = H2 // 2
        gates = torch.empty_like(wx)
        z = wx.new_empty(T, N, H)
        cand = wx.new_empty(T, N, H)
        out = wx.new_empty(T, N, H)
        ut = u.t()
        h = h0
        for t in range(T):
            g = torch.addmm(wx[t], h, ut, out=gates[t])
            zt = torch.sigmoid(g[:, H:], out=z[t])
            c = torch.mul(torch.relu(g[:, :H]), mask, out=cand[t])
            # h = z h + (1 - z) c = c + z (h - c)
            h = torch.addcmul(c, zt, h - c, out=out[t])
        ctx.save_for_backward(u, h0, mask, gates, z, cand, out)
        return out

    @staticmethod
    @torch.profiler.record_function("ligru_backward")
    def backward(ctx, dout):
        u, h0, mask, gates, z, cand, out = ctx.saved_tensors
        T, N, H = out.shape
        dgates = torch.empty_like(gates)
        dh = torch.zeros_like(h0)
        for t in range(T - 1, -1, -1):
            h_prev = out[t - 1] if t > 0 else h0
            dh = dh + dout[t]
            zt = z[t]
            # dz_pre = dh (h_prev - c) z (1 - z); da = dh (1 - z) mask [a > 0]
            one_minus = 1.0 - zt
            torch.mul(dh * (h_prev - cand[t]), zt * one_minus,
                      out=dgates[t, :, H:])
            torch.mul(dh * one_minus, mask * (gates[t, :, :H] > 0),
                      out=dgates[t, :, :H])
            dh = torch.addmm(dh * zt, dgates[t], u)
        h_prevs = torch.cat([h0[None], out[:-1]], 0)
        du = dgates.reshape(T * N, 2 * H).t() @ h_prevs.reshape(T * N, H)
        return dgates, du, dh, None


class LiGRU(torch.nn.Module):
    """Light GRU (JAX ``LiGRU``, reference ``RNN.py:1125``), multi-layer,
    optionally bidirectional, over (B, T, C) (a 4-d input is flattened to
    (B, T, C1 * C2)).  Per layer::

        w = BN(x W)                       (all steps in one GEMM, no bias)
        at, zt = chunk(w_t + h u^T)
        h = sigmoid(zt) h + (1 - sigmoid(zt)) relu(at) drop_mask

    The BatchNorm runs over the (N * T, 2H) rows with Flax's momentum 0.95
    (``running = 0.95 running + 0.05 batch``: ``BatchNorm1d(momentum=
    0.05)``) and biased statistics in float32.  Bidirectional is the
    reference's flip-on-batch trick with shared weights: the layer's input
    is ``[x; flip_T(x)]``, 2B rows through one cell (padded frames are
    flipped too), and the second half's outputs are flipped back and
    concatenated on the features.  ``drop_mask`` is one (N, H) keep mask
    a sequence, scaled by 1 / (1 - dropout), shared over time and drawn
    from ``self.drop.generator`` in training; there is no dropout between
    layers.  ``h0`` is zero unless ``hx`` is given.  The recurrence runs
    in the input's dtype (bfloat16 under the recipes' bf16, as the JAX
    scan runs), unlike the port's ``GRU``.

    ``forward(x, hx=None)`` returns ``(y, h)``: y (B, T, H * D) and the
    last states h (num_layers * D, B, H) in torch's layout, which ``hx``
    also takes.  Parameters per layer ``i``: ``layers.{i}.wx.weight``
    (2H, in), ``layers.{i}.bn.*`` and ``layers.{i}.weight_hh`` (2H, H)
    (JAX ``l{i}_wx``, ``l{i}_bn``, ``l{i}_u`` (H, 2H) transposed).  The
    JAX module's other nonlinearities and normalizations are not ported:
    the CRDNN runs the defaults, relu and the BatchNorm.

    Example
    -------
    >>> net = LiGRU(4, 8, num_layers=2, bidirectional=True)
    >>> y, h = net(torch.ones(2, 5, 4))
    >>> y.shape, h.shape
    (torch.Size([2, 5, 16]), torch.Size([4, 2, 8]))
    """

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = 2 if bidirectional else 1
        H = hidden_size
        self.layers = torch.nn.ModuleList()
        for i in range(num_layers):
            layer = torch.nn.Module()
            layer.wx = Linear(input_size if i == 0 else H * self.directions,
                              2 * H, bias=False)
            layer.bn = BatchNorm1d(2 * H, momentum=0.05)
            layer.weight_hh = torch.nn.Parameter(torch.empty(2 * H, H))
            torch.nn.init.orthogonal_(layer.weight_hh)
            self.layers.append(layer)
        self.drop = Dropout(dropout)

    def _layer(self, layer, x, h0):
        B, T, _ = x.shape
        H = self.hidden_size
        if self.directions == 2:
            x = torch.cat([x, x.flip(1)], 0)
        N = x.shape[0]
        wx = layer.bn(layer.wx(x).reshape(N * T, 2 * H)).reshape(N, T, 2 * H)
        ones = torch.ones(N, H, dtype=x.dtype, device=x.device)
        mask = self.drop(ones)
        if h0 is None:
            h0 = torch.zeros(N, H, dtype=x.dtype, device=x.device)
        ys = _LiGRURecurrence.apply(
            wx.transpose(0, 1).contiguous(), layer.weight_hh.to(x.dtype),
            h0.to(x.dtype), mask).transpose(0, 1)
        if self.directions == 2:
            return (torch.cat([ys[:B], ys[B:].flip(1)], -1),
                    [ys[:B, -1], ys[B:, -1]])
        return ys, [ys[:, -1]]

    @torch.profiler.record_function("ligru")
    def forward(self, x, hx=None):
        """x: (B, T, C) or (B, T, C1, C2); hx: (num_layers * D, B, H).
        Runs in a ``record_function`` range "ligru" (the backward of its
        recurrences in "ligru_backward")."""
        if x.dim() == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)
        D = self.directions
        states = []
        for i, layer in enumerate(self.layers):
            h0 = None if hx is None else hx[i * D:(i + 1) * D].reshape(
                -1, self.hidden_size)
            x, last = self._layer(layer, x, h0)
            states.extend(last)
        return x, torch.stack(states)


class _Cell(torch.nn.Module):
    """A stack of ``num_layers`` single-step cells over (B, C) inputs:
    layer ``i`` has ``wx.{i}`` = Linear(in, G H) with a bias and ``u.{i}``
    = Linear(H, G H), with a bias for the GRU only (JAX's ``l{i}_wx`` and
    ``l{i}_u``); the port's ``Dropout`` acts between layers, in training
    (``train`` None: the module's mode)."""

    gates = 1
    u_bias = False

    def __init__(self, input_size, hidden_size, num_layers=1, dropout=0.0):
        super().__init__()
        G, H = self.gates, hidden_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.wx = torch.nn.ModuleList(
            Linear(input_size if i == 0 else H, G * H)
            for i in range(num_layers))
        self.u = torch.nn.ModuleList(
            Linear(H, G * H, bias=self.u_bias) for _ in range(num_layers))
        for u in self.u:
            u.recurrent = True  # asr._random_init draws it orthogonally
        self.drop = Dropout(dropout)

    def init_state(self, n, dtype=torch.float32, device=None):
        """Zero state for n rows: (num_layers, n, H)."""
        return torch.zeros(self.num_layers, n, self.hidden_size, dtype=dtype,
                           device=device)

    def _layer(self, i, x, h):
        raise NotImplementedError

    def _stack(self, x, states, train):
        new, inp = [], x
        train = self.training if train is None else train
        for i in range(self.num_layers):
            inp, state = self._layer(i, inp, tuple(s[i] for s in states))
            new.append(state)
            if i != self.num_layers - 1 and train:
                inp = self.drop(inp)
        return inp, [torch.stack(parts) for parts in zip(*new)]

    def forward(self, x, hx=None, train=None):
        """x (B, C), hx (num_layers, B, H) or None (zeros) -> ``(out (B,
        H), hx)``."""
        if hx is None:
            hx = self.init_state(x.shape[0], x.dtype, x.device)
        out, (h,) = self._stack(x, (hx,), train)
        return out, h


class GRUCell(_Cell):
    """Single-step GRU stack (JAX ``GRUCell``), gates r, z, n::

        r = sigmoid(W_r x + b_r + U_r h + c_r)
        z = sigmoid(W_z x + b_z + U_z h + c_z)
        n = tanh(W_n x + b_n + r * (U_n h + c_n))
        h = (1 - z) n + z h

    Example
    -------
    >>> cell = GRUCell(4, 8, num_layers=2)
    >>> out, h = cell(torch.ones(3, 4))
    >>> out.shape, h.shape
    (torch.Size([3, 8]), torch.Size([2, 3, 8]))
    """

    gates = 3
    u_bias = True

    def _layer(self, i, x, h):
        (h,) = h
        rx, zx, nx = self.wx[i](x).chunk(3, dim=-1)
        rh, zh, nh = self.u[i](h).chunk(3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        h = (1 - z) * n + z * h
        return h, (h,)


class LSTMCell(_Cell):
    """Single-step LSTM stack (JAX ``LSTMCell``), gates i, f, g, o, no
    recurrent bias; the state is the pair (h, c), each (num_layers, B,
    H)::

        c = sigmoid(f) c + sigmoid(i) tanh(g),  h = sigmoid(o) tanh(c)

    Example
    -------
    >>> cell = LSTMCell(4, 8)
    >>> out, (h, c) = cell(torch.ones(3, 4))
    >>> out.shape, h.shape, c.shape
    (torch.Size([3, 8]), torch.Size([1, 3, 8]), torch.Size([1, 3, 8]))
    """

    gates = 4

    def init_state(self, n, dtype=torch.float32, device=None):
        """Zero (h, c) for n rows."""
        zeros = super().init_state(n, dtype, device)
        return zeros, zeros

    def _layer(self, i, x, hc):
        h, c = hc
        gi, gf, gg, go = (self.wx[i](x) + self.u[i](h)).chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        return h, (h, c)

    def forward(self, x, hx=None, train=None):
        """x (B, C), hx the pair (h, c) or None -> ``(out, (h, c))``."""
        if hx is None:
            hx = self.init_state(x.shape[0], x.dtype, x.device)
        out, (h, c) = self._stack(x, hx, train)
        return out, (h, c)


class RNNCell(_Cell):
    """Single-step plain RNN stack (JAX ``RNNCell``): ``h = act(W x + b +
    U h)``, ``nonlinearity`` "tanh" or "relu", no recurrent bias.

    Example
    -------
    >>> out, h = RNNCell(4, 8, nonlinearity="relu")(torch.ones(3, 4))
    >>> bool((out >= 0).all()), h.shape
    (True, torch.Size([1, 3, 8]))
    """

    def __init__(self, input_size, hidden_size, num_layers=1,
                 nonlinearity="tanh", dropout=0.0):
        super().__init__(input_size, hidden_size, num_layers, dropout)
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"nonlinearity {nonlinearity!r}: tanh or relu")
        self.act = torch.tanh if nonlinearity == "tanh" else torch.relu

    def _layer(self, i, x, h):
        (h,) = h
        h = self.act(self.wx[i](x) + self.u[i](h))
        return h, (h,)


_CELLS = {"gru": GRUCell, "lstm": LSTMCell, "rnn": RNNCell}


class AttentionalRNNDecoder(torch.nn.Module):
    """Attention-equipped RNN decoder (JAX ``AttentionalRNNDecoder``, the
    CRDNN seq2seq recipes' ``dec``).  Each step::

        cell_out, hs = rnn([emb_t, context])
        context, w, attn_state = attn(enc_states, enc_lens, cell_out, ...)
        out_t = proj([cell_out, context])

    Arguments
    ---------
    rnn_type : "gru", "lstm" or "rnn" (the cells above).
    attn_type : "content", "location" or "keyvalue" (``nnet/attention``).
    hidden_size, attn_dim, num_layers, scaling, channels, kernel_size,
    dropout : as in JAX (``channels``/``kernel_size`` for "location": 10
        channels of 2 kernel_size + 1 taps).  ``dropout`` acts between the
        cell's layers in training only; JAX applies none to the cell's
        input, so with one layer it never acts (kept).
    enc_dim, input_size : widths of the encoder states and the token
        embeddings (JAX infers them at the first call).

    ``forward(inp (B, U, E), enc_states (B, T, enc_dim), enc_lens (B,))``
    is teacher-forced: ``(outputs (B, U, H), attn (B, U, T) float32)``,
    a Python loop over U of ``forward_step``'s arithmetic from zero
    states.  ``forward_step(inp (n, E), hs, c (n, H), enc_states,
    enc_lens, attn_state)`` -> ``(out, hs, c, w, attn_state)`` is one
    decode step; n may be g * B rows (see ``ContentBasedAttention``).
    ``attn_init(enc_states)`` gives the attention's first state and
    ``rnn.init_state(n, ...)`` the cell's.

    Example
    -------
    >>> dec = AttentionalRNNDecoder("gru", "location", hidden_size=8,
    ...     attn_dim=6, enc_dim=5, input_size=4, kernel_size=2)
    >>> out, attn = dec(torch.randn(2, 3, 4), torch.randn(2, 7, 5),
    ...                 torch.tensor([1.0, 0.6]))
    >>> out.shape, attn.shape
    (torch.Size([2, 3, 8]), torch.Size([2, 3, 7]))
    """

    def __init__(self, rnn_type, attn_type, hidden_size, attn_dim,
                 enc_dim, input_size, num_layers=1, scaling=1.0,
                 channels=10, kernel_size=100, dropout=0.0):
        super().__init__()
        if rnn_type not in _CELLS:
            raise ValueError(f"rnn_type {rnn_type!r}: one of {sorted(_CELLS)}")
        H = hidden_size
        self.rnn_type, self.attn_type = rnn_type, attn_type
        self.hidden_size = H
        self.rnn = _CELLS[rnn_type](input_size + H, H, num_layers,
                                    dropout=dropout)
        if attn_type == "content":
            self.attn = ContentBasedAttention(enc_dim, H, attn_dim, H, scaling)
        elif attn_type == "location":
            self.attn = LocationAwareAttention(enc_dim, H, attn_dim, H,
                                               channels, kernel_size, scaling)
        elif attn_type == "keyvalue":
            self.attn = KeyValueAttention(enc_dim, H, attn_dim, H)
        else:
            raise ValueError(f"Unknown attn_type {attn_type}")
        self.proj = Linear(2 * H, H)

    def attn_init(self, enc_states):
        """The attention's first state (the encoder projection, and for
        location attention zero previous weights)."""
        return self.attn.init_state(enc_states)

    def _step(self, inp, hs, c, enc_states, enc_lens, attn_state, train):
        cell_out, hs = self.rnn(torch.cat([inp, c], dim=-1), hs, train=train)
        c, w, attn_state = self.attn(enc_states, enc_lens, cell_out,
                                     attn_state)
        out = self.proj(torch.cat([cell_out, c], dim=-1))
        return out, hs, c, w, attn_state

    def forward_step(self, inp, hs, c, enc_states, enc_lens, attn_state=None):
        """One decode step (no dropout, as JAX's ``train=False``)."""
        return self._step(inp, hs, c, enc_states, enc_lens, attn_state,
                          train=False)

    def forward(self, inp_tensor, enc_states, enc_lens):
        """Teacher-forced decode; see the class."""
        B, U = inp_tensor.shape[:2]
        dtype = inp_tensor.dtype
        c = inp_tensor.new_zeros(B, self.hidden_size)
        hs = self.rnn.init_state(B, dtype, inp_tensor.device)
        attn_state = self.attn.init_state(enc_states)
        outs, ws = [], []
        for u in range(U):
            out, hs, c, w, attn_state = self._step(
                inp_tensor[:, u], hs, c, enc_states, enc_lens, attn_state,
                train=None)
            outs.append(out)
            ws.append(w)
        return torch.stack(outs, 1), torch.stack(ws, 1)
