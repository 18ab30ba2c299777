"""Attention for the conformer encoder, the transformer decoder and the
attentional RNN decoder.

Counterpart of ``speechbrain_tpu/nnet/attention.py``: ``RelPosEncXL``,
``_rel_shift``, ``RelPosMHAXL``, ``MultiheadAttention`` (modes "full",
"project_kv" and "step"), ``PositionalwiseFeedForward`` and the RNN
decoder's ``ContentBasedAttention``, ``LocationAwareAttention`` and
``KeyValueAttention`` (with ``_length_mask``).  Masks replace scores
with -65000 (``NEG_FILL``); softmax runs in float32.

Each module that can reach a kernel has ``use_kernels`` (default True).
With it, ``RelPosMHAXL`` routes long utterances to the rel-pos kernel
under the JAX gate (T_q == T_k, T % 128 == 0, 512 <= T <= 1024, no
attn_mask, no attention dropout in training) with "the tensor is on
CUDA" in place of "the backend is a TPU", and the decoder's
self-attention step goes through ``beam_attend_step``.  With it off,
the same math runs through the plain PyTorch versions (used to check
the kernels on the card).

Training mode (``module.train()``) applies dropout where the JAX modules
do: to the attention weights (``RelPosMHAXL``, ``MultiheadAttention``)
and after the FFN's activation (``PositionalwiseFeedForward``).
"""

import math

import torch
import torch.nn.functional as F

from ..ops.beam_cache import (
    append_attend,
    beam_attend_step,
    beam_attend_step_plain,
)
from ..ops.relpos_attention import HEAD_DIMS, relpos_attention
from .dropout import Dropout
from .linear import Linear

__all__ = [
    "ContentBasedAttention",
    "LocationAwareAttention",
    "KeyValueAttention",
    "RelPosEncXL",
    "RelPosMHAXL",
    "MultiheadAttention",
    "PositionalwiseFeedForward",
]

NEG_FILL = -65000.0


def _softmax(s, dtype):
    """Softmax over the last axis in float32 (float64 for float64
    scores, as ``jax.nn.softmax`` keeps its input's dtype), cast to
    ``dtype``."""
    if s.dtype != torch.float64:
        s = s.float()
    return torch.softmax(s, dim=-1).to(dtype)


def _length_mask(enc_lens, T):
    """(B,) lengths -> (B, T) bool mask of the valid frames: frame t is
    valid where ``t < lens * T`` for relative (floating) lengths, with no
    rounding, as in JAX, or ``t < lens`` for integer ones."""
    abs_lens = enc_lens * T if enc_lens.is_floating_point() else enc_lens
    return torch.arange(T, device=enc_lens.device)[None, :] < abs_lens[:, None]


def _attend(scores, enc_lens, values, scaling=1.0):
    """Masked softmax of ``scores`` (B, g, T) over the frames (``enc_lens``
    of B rows, or of B * g: one a decoder row), in float32 (float64 for
    float64 scores), then the weighted sum of ``values`` (B, T, C).
    Returns (context (B, g, C) in ``values``' dtype, weights (B, g, T))."""
    B, _, T = scores.shape
    mask = _length_mask(enc_lens, T).view(B, -1, T)
    if scores.dtype != torch.float64:
        scores = scores.float()
    scores = torch.where(mask, scores, NEG_FILL)
    w = torch.softmax(scores * scaling, dim=-1)
    return torch.einsum("bgt,btc->bgc", w.to(values.dtype), values), w


class ContentBasedAttention(torch.nn.Module):
    """Additive (Bahdanau) attention of the RNN decoder over the encoder
    states, with their projection computed once (``init_state``)::

        scores = mlp_attn(tanh(mlp_enc(enc) + mlp_dec(dec)))
        w = softmax(scaling * where(valid frame, scores, -65000))
        context = mlp_out(sum_t w_t enc_t)

    Arguments
    ---------
    enc_dim, dec_dim : widths of the encoder states and decoder states
        (JAX infers them at the first call).
    attn_dim, output_dim, scaling : as in JAX.

    ``forward(enc_states (B, T, enc_dim), enc_lens (B,) or (n,),
    dec_states (n, dec_dim), state)`` -> ``(context (n, output_dim),
    weights (n, T) float32 (float64 for float64 inputs), state)``: n may
    be a multiple g of B (a beam search's rows, the g rows of an item
    consecutive), and the encoder side is then broadcast over each item's
    rows, not copied (JAX tiles it).

    Example
    -------
    >>> att = ContentBasedAttention(6, 4, attn_dim=5, output_dim=3)
    >>> enc = torch.randn(2, 7, 6)
    >>> c, w, _ = att(enc, torch.tensor([1.0, 0.5]), torch.randn(4, 4))
    >>> c.shape, w.shape, round(float(w[3, 4:].sum()), 6)
    (torch.Size([4, 3]), torch.Size([4, 7]), 0.0)
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim, scaling=1.0):
        super().__init__()
        self.mlp_enc = Linear(enc_dim, attn_dim)
        self.mlp_dec = Linear(dec_dim, attn_dim)
        self.mlp_attn = Linear(attn_dim, 1, bias=False)
        self.mlp_out = Linear(enc_dim, output_dim)
        self.scaling = scaling

    def init_state(self, enc_states):
        """The state of a fresh decode: the encoder projection."""
        return {"enc_proj": self.mlp_enc(enc_states)}

    def _score(self, enc_proj, dec_states, extra=None):
        B, T, A = enc_proj.shape
        act = enc_proj[:, None] + self.mlp_dec(dec_states).view(B, -1, 1, A)
        if extra is not None:
            act = act + extra.view(B, -1, T, A)
        return self.mlp_attn(torch.tanh(act))[..., 0]  # (B, g, T)

    def forward(self, enc_states, enc_lens, dec_states, state=None):
        """One attention step; see the class."""
        if state is None:
            state = self.init_state(enc_states)
        scores = self._score(state["enc_proj"], dec_states)
        context, w = _attend(scores, enc_lens, enc_states, self.scaling)
        n = dec_states.shape[0]
        return self.mlp_out(context).reshape(n, -1), w.reshape(n, -1), state


class LocationAwareAttention(ContentBasedAttention):
    """Content attention plus convolutional features of the previous
    step's weights (JAX ``LocationAwareAttention``)::

        loc = mlp_loc(conv_loc(prev_attn))      (2 kernel_size + 1 taps,
                                                 "SAME", no bias)
        scores = mlp_attn(tanh(mlp_enc(enc) + mlp_dec(dec) + loc))

    then as ``ContentBasedAttention``.  The state holds the encoder
    projection and ``prev_attn`` (n, T), zeros at the start; the step's
    weights become the next ``prev_attn``.  ``conv_loc.weight`` is
    (conv_channels, 1, 2 kernel_size + 1), Flax's (K, 1, C) transposed.

    Example
    -------
    >>> att = LocationAwareAttention(6, 4, attn_dim=5, output_dim=3,
    ...                              conv_channels=2, kernel_size=3)
    >>> enc = torch.randn(2, 7, 6)
    >>> st = att.init_state(enc)
    >>> c, w, st = att(enc, torch.ones(2), torch.randn(2, 4), st)
    >>> torch.equal(st["prev_attn"], w)
    True
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim,
                 conv_channels=10, kernel_size=100, scaling=1.0):
        super().__init__(enc_dim, dec_dim, attn_dim, output_dim, scaling)
        self.mlp_loc = Linear(conv_channels, attn_dim)
        self.conv_loc = torch.nn.Conv1d(1, conv_channels, 2 * kernel_size + 1,
                                        padding=kernel_size, bias=False)
        self.kernel_size = kernel_size

    def init_state(self, enc_states):
        """The encoder projection and zero previous weights."""
        B, T = enc_states.shape[:2]
        return {"enc_proj": self.mlp_enc(enc_states),
                "prev_attn": enc_states.new_zeros(B, T)}

    def forward(self, enc_states, enc_lens, dec_states, state=None):
        """One attention step; see the class."""
        if state is None:
            state = self.init_state(enc_states)
        prev = state["prev_attn"]
        if prev.shape[0] != dec_states.shape[0]:
            prev = prev.repeat_interleave(dec_states.shape[0] // prev.shape[0],
                                          dim=0)
        conv = F.conv1d(prev[:, None, :].to(self.conv_loc.weight.dtype),
                        self.conv_loc.weight, padding=self.kernel_size)
        loc = self.mlp_loc(conv.transpose(1, 2).to(dec_states.dtype))
        scores = self._score(state["enc_proj"], dec_states, loc)
        context, w = _attend(scores, enc_lens, enc_states, self.scaling)
        n = dec_states.shape[0]
        w = w.reshape(n, -1)
        return (self.mlp_out(context).reshape(n, -1), w,
                {"enc_proj": state["enc_proj"], "prev_attn": w})


class KeyValueAttention(torch.nn.Module):
    """Scaled dot-product attention with one head (JAX
    ``KeyValueAttention``): keys and values from the encoder states
    (``init_state``), the query from the decoder state; scores divided
    by sqrt(attn_dim), masked, float32 softmax; no output projection.

    ``forward`` as ``ContentBasedAttention``'s: ``(context (n,
    output_dim), weights (n, T) float32, state)``.

    Example
    -------
    >>> att = KeyValueAttention(6, 4, attn_dim=5, output_dim=3)
    >>> c, w, _ = att(torch.randn(2, 7, 6), torch.ones(2), torch.randn(2, 4))
    >>> c.shape, w.shape
    (torch.Size([2, 3]), torch.Size([2, 7]))
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim):
        super().__init__()
        self.key_linear = Linear(enc_dim, attn_dim)
        self.query_linear = Linear(dec_dim, attn_dim)
        self.value_linear = Linear(enc_dim, output_dim)
        self.attn_dim = attn_dim

    def init_state(self, enc_states):
        """The keys and values of a fresh decode."""
        return {"keys": self.key_linear(enc_states),
                "values": self.value_linear(enc_states)}

    def forward(self, enc_states, enc_lens, dec_states, state=None):
        """One attention step; see the class."""
        if state is None:
            state = self.init_state(enc_states)
        keys = state["keys"]
        B, T, A = keys.shape
        q = self.query_linear(dec_states).view(B, -1, A)
        scores = torch.einsum("bga,bta->bgt", q, keys) / math.sqrt(A)
        context, w = _attend(scores, enc_lens, state["values"])
        n = dec_states.shape[0]
        return context.reshape(n, -1), w.reshape(n, -1), state


class RelPosEncXL(torch.nn.Module):
    """Relative sinusoidal encodings: (B, T, C) -> (1, 2T-1, C).

    Index 0 is relative position T-1, index 2T-2 is -(T-1).  The
    encoding is symmetric in the distance, sin(|r|) and cos(|r|) (the
    reference's quirk, kept).

    Example
    -------
    >>> RelPosEncXL(16)(torch.ones(2, 5, 16)).shape
    torch.Size([1, 9, 16])
    """

    def __init__(self, emb_dim):
        super().__init__()
        self.emb_dim = emb_dim

    def forward(self, x):
        """x: (B, T, C); returns the encodings in x's dtype."""
        T = x.shape[1]
        pos = torch.arange(T - 1, -T, -1, dtype=torch.float32,
                           device=x.device).abs()[:, None]
        div = torch.exp(
            torch.arange(0, self.emb_dim, 2, dtype=torch.float32,
                         device=x.device)
            * -(math.log(10000.0) / self.emb_dim)
        )[None, :]
        pe = torch.zeros(2 * T - 1, self.emb_dim, device=x.device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return pe[None].to(x.dtype)


def _rel_shift(x):
    """(B, H, T, 2T-1) -> (B, H, T, T): out[i, j] = x[i, T-1-i+j].

    Example
    -------
    >>> x = torch.arange(5.).expand(1, 1, 3, 5)
    >>> _rel_shift(x)[0, 0].tolist()
    [[2.0, 3.0, 4.0], [1.0, 2.0, 3.0], [0.0, 1.0, 2.0]]
    """
    B, H, T, L = x.shape
    if T == 1:
        return x[..., :1]
    flat = x.reshape(B, H, T * L)
    flat = flat[:, :, T - 1 : T - 1 + T * (L - 1)]
    return flat.reshape(B, H, T, L - 1)[..., :T]


class RelPosMHAXL(torch.nn.Module):
    """Transformer-XL multi-head attention with relative positions.

    score(i, j) = ((q_i + u) . k_j + (q_i + v) . p_{i-j}) / sqrt(embed_dim)

    Bias-free q/k/v/pos projections (``q_proj``/``k_proj``/``v_proj``,
    concatenated into one (3d, d) matmul for self-attention), biased
    ``out_proj``, and ``pos_bias_u``/``pos_bias_v`` of shape (H, d_head).
    ``dropout`` applies to the attention weights in training.

    Example
    -------
    >>> mha = RelPosMHAXL(16, 4)
    >>> x = torch.ones(2, 6, 16)
    >>> out, attn = mha(x, x, x, RelPosEncXL(16)(x))
    >>> out.shape
    torch.Size([2, 6, 16])
    """

    def __init__(self, embed_dim, num_heads, mask_pos_future=False,
                 dropout=0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.mask_pos_future = mask_pos_future
        self.dropout = dropout
        self.attn_drop = Dropout(dropout)
        self.use_kernels = True
        self.q_proj = Linear(embed_dim, embed_dim, bias=False)
        self.k_proj = Linear(embed_dim, embed_dim, bias=False)
        self.v_proj = Linear(embed_dim, embed_dim, bias=False)
        self.pos_proj = Linear(embed_dim, embed_dim, bias=False)
        self.out_proj = Linear(embed_dim, embed_dim)
        d_head = embed_dim // num_heads
        self.pos_bias_u = torch.nn.Parameter(torch.zeros(num_heads, d_head))
        self.pos_bias_v = torch.nn.Parameter(torch.zeros(num_heads, d_head))

    def _kernel_ok(self, query, T_q, T_k, attn_mask):
        # The JAX gate (speechbrain_tpu/nnet/attention.py): training with
        # attention dropout takes the materialized path there, so it does
        # here too, though the kernels take a dropout rate (ops.
        # relpos_attention's rate and seed, reached by direct calls only).
        # The kernels are built for the head widths in HEAD_DIMS only; JAX's
        # take any, so other widths take the materialized path here.
        return (
            self.use_kernels
            and query.device.type == "cuda"
            and self.embed_dim // self.num_heads in HEAD_DIMS
            and T_q == T_k
            and T_q % 128 == 0
            and 512 <= T_q <= 1024
            and attn_mask is None
            and (self.dropout == 0.0 or not self.training)
        )

    def forward(self, query, key, value, pos_embs, key_padding_mask=None,
                attn_mask=None):
        """query/key/value (B, T, d); pos_embs (1, 2T-1, d);
        key_padding_mask (B, T_k) True = pad; attn_mask (T_q, T_k) True =
        disallowed.  Returns (out, attention weights or None)."""
        H = self.num_heads
        d_head = self.embed_dim // H
        B, T_q = query.shape[0], query.shape[1]
        T_k = key.shape[1]
        dt = query.dtype
        if query is key and key is value:
            w = torch.cat(
                [self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]
            ).to(dt)
            q, k, v = F.linear(query, w).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        p = self.pos_proj(pos_embs)
        u = self.pos_bias_u.to(dt)
        vb = self.pos_bias_v.to(dt)
        q = q.reshape(B, T_q, H, d_head)
        k = k.reshape(B, T_k, H, d_head)
        v = v.reshape(B, T_k, H, d_head)
        p = p.reshape(p.shape[0], p.shape[1], H, d_head)
        if self._kernel_ok(query, T_q, T_k, attn_mask):
            if key_padding_mask is not None:
                madd = torch.zeros(key_padding_mask.shape, device=query.device)
                madd = madd.masked_fill(key_padding_mask, NEG_FILL)
            else:
                madd = torch.zeros(B, T_k, device=query.device)
            out = relpos_attention(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(),
                p[0].transpose(0, 1).contiguous(),
                u.float(), vb.float(), madd,
                1.0 / math.sqrt(self.embed_dim), self.mask_pos_future,
            )
            out = out.transpose(1, 2).reshape(B, T_q, self.embed_dim).to(dt)
            return self.out_proj(out), None
        # materialized path: (B, H, T, 2T-1) position scores + rel shift
        pos_score = torch.einsum("bqhd,zlhd->bhql", q + vb[None, None], p)
        pos_score = _rel_shift(pos_score)
        content = torch.einsum("bqhd,bkhd->bhqk", q + u[None, None], k)
        scores = (content + pos_score) / math.sqrt(self.embed_dim)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[None, None], NEG_FILL)
        if key_padding_mask is not None:
            scores = scores.masked_fill(
                key_padding_mask[:, None, None, :], NEG_FILL
            )
        if self.mask_pos_future:
            ar_q = torch.arange(T_q, device=query.device)
            ar_k = torch.arange(T_k, device=query.device)
            scores = scores.masked_fill(
                (ar_k[None, :] > ar_q[:, None])[None, None], NEG_FILL
            )
        attn = self.attn_drop(_softmax(scores, dt))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = self.out_proj(out.reshape(B, T_q, self.embed_dim))
        return out, attn


class MultiheadAttention(torch.nn.Module):
    """Standard multi-head attention with biased q/k/v/out projections;
    scores scaled by 1/sqrt(d_head).

    ``dropout`` applies to the attention weights of ``"full"`` mode in
    training.  Modes: ``"full"`` (batched), ``"project_kv"`` (returns the projected
    (k, v) as (B, T, H, d_head), for cross-attention caches) and
    ``"step"`` (one token):

    - self-attention step (``key is query``): ``kv_cache`` is the merged
      time-minor cache (B, d_model, 2L); the fused (d, 3d) qkv
      projection feeds ``beam_attend_step`` (with ``rows``, the beam
      predecessor map) or ``append_attend`` (without).  Returns
      ``(out, None, new_cache)``.  ``kv_dst`` is an optional buffer the
      new cache is written into.
    - cross-attention step (``key`` None): ``kv_cache=(k, v)`` of shape
      (B_kv, L, H, d_head); grouped when B == B_kv * group.  Returns
      ``(out, mean attention, (k, v))``.

    Example
    -------
    >>> mha = MultiheadAttention(nhead=2, d_model=16)
    >>> x = torch.ones(2, 5, 16)
    >>> out, w = mha(x, x, x)
    >>> out.shape, w.shape
    (torch.Size([2, 5, 16]), torch.Size([2, 5, 5]))
    """

    def __init__(self, nhead, d_model, dropout=0.0):
        super().__init__()
        self.nhead = nhead
        self.d_model = d_model
        self.dropout = dropout
        self.attn_drop = Dropout(dropout)
        self.use_kernels = True
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, query, key, value, key_padding_mask=None,
                attn_mask=None, mode="full", kv_cache=None, cache_index=None,
                rows=None, kv_dst=None):
        """See the class docstring for the modes and their returns."""
        H = self.nhead
        d_head = self.d_model // H
        if mode == "project_kv":
            B, T_k = key.shape[0], key.shape[1]
            return (
                self.k_proj(key).reshape(B, T_k, H, d_head),
                self.v_proj(value).reshape(B, T_k, H, d_head),
            )
        if mode == "step":
            return self._step(query, key, value, key_padding_mask, kv_cache,
                              cache_index, rows, kv_dst)
        B, T_q = query.shape[0], query.shape[1]
        T_k = key.shape[1]
        q = self.q_proj(query).reshape(B, T_q, H, d_head)
        k = self.k_proj(key).reshape(B, T_k, H, d_head)
        v = self.v_proj(value).reshape(B, T_k, H, d_head)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d_head)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[None, None], NEG_FILL)
        if key_padding_mask is not None:
            scores = scores.masked_fill(
                key_padding_mask[:, None, None, :], NEG_FILL
            )
        attn = self.attn_drop(_softmax(scores, query.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(
            B, T_q, self.d_model
        )
        return self.out_proj(out), attn.mean(dim=1)

    def _step(self, query, key, value, key_padding_mask, kv_cache,
              cache_index, rows, kv_dst):
        H = self.nhead
        d_head = self.d_model // H
        B = query.shape[0]
        dt = query.dtype
        if key is not None:
            if key is not query or (value is not None and value is not query):
                raise NotImplementedError(
                    "step-mode self-attention requires key is query "
                    "(and value is query)"
                )
            w = torch.cat(
                [self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]
            ).to(dt)
            b = torch.cat(
                [self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]
            ).to(dt)
            qkv = F.linear(query.reshape(B, -1), w, b)
            q_t, k_t, v_t = qkv.chunk(3, dim=-1)
            q_t = q_t * (1.0 / math.sqrt(d_head))
            if rows is not None:
                step = (beam_attend_step if self.use_kernels
                        else beam_attend_step_plain)
                out_t, kv_all = step(kv_cache, rows, q_t, k_t, v_t,
                                     cache_index, H, dst=kv_dst)
            else:
                out_t, kv_all = append_attend(
                    kv_cache, cache_index, q_t.to(kv_cache.dtype),
                    k_t.to(kv_cache.dtype), v_t.to(kv_cache.dtype), H,
                )
            out = self.out_proj(out_t.to(dt).reshape(B, 1, self.d_model))
            return out, None, kv_all
        k_all, v_all = kv_cache
        L = k_all.shape[1]
        q = self.q_proj(query).reshape(B, 1, H, d_head)
        B_kv = k_all.shape[0]
        if B_kv != B:  # grouped: `group` consecutive rows share a KV row
            group = B // B_kv
            qg = q.reshape(B_kv, group, H, d_head)
            scores = torch.einsum("bghd,bkhd->bhgk", qg, k_all) / math.sqrt(
                d_head
            )
            if key_padding_mask is not None:
                mg = key_padding_mask.reshape(B_kv, group, L)
                scores = scores.masked_fill(mg[:, None], NEG_FILL)
            attn = _softmax(scores, dt)
            out = torch.einsum("bhgk,bkhd->bghd", attn, v_all).reshape(
                B, 1, self.d_model
            )
            return (self.out_proj(out), attn.mean(dim=1).reshape(B, 1, L),
                    (k_all, v_all))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all) / math.sqrt(d_head)
        if key_padding_mask is not None:
            scores = scores.masked_fill(
                key_padding_mask[:, None, None, :], NEG_FILL
            )
        attn = _softmax(scores, dt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v_all).reshape(
            B, 1, self.d_model
        )
        return self.out_proj(out), attn.mean(dim=1), (k_all, v_all)


class PositionalwiseFeedForward(torch.nn.Module):
    """Two-layer position-wise FFN: Linear -> activation -> dropout ->
    Linear, with the JAX module's activations: "relu" (the decoder),
    "swish" (the conformer encoder), "gelu" (the transformer LM) and
    "leaky_relu".  "gelu" is ``jax.nn.gelu``'s default, the tanh
    approximation (the erf form differs by up to 4.7e-4), and
    "leaky_relu" has JAX's slope, 0.01.

    Example
    -------
    >>> PositionalwiseFeedForward(32, 16)(torch.ones(2, 5, 16)).shape
    torch.Size([2, 5, 16])
    """

    ACTIVATIONS = {
        "relu": F.relu,
        "gelu": lambda h: F.gelu(h, approximate="tanh"),
        "swish": lambda h: h * torch.sigmoid(h),
        "leaky_relu": lambda h: F.leaky_relu(h, 0.01),
    }

    def __init__(self, d_ffn, d_model, activation="relu", dropout=0.0):
        super().__init__()
        if activation not in self.ACTIVATIONS:
            raise ValueError(f"Unknown activation {activation}")
        self.activation = activation
        self.w_1 = Linear(d_model, d_ffn)
        self.drop = Dropout(dropout)
        self.w_2 = Linear(d_ffn, d_model)

    def forward(self, x):
        """x: (..., d_model)."""
        h = self.ACTIVATIONS[self.activation](self.w_1(x))
        return self.w_2(self.drop(h))
