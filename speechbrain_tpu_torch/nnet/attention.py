"""Attention for the conformer encoder and the transformer decoder.

Counterpart of ``speechbrain_tpu/nnet/attention.py``: ``RelPosEncXL``,
``_rel_shift``, ``RelPosMHAXL``, ``MultiheadAttention`` (modes "full",
"project_kv" and "step") and ``PositionalwiseFeedForward``.  Masks
replace scores with -65000 (``NEG_FILL``); softmax runs in float32.

Each module that can reach a kernel has ``use_kernels`` (default True).
With it, ``RelPosMHAXL`` routes long utterances to the rel-pos kernel
under the JAX gate (T_q == T_k, T % 128 == 0, 512 <= T <= 1024, no
attn_mask) with "the tensor is on CUDA" in place of "the backend is a
TPU", and the decoder's self-attention step goes through
``beam_attend_step``.  With it off, the same math runs through the plain
PyTorch versions (used to check the kernels on the card).
"""

import math

import torch
import torch.nn.functional as F

from ..ops.beam_cache import (
    append_attend,
    beam_attend_step,
    beam_attend_step_plain,
)
from ..ops.relpos_attention import relpos_attention
from .linear import Linear

__all__ = [
    "RelPosEncXL",
    "RelPosMHAXL",
    "MultiheadAttention",
    "PositionalwiseFeedForward",
]

NEG_FILL = -65000.0


def _softmax(s, dtype):
    return torch.softmax(s.float(), dim=-1).to(dtype)


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

    Example
    -------
    >>> mha = RelPosMHAXL(16, 4)
    >>> x = torch.ones(2, 6, 16)
    >>> out, attn = mha(x, x, x, RelPosEncXL(16)(x))
    >>> out.shape
    torch.Size([2, 6, 16])
    """

    def __init__(self, embed_dim, num_heads, mask_pos_future=False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.mask_pos_future = mask_pos_future
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
        return (
            self.use_kernels
            and query.device.type == "cuda"
            and T_q == T_k
            and T_q % 128 == 0
            and 512 <= T_q <= 1024
            and attn_mask is None
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
        attn = _softmax(scores, dt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = self.out_proj(out.reshape(B, T_q, self.embed_dim))
        return out, attn


class MultiheadAttention(torch.nn.Module):
    """Standard multi-head attention with biased q/k/v/out projections;
    scores scaled by 1/sqrt(d_head).

    Modes: ``"full"`` (batched), ``"project_kv"`` (returns the projected
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

    def __init__(self, nhead, d_model):
        super().__init__()
        self.nhead = nhead
        self.d_model = d_model
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
        attn = _softmax(scores, query.dtype)
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
    """Two-layer position-wise FFN: Linear -> activation -> Linear, with
    the activations the conformer configs use ("relu" in the decoder,
    "swish" in the encoder).

    Example
    -------
    >>> PositionalwiseFeedForward(32, 16)(torch.ones(2, 5, 16)).shape
    torch.Size([2, 5, 16])
    """

    def __init__(self, d_ffn, d_model, activation="relu"):
        super().__init__()
        if activation not in ("relu", "swish"):
            raise ValueError(f"Unknown activation {activation}")
        self.activation = activation
        self.w_1 = Linear(d_model, d_ffn)
        self.w_2 = Linear(d_ffn, d_model)

    def forward(self, x):
        """x: (..., d_model)."""
        h = self.w_1(x)
        h = F.relu(h) if self.activation == "relu" else h * torch.sigmoid(h)
        return self.w_2(h)
