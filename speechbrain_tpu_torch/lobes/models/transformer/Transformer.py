"""Transformer decoder stack, positional encoding, masks and embedding.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/Transformer.py``
(``PositionalEncoding``, ``get_key_padding_mask``, ``get_lookahead_mask``,
``NormalizedEmbedding``, ``TransformerDecoderLayer``,
``TransformerDecoder``), eval mode.
"""

import math

import numpy as np
import torch

from ....nnet.attention import MultiheadAttention, PositionalwiseFeedForward
from .Conformer import LayerNorm, _ln

__all__ = [
    "PositionalEncoding",
    "get_key_padding_mask",
    "get_lookahead_mask",
    "NormalizedEmbedding",
    "TransformerDecoderLayer",
    "TransformerDecoder",
]


class PositionalEncoding(torch.nn.Module):
    """Absolute sinusoidal positional encoding for ``x.shape[1]``
    positions starting at ``offset`` (returned, not added).

    Example
    -------
    >>> PositionalEncoding(16)(torch.ones(2, 5, 16), offset=3).shape
    torch.Size([1, 5, 16])
    """

    def __init__(self, input_size, max_len=2500):
        super().__init__()
        pos = np.arange(max_len)[:, None].astype(np.float32)
        div = np.exp(
            np.arange(0, input_size, 2).astype(np.float32)
            * -(math.log(10000.0) / input_size)
        )[None, :]
        pe = np.zeros((max_len, input_size), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)

    def forward(self, x, offset=0):
        """x: (B, T, ...); returns (1, T, input_size) in x's dtype."""
        T = x.shape[1]
        offset = int(offset)
        return self.pe[offset : offset + T][None].to(x.dtype)


def get_key_padding_mask(padded_input_lens, T):
    """(B,) relative lengths -> (B, T) bool, True = pad; lengths round
    half to even, like ``jnp.round``.

    Example
    -------
    >>> get_key_padding_mask(torch.tensor([1.0, 0.5]), 4).tolist()
    [[False, False, False, False], [False, False, True, True]]
    """
    abs_lens = torch.round(padded_input_lens.float() * T)
    ar = torch.arange(T, device=padded_input_lens.device)
    return ar[None, :] >= abs_lens[:, None]


def get_lookahead_mask(T, device=None):
    """(T, T) bool causal mask, True = future (disallowed).

    Example
    -------
    >>> get_lookahead_mask(3).tolist()
    [[False, True, True], [False, False, True], [False, False, False]]
    """
    return torch.triu(torch.ones(T, T, dtype=torch.bool, device=device), 1)


class NormalizedEmbedding(torch.nn.Module):
    """Token embedding scaled by sqrt(d_model).

    Example
    -------
    >>> NormalizedEmbedding(8, 10)(torch.tensor([[1, 2]])).shape
    torch.Size([1, 2, 8])
    """

    def __init__(self, d_model, vocab):
        super().__init__()
        self.d_model = d_model
        self.emb = torch.nn.Embedding(vocab, d_model)

    def forward(self, x):
        """x: int token ids."""
        return self.emb(x.long()) * math.sqrt(self.d_model)


class TransformerDecoderLayer(torch.nn.Module):
    """Masked self-attention + cross-attention + FFN, pre- or post-norm.

    ``mode="full"``: the whole target sequence (training-shaped path).
    ``mode="init_cache"``: project ``memory`` into this layer's
    cross-attention cache ``{"ck", "cv"}``.
    ``mode="step"``: one token at position ``pos`` against
    ``cache={"skv", "ck", "cv"[, "alt"]}``; ``skv`` is the merged
    time-minor self cache and ``rows`` the beam predecessor map fused
    into its update.  When the cache carries a spare buffer ``alt``,
    the new self cache is written into it and the two swap roles
    (``skv`` <-> ``alt``) every step, so no cache is allocated per step.

    Example
    -------
    >>> layer = TransformerDecoderLayer(32, 2, 16)
    >>> out, sa, ca = layer(torch.ones(2, 4, 16), torch.ones(2, 6, 16))
    >>> out.shape
    torch.Size([2, 4, 16])
    """

    def __init__(self, d_ffn, nhead, d_model, activation="relu",
                 normalize_before=False):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiheadAttention(nhead, d_model)
        self.cross_attn = MultiheadAttention(nhead, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.ffn = PositionalwiseFeedForward(d_ffn, d_model, activation)

    def _pre(self, norm, x):
        return _ln(norm, x) if self.normalize_before else x

    def _post(self, norm, x):
        return x if self.normalize_before else _ln(norm, x)

    def forward(self, tgt, memory, tgt_mask=None, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, mode="full", cache=None,
                pos=None, rows=None):
        """See the class docstring for the modes and their returns."""
        if mode == "init_cache":
            ck, cv = self.cross_attn(None, memory, memory, mode="project_kv")
            return {"ck": ck, "cv": cv}
        if mode == "step":
            x = self._pre(self.norm1, tgt)
            alt = cache.get("alt") if rows is not None else None
            out, _, skv = self.self_attn(
                x, x, x, mode="step", kv_cache=cache["skv"],
                cache_index=pos, rows=rows, kv_dst=alt,
            )
            x = self._post(self.norm1, tgt + out)
            out, _, _ = self.cross_attn(
                self._pre(self.norm2, x), None, None, mode="step",
                kv_cache=(cache["ck"], cache["cv"]),
                key_padding_mask=memory_key_padding_mask,
            )
            x = self._post(self.norm2, x + out)
            x = self._post(self.norm3, x + self.ffn(self._pre(self.norm3, x)))
            new_cache = {"skv": skv, "ck": cache["ck"], "cv": cache["cv"]}
            if alt is not None:
                new_cache["alt"] = cache["skv"]  # the buffer just read
            elif "alt" in cache:
                new_cache["alt"] = cache["alt"]
            return x, new_cache
        x = self._pre(self.norm1, tgt)
        out, self_attn_w = self.self_attn(
            x, x, x, key_padding_mask=tgt_key_padding_mask, attn_mask=tgt_mask,
        )
        x = self._post(self.norm1, tgt + out)
        out, cross_attn_w = self.cross_attn(
            self._pre(self.norm2, x), memory, memory,
            key_padding_mask=memory_key_padding_mask,
        )
        x = self._post(self.norm2, x + out)
        x = self._post(self.norm3, x + self.ffn(self._pre(self.norm3, x)))
        return x, self_attn_w, cross_attn_w


class TransformerDecoder(torch.nn.Module):
    """Stack of decoder layers and a final LayerNorm.

    ``mode="init_cache"`` returns per-layer caches: cross K/V projected
    from ``memory`` and a zero merged self cache ``skv`` of shape
    (B, d_model, 2 * lp), lp = ``max_steps`` rounded up to 128.
    ``mode="step"`` decodes one token at ``pos`` and returns
    ``(out (B, 1, d), new caches)``.

    Example
    -------
    >>> dec = TransformerDecoder(2, 2, 32, 16)
    >>> out, sa, ca = dec(torch.ones(2, 4, 16), torch.ones(2, 6, 16))
    >>> out.shape
    torch.Size([2, 4, 16])
    """

    def __init__(self, num_layers, nhead, d_ffn, d_model, activation="relu",
                 normalize_before=False):
        super().__init__()
        self.d_model = d_model
        self.layers = torch.nn.ModuleList(
            TransformerDecoderLayer(d_ffn, nhead, d_model, activation,
                                    normalize_before)
            for _ in range(num_layers)
        )
        self.norm_out = LayerNorm(d_model)

    def forward(self, tgt, memory, tgt_mask=None, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, mode="full", cache=None,
                pos=None, max_steps=None, rows=None):
        """See the class docstring for the modes and their returns."""
        if mode == "init_cache":
            B = memory.shape[0]
            lp = -(-max_steps // 128) * 128
            caches = []
            for layer in self.layers:
                c = layer(None, memory, mode="init_cache")
                c["skv"] = torch.zeros(
                    (B, self.d_model, 2 * lp), dtype=memory.dtype,
                    device=memory.device,
                )
                caches.append(c)
            return caches
        if mode == "step":
            output = tgt
            new_caches = []
            for layer, c in zip(self.layers, cache):
                output, c = layer(
                    output, None,
                    memory_key_padding_mask=memory_key_padding_mask,
                    mode="step", cache=c, pos=pos, rows=rows,
                )
                new_caches.append(c)
            return _ln(self.norm_out, output), new_caches
        output = tgt
        self_attns, cross_attns = [], []
        for layer in self.layers:
            output, sa, ca = layer(
                output, memory, tgt_mask=tgt_mask,
                tgt_key_padding_mask=tgt_key_padding_mask,
                memory_key_padding_mask=memory_key_padding_mask,
            )
            self_attns.append(sa)
            cross_attns.append(ca)
        return _ln(self.norm_out, output), self_attns, cross_attns
