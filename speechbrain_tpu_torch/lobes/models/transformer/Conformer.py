"""Conformer encoder and decoder: macaron FFN + MHA + convolution module.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/Conformer.py``
(``ConvolutionModule``, ``ConformerEncoderLayer``, ``ConformerEncoder``,
``ConformerDecoderLayer``, ``ConformerDecoder``), in eval and training
mode.  LayerNorms use eps 1e-6, Flax's default.
``dropout`` sits where the JAX modules put it: on the convolution
module's output (before the output mask), after each half-FFN and after
the attention, plus the FFNs' and the attention weights' own dropout.
"""

import warnings

import torch

from ....nnet.attention import (
    MultiheadAttention,
    PositionalwiseFeedForward,
    RelPosMHAXL,
)
from ....nnet.dropout import Dropout
from ....nnet.linear import Linear
from ....ops.depthwise_conv import depthwise_conv1d, depthwise_conv1d_plain

__all__ = ["ConvolutionModule", "ConformerEncoderLayer", "ConformerEncoder",
           "ConformerDecoderLayer", "ConformerDecoder"]

LN_EPS = 1e-6


def LayerNorm(d):
    """``torch.nn.LayerNorm`` with Flax's eps (1e-6, not torch's 1e-5)."""
    return torch.nn.LayerNorm(d, eps=LN_EPS)


def _ln(norm, x):
    # LayerNorm in the activation dtype (parameters cast, as in Flax)
    return torch.nn.functional.layer_norm(
        x, norm.normalized_shape, norm.weight.to(x.dtype),
        norm.bias.to(x.dtype), norm.eps,
    )


class ConvolutionModule(torch.nn.Module):
    """LN -> Linear(2d) -> GLU -> depthwise conv -> LN -> swish -> Linear
    -> dropout.

    Only the module OUTPUT is masked (padded frames still reach their
    neighbours through the depthwise conv, as in the reference).  The
    depthwise conv goes through the kernel when ``use_kernels``.

    Example
    -------
    >>> conv = ConvolutionModule(16, kernel_size=5)
    >>> conv(torch.ones(2, 7, 16)).shape
    torch.Size([2, 7, 16])
    """

    def __init__(self, input_size, kernel_size=31, bias=True, causal=False,
                 dropout=0.0):
        super().__init__()
        d = input_size
        self.causal = causal
        self.use_kernels = True
        self.norm_in = LayerNorm(d)
        self.pointwise_in = Linear(d, 2 * d, bias=bias)
        self.depthwise_kernel = torch.nn.Parameter(torch.zeros(kernel_size, d))
        self.depthwise_bias = (
            torch.nn.Parameter(torch.zeros(d)) if bias else None
        )
        self.norm_mid = LayerNorm(d)
        self.pointwise_out = Linear(d, d, bias=bias)
        self.drop = Dropout(dropout)
        torch.nn.init.normal_(self.depthwise_kernel, std=kernel_size ** -0.5)

    def forward(self, x, mask=None):
        """x: (B, T, d); mask: (B, T) True = pad."""
        y = self.pointwise_in(_ln(self.norm_in, x))
        a, g = y.chunk(2, dim=-1)
        y = a * torch.sigmoid(g)  # GLU
        conv = depthwise_conv1d if self.use_kernels else depthwise_conv1d_plain
        y = conv(y.contiguous(), self.depthwise_kernel.to(x.dtype),
                 self.depthwise_bias, causal=self.causal)
        y = _ln(self.norm_mid, y)
        y = y * torch.sigmoid(y)  # swish
        y = self.drop(self.pointwise_out(y))
        if mask is not None:
            y = y.masked_fill(mask[..., None], 0.0)
        return y


class ConformerEncoderLayer(torch.nn.Module):
    """Macaron: x + 0.5 FFN -> + MHA -> + conv -> + 0.5 FFN -> LN.

    Example
    -------
    >>> from speechbrain_tpu_torch.nnet.attention import RelPosEncXL
    >>> layer = ConformerEncoderLayer(16, 32, 2, kernel_size=5)
    >>> x = torch.ones(2, 7, 16)
    >>> layer(x, pos_embs=RelPosEncXL(16)(x))[0].shape
    torch.Size([2, 7, 16])
    """

    def __init__(self, d_model, d_ffn, nhead, kernel_size=31, causal=False,
                 activation="swish", dropout=0.0):
        super().__init__()
        self.norm_ffn1 = LayerNorm(d_model)
        self.ffn1 = PositionalwiseFeedForward(d_ffn, d_model, activation,
                                              dropout)
        self.norm_mha = LayerNorm(d_model)
        self.mha = RelPosMHAXL(d_model, nhead, dropout=dropout)
        self.conv = ConvolutionModule(d_model, kernel_size, causal=causal,
                                      dropout=dropout)
        self.norm_ffn2 = LayerNorm(d_model)
        self.ffn2 = PositionalwiseFeedForward(d_ffn, d_model, activation,
                                              dropout)
        self.norm_out = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, x, src_mask=None, src_key_padding_mask=None,
                pos_embs=None):
        """x: (B, T, d); returns (x, attention weights or None)."""
        x = x + 0.5 * self.drop(self.ffn1(_ln(self.norm_ffn1, x)))
        a = _ln(self.norm_mha, x)
        attn_out, attn_w = self.mha(
            a, a, a, pos_embs, key_padding_mask=src_key_padding_mask,
            attn_mask=src_mask,
        )
        x = x + self.drop(attn_out)
        x = x + self.conv(x, mask=src_key_padding_mask)
        x = x + 0.5 * self.drop(self.ffn2(_ln(self.norm_ffn2, x)))
        return _ln(self.norm_out, x), attn_w


class ConformerEncoder(torch.nn.Module):
    """Stack of conformer layers and a final LayerNorm (eps 1e-6).

    Example
    -------
    >>> from speechbrain_tpu_torch.nnet.attention import RelPosEncXL
    >>> enc = ConformerEncoder(2, 16, 32, 2, kernel_size=5)
    >>> x = torch.ones(2, 7, 16)
    >>> enc(x, pos_embs=RelPosEncXL(16)(x))[0].shape
    torch.Size([2, 7, 16])
    """

    def __init__(self, num_layers, d_model, d_ffn, nhead, kernel_size=31,
                 causal=False, activation="swish", dropout=0.0):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            ConformerEncoderLayer(d_model, d_ffn, nhead, kernel_size, causal,
                                  activation, dropout)
            for _ in range(num_layers)
        )
        self.norm_out = LayerNorm(d_model)

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                pos_embs=None):
        """Returns (output, list of per-layer attention weights)."""
        output = src
        attns = []
        for layer in self.layers:
            output, attn = layer(output, src_mask, src_key_padding_mask,
                                 pos_embs)
            attns.append(attn)
        return _ln(self.norm_out, output), attns


class ConformerDecoderLayer(torch.nn.Module):
    """x + 0.5 FFN -> + one attention over ``memory`` -> + the (causal)
    convolution module -> LN(x + 0.5 FFN).

    As in the JAX layer, there is no self-attention: the one attention
    block's queries are the targets and its keys and values the encoder
    ``memory`` (``attention_type`` "regularMHA", or "RelPosMHAXL" with
    ``pos_embs_src`` and its future positions masked when ``causal``); the
    attention output is not dropped, and the convolution module sees no
    padding mask.  Returns ``(out, attention weights, attention
    weights)``, the JAX layer's triple.

    Example
    -------
    >>> layer = ConformerDecoderLayer(16, 32, 2, kernel_size=3,
    ...                               attention_type="regularMHA")
    >>> layer(torch.ones(2, 5, 16), torch.ones(2, 7, 16))[0].shape
    torch.Size([2, 5, 16])
    """

    def __init__(self, d_model, d_ffn, nhead, kernel_size=31, bias=True,
                 causal=True, dropout=0.0, activation="swish",
                 attention_type="RelPosMHAXL"):
        super().__init__()
        if attention_type not in ("regularMHA", "RelPosMHAXL"):
            raise ValueError(f"Unknown attention_type {attention_type}")
        self.causal = causal
        self.attention_type = attention_type
        self.norm_ffn1 = LayerNorm(d_model)
        self.ffn1 = PositionalwiseFeedForward(d_ffn, d_model, activation,
                                              dropout)
        self.norm1 = LayerNorm(d_model)
        if attention_type == "regularMHA":
            self.mha = MultiheadAttention(nhead, d_model, dropout)
        else:
            self.mha = RelPosMHAXL(d_model, nhead, mask_pos_future=causal,
                                   dropout=dropout)
        self.conv = ConvolutionModule(d_model, kernel_size, bias=bias,
                                      causal=causal, dropout=dropout)
        self.norm_ffn2 = LayerNorm(d_model)
        self.ffn2 = PositionalwiseFeedForward(d_ffn, d_model, activation,
                                              dropout)
        self.norm2 = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                pos_embs_tgt=None, pos_embs_src=None):
        """tgt (B, L, d), memory (B, T, d); ``memory_mask`` (L, T) and
        ``memory_key_padding_mask`` (B, T) True = disallowed; the target
        masks and ``pos_embs_tgt`` are taken and unused, as in JAX."""
        if not self.causal:
            warnings.warn("Decoder is not causal; in most applications it "
                          "should be causal, you have been warned!")
        x = tgt + 0.5 * self.drop(self.ffn1(_ln(self.norm_ffn1, tgt)))
        skip = x
        a = _ln(self.norm1, x)
        if self.attention_type == "regularMHA":
            x, attn = self.mha(a, memory, memory,
                               key_padding_mask=memory_key_padding_mask,
                               attn_mask=memory_mask)
        else:
            x, attn = self.mha(a, memory, memory, pos_embs_src,
                               key_padding_mask=memory_key_padding_mask,
                               attn_mask=memory_mask)
        x = x + skip
        x = x + self.conv(x)
        x = x + 0.5 * self.drop(self.ffn2(_ln(self.norm_ffn2, x)))
        return _ln(self.norm2, x), attn, attn


class ConformerDecoder(torch.nn.Module):
    """Stack of ``ConformerDecoderLayer``s and a final LayerNorm (eps
    1e-6).  Returns ``(out, per-layer attention weights, the same
    list)``, as the JAX module does.

    Example
    -------
    >>> dec = ConformerDecoder(2, 16, 32, 2, kernel_size=3,
    ...                        attention_type="regularMHA")
    >>> out, _, attns = dec(torch.ones(2, 5, 16), torch.ones(2, 7, 16))
    >>> out.shape, len(attns)
    (torch.Size([2, 5, 16]), 2)
    """

    def __init__(self, num_layers, d_model, d_ffn, nhead, kernel_size=31,
                 bias=True, causal=True, dropout=0.0, activation="swish",
                 attention_type="RelPosMHAXL"):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            ConformerDecoderLayer(d_model, d_ffn, nhead, kernel_size, bias,
                                  causal, dropout, activation, attention_type)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                pos_embs_tgt=None, pos_embs_src=None):
        """See ``ConformerDecoderLayer.forward``."""
        output = tgt
        self_attns, attns = [], []
        for layer in self.layers:
            output, sa, a = layer(
                output, memory, tgt_mask=tgt_mask, memory_mask=memory_mask,
                tgt_key_padding_mask=tgt_key_padding_mask,
                memory_key_padding_mask=memory_key_padding_mask,
                pos_embs_tgt=pos_embs_tgt, pos_embs_src=pos_embs_src,
            )
            self_attns.append(sa)
            attns.append(a)
        return _ln(self.norm, output), self_attns, attns
