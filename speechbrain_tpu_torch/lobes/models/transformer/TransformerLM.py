"""Transformer language model.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/TransformerLM.py``
(``TransformerLM``): scaled token embedding (+ an optional projection
from ``d_embedding``) + absolute sine positions -> dropout -> a causal
``TransformerEncoder`` (no key padding) -> logits over ``vocab``.
"""

import torch

from ....nnet.dropout import Dropout
from ....nnet.linear import Linear
from .Transformer import (
    NormalizedEmbedding,
    PositionalEncoding,
    TransformerEncoder,
    get_lookahead_mask,
)

__all__ = ["TransformerLM"]


class TransformerLM(torch.nn.Module):
    """Causal transformer LM: tokens (B, L) -> logits (B, L, vocab).

    The defaults are the JAX module's (the LibriSpeech recipe's LM:
    d_model 768, 12 heads, 12 post-norm layers, d_ffn 3072, gelu).
    ``forward``'s ``dtype`` is the activation dtype; the parameters stay
    float32 and are cast per op, as in the other modules.

    Example
    -------
    >>> lm = TransformerLM(vocab=50, d_model=32, nhead=4,
    ...                    num_encoder_layers=2, d_ffn=64)
    >>> lm(torch.zeros(2, 7, dtype=torch.long)).shape
    torch.Size([2, 7, 50])
    """

    def __init__(self, vocab, d_model=768, nhead=12, num_encoder_layers=12,
                 d_ffn=3072, dropout=0.0, activation="gelu",
                 normalize_before=False, d_embedding=None):
        super().__init__()
        d_emb = d_embedding or d_model
        self.emb = NormalizedEmbedding(d_emb, vocab)
        self.emb_proj = (Linear(d_emb, d_model)
                         if d_emb != d_model else None)
        self.positional_encoding = PositionalEncoding(d_model)
        self.drop = Dropout(dropout)
        self.encoder = TransformerEncoder(
            num_encoder_layers, nhead, d_ffn, d_model, dropout, activation,
            normalize_before,
        )
        self.output_proj = Linear(d_model, vocab)

    def forward(self, src, dtype=torch.float32):
        """src: (B, L) token ids; returns (B, L, vocab) logits in
        ``dtype``."""
        emb = self.emb(src).to(dtype)
        if self.emb_proj is not None:
            emb = self.emb_proj(emb)
        x = self.drop(emb + self.positional_encoding(emb))
        x, _ = self.encoder(
            x, src_mask=get_lookahead_mask(src.shape[1], device=src.device)
        )
        return self.output_proj(x)
