"""Joint CTC/attention ASR transformer with a conformer encoder.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/TransformerASR.py``
(``encode``, ``decode``, ``decode_cache_init``, ``decode_step``) for the
configuration the serving path uses: ``encoder_module="conformer"``,
``attention_type="RelPosMHAXL"``.  The CTC and seq2seq heads live
outside, as in the JAX package.
"""

import torch

from ....nnet.attention import RelPosEncXL
from ....nnet.linear import Linear
from .Conformer import ConformerEncoder
from .Transformer import (
    NormalizedEmbedding,
    PositionalEncoding,
    TransformerDecoder,
    get_key_padding_mask,
    get_lookahead_mask,
)

__all__ = ["TransformerASR"]


class TransformerASR(torch.nn.Module):
    """Input projection + conformer encoder + transformer decoder.

    Kept quirk of the reference: the decoder's absolute sine PE is also
    added to the encoder states before cross-attention (``decode`` and
    ``decode_cache_init``), while ``encode`` returns them raw.

    Example
    -------
    >>> net = TransformerASR(tgt_vocab=40, input_size=20, d_model=16,
    ...     nhead=2, num_encoder_layers=1, num_decoder_layers=1, d_ffn=32,
    ...     kernel_size=5)
    >>> enc = net.encode(torch.ones(2, 9, 20), torch.ones(2))
    >>> net.decode(torch.zeros(2, 3, dtype=torch.long), enc)[0].shape
    torch.Size([2, 3, 16])
    """

    def __init__(self, tgt_vocab, input_size, d_model=512, nhead=8,
                 num_encoder_layers=12, num_decoder_layers=6, d_ffn=2048,
                 activation="relu", normalize_before=False, kernel_size=31,
                 causal=False, max_length=2500):
        super().__init__()
        self.custom_src_module = Linear(input_size, d_model)
        self.custom_tgt_module = NormalizedEmbedding(d_model, tgt_vocab)
        self.positional_encoding_mod = PositionalEncoding(d_model, max_length)
        self.relpos_enc = RelPosEncXL(d_model)
        self.encoder = ConformerEncoder(
            num_encoder_layers, d_model, d_ffn, nhead, kernel_size, causal,
            activation="swish",
        )
        self.decoder = TransformerDecoder(
            num_decoder_layers, nhead, d_ffn, d_model, activation,
            normalize_before,
        )

    def encode(self, src, wav_len=None):
        """src: (B, T, input_size); wav_len: (B,) relative lengths."""
        mask = None
        if wav_len is not None:
            mask = get_key_padding_mask(wav_len, src.shape[1])
        x = self.custom_src_module(src)
        enc_out, _ = self.encoder(
            x, src_key_padding_mask=mask, pos_embs=self.relpos_enc(x)
        )
        return enc_out

    def decode(self, tgt, encoder_out, enc_lens=None):
        """Full-prefix decoder forward; returns (out, last cross-attn)."""
        tgt_mask = get_lookahead_mask(tgt.shape[1], device=tgt.device)
        mem_mask = None
        if enc_lens is not None:
            mem_mask = get_key_padding_mask(enc_lens, encoder_out.shape[1])
        tgt_emb = self.custom_tgt_module(tgt).to(encoder_out.dtype)
        tgt_emb = tgt_emb + self.positional_encoding_mod(tgt_emb)
        encoder_out = encoder_out + self.positional_encoding_mod(encoder_out)
        dec_out, _, cross_attns = self.decoder(
            tgt_emb, encoder_out, tgt_mask=tgt_mask,
            memory_key_padding_mask=mem_mask,
        )
        return dec_out, cross_attns[-1]

    def decode_cache_init(self, encoder_out, max_steps):
        """Per-layer caches for incremental decoding: cross K/V from the
        PE-augmented encoder states, zero self caches for ``max_steps``."""
        encoder_out = encoder_out + self.positional_encoding_mod(encoder_out)
        return self.decoder(None, encoder_out, mode="init_cache",
                            max_steps=max_steps)

    def decode_step(self, tgt_t, cache, pos, enc_lens=None, rows=None):
        """One decoder step at position ``pos`` for tokens ``tgt_t`` (B,);
        ``rows`` is the beam predecessor map fused into the self-cache
        update.  Returns ``(out (B, d_model), new caches)``."""
        mem_mask = None
        if enc_lens is not None:
            mem_mask = get_key_padding_mask(enc_lens, cache[0]["ck"].shape[1])
        tgt_emb = self.custom_tgt_module(tgt_t[:, None])
        dtype = cache[0]["ck"].dtype
        tgt_emb = tgt_emb.to(dtype)
        tgt_emb = tgt_emb + self.positional_encoding_mod(tgt_emb, offset=pos)
        out, new_cache = self.decoder(
            tgt_emb, None, memory_key_padding_mask=mem_mask, mode="step",
            cache=cache, pos=pos, rows=rows,
        )
        return out[:, 0], new_cache
