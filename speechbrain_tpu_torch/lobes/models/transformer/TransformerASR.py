"""Joint CTC/attention ASR transformer with a conformer or a transformer
encoder.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/TransformerASR.py``
(``__call__`` as ``forward``, ``encode``, ``decode``,
``decode_cache_init``, ``decode_step``) in the three configurations the
JAX module builds: ``encoder_module="conformer"`` with
``attention_type="RelPosMHAXL"`` (the conformer recipes), and
``encoder_module="transformer"`` with ``"regularMHA"`` (the module's
default, LibriSpeech's and AISHELL-1's ``transformer`` yamls) or with
``"RelPosMHAXL"``.  The CTC and seq2seq heads live outside, as in the JAX
package.  With ``num_decoder_layers=0`` (the conformer-transducer, whose
prediction network lives outside) neither the decoder nor the target
embedding is built, as Flax creates no parameters for them, and
``forward`` returns ``(enc_out, None)``.
"""

import torch

from ....nnet.attention import RelPosEncXL
from ....nnet.linear import Linear
from .Conformer import ConformerEncoder
from .Transformer import (
    NormalizedEmbedding,
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
    get_key_padding_mask,
    get_lookahead_mask,
)

__all__ = ["TransformerASR"]


class TransformerASR(torch.nn.Module):
    """Input projection + encoder + transformer decoder.

    With ``attention_type="RelPosMHAXL"`` the encoder's layers read the
    relative encodings of ``RelPosEncXL``, and the reference's quirk is
    kept: the decoder's absolute sine PE is also added to the encoder
    states before cross-attention (``forward``, ``decode`` and
    ``decode_cache_init``), and ``forward`` returns that sum (the CTC
    head sees it in training), while ``encode`` returns the states raw.
    With ``"regularMHA"`` (transformer encoder only) the absolute sine PE
    is added to the projected input instead, and the encoder states
    reach the decoder and the CTC head as they are.  The conformer
    encoder's activation is swish; ``activation`` and
    ``normalize_before`` are the transformer encoder's and the
    decoder's.  ``dropout`` is the encoder's and decoder's.

    Example
    -------
    >>> net = TransformerASR(tgt_vocab=40, input_size=20, d_model=16,
    ...     nhead=2, num_encoder_layers=1, num_decoder_layers=1, d_ffn=32,
    ...     kernel_size=5)
    >>> enc = net.encode(torch.ones(2, 9, 20), torch.ones(2))
    >>> net.decode(torch.zeros(2, 3, dtype=torch.long), enc)[0].shape
    torch.Size([2, 3, 16])
    >>> enc, dec = net(torch.ones(2, 9, 20), torch.ones(2, 3, dtype=torch.long),
    ...     torch.ones(2))
    >>> enc.shape, dec.shape
    (torch.Size([2, 9, 16]), torch.Size([2, 3, 16]))
    >>> enc_only = TransformerASR(tgt_vocab=40, input_size=20, d_model=16,
    ...     nhead=2, num_encoder_layers=1, num_decoder_layers=0, d_ffn=32,
    ...     kernel_size=5)
    >>> enc_only(torch.ones(2, 9, 20), None, torch.ones(2))[1] is None
    True
    >>> plain = TransformerASR(tgt_vocab=40, input_size=20, d_model=16,
    ...     nhead=2, num_encoder_layers=1, num_decoder_layers=1, d_ffn=32,
    ...     encoder_module="transformer", attention_type="regularMHA")
    >>> plain.encode(torch.ones(2, 9, 20), torch.ones(2)).shape
    torch.Size([2, 9, 16])
    """

    def __init__(self, tgt_vocab, input_size, d_model=512, nhead=8,
                 num_encoder_layers=12, num_decoder_layers=6, d_ffn=2048,
                 activation="relu", normalize_before=False, kernel_size=31,
                 causal=False, max_length=2500, dropout=0.0,
                 encoder_module="conformer", attention_type="RelPosMHAXL"):
        super().__init__()
        if encoder_module not in ("conformer", "transformer"):
            raise ValueError(f"Unknown encoder_module {encoder_module}")
        if attention_type not in ("RelPosMHAXL", "regularMHA"):
            raise ValueError(f"Unknown attention_type {attention_type}")
        if encoder_module == "conformer" and attention_type != "RelPosMHAXL":
            raise ValueError("Conformer encoder requires RelPosMHAXL attention")
        self.encoder_module = encoder_module
        self.attention_type = attention_type
        self.custom_src_module = Linear(input_size, d_model)
        self.custom_tgt_module = (NormalizedEmbedding(d_model, tgt_vocab)
                                  if num_decoder_layers > 0 else None)
        self.positional_encoding_mod = PositionalEncoding(d_model, max_length)
        self.relpos_enc = RelPosEncXL(d_model)
        if encoder_module == "conformer":
            self.encoder = ConformerEncoder(
                num_encoder_layers, d_model, d_ffn, nhead, kernel_size,
                causal, activation="swish", dropout=dropout,
            )
        else:
            self.encoder = TransformerEncoder(
                num_encoder_layers, nhead, d_ffn, d_model, dropout,
                activation, normalize_before, attention_type,
            )
        self.decoder = None
        if num_decoder_layers > 0:
            self.decoder = TransformerDecoder(
                num_decoder_layers, nhead, d_ffn, d_model, activation,
                normalize_before, dropout,
            )

    def forward(self, src, tgt, wav_len=None, pad_idx=0):
        """Training forward: src (B, T, input_size), tgt (B, L) token ids
        (positions equal to ``pad_idx`` are masked as keys), wav_len (B,)
        relative lengths.  Returns ``(enc_out as _memory gives it,
        dec_out)``, or ``(enc_out, None)`` without a decoder."""
        enc_out, src_mask = self._encode(src, wav_len)
        if self.decoder is None:
            return enc_out, None
        enc_out = self._memory(enc_out)
        tgt_mask = get_lookahead_mask(tgt.shape[1], device=tgt.device)
        tgt_emb = self.custom_tgt_module(tgt).to(enc_out.dtype)
        tgt_emb = tgt_emb + self.positional_encoding_mod(tgt_emb)
        dec_out, _, _ = self.decoder(
            tgt_emb, enc_out, tgt_mask=tgt_mask,
            tgt_key_padding_mask=tgt == pad_idx,
            memory_key_padding_mask=src_mask,
        )
        return enc_out, dec_out

    def _encode(self, src, wav_len):
        mask = None
        if wav_len is not None:
            mask = get_key_padding_mask(wav_len, src.shape[1])
        x = self.custom_src_module(src)
        if self.attention_type == "RelPosMHAXL":
            enc_out, _ = self.encoder(
                x, src_key_padding_mask=mask, pos_embs=self.relpos_enc(x)
            )
        else:
            x = x + self.positional_encoding_mod(x)
            enc_out, _ = self.encoder(x, src_key_padding_mask=mask)
        return enc_out, mask

    def _memory(self, enc_out):
        """The encoder states as the decoder's cross-attention reads them:
        with the absolute PE added under RelPosMHAXL (the quirk)."""
        if self.attention_type == "RelPosMHAXL":
            return enc_out + self.positional_encoding_mod(enc_out)
        return enc_out

    def encode(self, src, wav_len=None):
        """src: (B, T, input_size); wav_len: (B,) relative lengths."""
        return self._encode(src, wav_len)[0]

    def decode(self, tgt, encoder_out, enc_lens=None):
        """Full-prefix decoder forward; returns (out, last cross-attn)."""
        tgt_mask = get_lookahead_mask(tgt.shape[1], device=tgt.device)
        mem_mask = None
        if enc_lens is not None:
            mem_mask = get_key_padding_mask(enc_lens, encoder_out.shape[1])
        tgt_emb = self.custom_tgt_module(tgt).to(encoder_out.dtype)
        tgt_emb = tgt_emb + self.positional_encoding_mod(tgt_emb)
        encoder_out = self._memory(encoder_out)
        dec_out, _, cross_attns = self.decoder(
            tgt_emb, encoder_out, tgt_mask=tgt_mask,
            memory_key_padding_mask=mem_mask,
        )
        return dec_out, cross_attns[-1]

    def decode_cache_init(self, encoder_out, max_steps):
        """Per-layer caches for incremental decoding: cross K/V from the
        encoder states as ``_memory`` gives them, zero self caches for
        ``max_steps``."""
        return self.decoder(None, self._memory(encoder_out), mode="init_cache",
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
