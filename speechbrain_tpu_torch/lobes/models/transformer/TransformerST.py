"""Speech translation transformer with auxiliary ASR and MT branches.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/TransformerST.py``:
``TransformerST`` wraps a ``TransformerASR`` (``st``: the speech encoder
and the translation decoder) and builds the JAX module's branches under
its conditions only: an ASR decoder (``asr_decoder``, a
``TransformerDecoder``) with its transcript embedding
(``custom_asr_tgt_module``) when ``ctc_weight < 1`` and ``asr_weight >
0``, and a text encoder (``mt_encoder``, a regularMHA
``TransformerEncoder``) with its source embedding
(``custom_mt_src_module``) when ``mt_weight > 0``.  The multi-task loss
lives in the recipes, as in the JAX package.
"""

import torch

from .Transformer import (
    NormalizedEmbedding,
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
    get_key_padding_mask,
    get_lookahead_mask,
)
from .TransformerASR import TransformerASR

__all__ = ["TransformerST"]


class TransformerST(torch.nn.Module):
    """Speech translation (ST) transformer with optional ASR and MT
    branches.

    Call modes (those of the JAX module):

    - ``forward(src, tgt, wav_len, pad_idx)`` -> ``(enc, dec)``: the ST
      path, ``st.forward``; under RelPosMHAXL ``enc`` carries the
      decoder's absolute PE, as ``TransformerASR.forward`` returns it.
    - ``encode(src, wav_len)`` -> the raw encoder states.
    - ``decode(tgt, encoder_out, enc_lens)`` -> ``(dec, cross attn)``,
      and ``decode_cache_init``/``decode_step``: ``st``'s, for the
      KV-cached beam search.
    - ``forward_asr(encoder_out, tgt, wav_len, pad_idx)``: the ASR decoder
      over ``encoder_out`` as it is given (the Fisher recipe passes
      ``forward``'s ``enc``), the transcript embedding plus the absolute
      PE, the memory mask rounding ``wav_len * T``.
    - ``forward_mt(src_tokens, tgt, pad_idx)`` -> ``(enc, dec)``: the text
      encoder, then ``st``'s translation decoder over it.
    - ``forward_mt_decoder_only(src_feats, tgt, pad_idx)``: ``st``'s
      translation decoder over features encoded elsewhere (no memory
      mask).

    ``tgt`` positions equal to ``pad_idx`` are masked as keys of the
    decoders' self-attention; ``src`` tokens equal to it as keys of the
    text encoder and of the cross-attention over it.

    Example
    -------
    >>> net = TransformerST(tgt_vocab=40, input_size=16, d_model=32,
    ...     nhead=4, num_encoder_layers=1, num_decoder_layers=1, d_ffn=64,
    ...     asr_weight=0.3, ctc_weight=0.5, asr_tgt_vocab=30).eval()
    >>> enc, dec = net(torch.ones(2, 12, 16),
    ...                torch.zeros(2, 5, dtype=torch.long), torch.ones(2))
    >>> enc.shape, dec.shape
    (torch.Size([2, 12, 32]), torch.Size([2, 5, 32]))
    >>> net.forward_asr(enc, torch.ones(2, 3, dtype=torch.long)).shape
    torch.Size([2, 3, 32])
    >>> hasattr(net, "mt_encoder")
    False
    """

    def __init__(self, tgt_vocab, input_size, d_model=512, nhead=8,
                 num_encoder_layers=6, num_decoder_layers=6, d_ffn=2048,
                 dropout=0.1, activation="relu", normalize_before=False,
                 kernel_size=31, encoder_module="transformer",
                 attention_type="regularMHA", max_length=2500, causal=False,
                 ctc_weight=0.0, asr_weight=0.0, mt_weight=0.0,
                 asr_tgt_vocab=0, mt_src_vocab=0):
        super().__init__()
        self.st = TransformerASR(
            tgt_vocab, input_size, d_model=d_model, nhead=nhead,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, d_ffn=d_ffn,
            activation=activation, normalize_before=normalize_before,
            kernel_size=kernel_size, causal=causal, max_length=max_length,
            dropout=dropout, encoder_module=encoder_module,
            attention_type=attention_type,
        )
        self.pos_enc = PositionalEncoding(d_model, max_length)
        if ctc_weight < 1 and asr_weight > 0:
            self.asr_decoder = TransformerDecoder(
                num_decoder_layers, nhead, d_ffn, d_model, activation,
                normalize_before, dropout,
            )
            self.custom_asr_tgt_module = NormalizedEmbedding(d_model,
                                                             asr_tgt_vocab)
        if mt_weight > 0:
            self.custom_mt_src_module = NormalizedEmbedding(d_model,
                                                            mt_src_vocab)
            self.mt_encoder = TransformerEncoder(
                num_encoder_layers, nhead, d_ffn, d_model, dropout,
                activation, normalize_before,
            )

    def forward(self, src, tgt, wav_len=None, pad_idx=0):
        """The ST path: ``st.forward``."""
        return self.st(src, tgt, wav_len=wav_len, pad_idx=pad_idx)

    def encode(self, src, wav_len=None):
        """The speech encoder only: raw states."""
        return self.st.encode(src, wav_len)

    def decode(self, tgt, encoder_out, enc_lens=None):
        """The translation decoder over the full prefix (beam search)."""
        return self.st.decode(tgt, encoder_out, enc_lens)

    def decode_cache_init(self, encoder_out, max_steps):
        """``st.decode_cache_init``: the KV-cached search's caches."""
        return self.st.decode_cache_init(encoder_out, max_steps)

    def decode_step(self, tgt_t, cache, pos, enc_lens=None, rows=None):
        """``st.decode_step``: one KV-cached translation decoder step."""
        return self.st.decode_step(tgt_t, cache, pos, enc_lens, rows=rows)

    def _embed(self, module, tokens, dtype=None):
        """An embedding plus the absolute PE, cast to ``dtype`` when
        given (the states it meets)."""
        x = module(tokens)
        x = x if dtype is None else x.to(dtype)
        return x + self.pos_enc(x)

    def forward_asr(self, encoder_out, tgt, wav_len=None, pad_idx=0):
        """The ASR decoder over ``encoder_out`` as given."""
        memory_mask = None
        if wav_len is not None:
            memory_mask = get_key_padding_mask(wav_len, encoder_out.shape[1])
        x = self._embed(self.custom_asr_tgt_module, tgt, encoder_out.dtype)
        out, _, _ = self.asr_decoder(
            x, encoder_out,
            tgt_mask=get_lookahead_mask(tgt.shape[1], device=tgt.device),
            tgt_key_padding_mask=tgt == pad_idx,
            memory_key_padding_mask=memory_mask,
        )
        return out

    def forward_mt(self, src, tgt, pad_idx=0):
        """The text-to-text branch (in the embeddings' dtype): returns
        ``(encoder_out, decoder_out)``."""
        src_mask = src == pad_idx
        x = self._embed(self.custom_mt_src_module, src)
        encoder_out, _ = self.mt_encoder(x, src_key_padding_mask=src_mask)
        y = self._embed(self.st.custom_tgt_module, tgt)
        out, _, _ = self.st.decoder(
            y, encoder_out,
            tgt_mask=get_lookahead_mask(tgt.shape[1], device=tgt.device),
            tgt_key_padding_mask=tgt == pad_idx,
            memory_key_padding_mask=src_mask,
        )
        return encoder_out, out

    def forward_mt_decoder_only(self, src, tgt, pad_idx=0):
        """The translation decoder over features ``src`` (B, T, d_model)
        encoded elsewhere (e.g. by wav2vec)."""
        y = self._embed(self.st.custom_tgt_module, tgt, src.dtype)
        out, _, _ = self.st.decoder(
            y, src,
            tgt_mask=get_lookahead_mask(tgt.shape[1], device=tgt.device),
            tgt_key_padding_mask=tgt == pad_idx,
        )
        return out
