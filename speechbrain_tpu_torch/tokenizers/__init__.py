"""Tokenizers: subword models (``SentencePiece``, ``BPEModel``)."""
