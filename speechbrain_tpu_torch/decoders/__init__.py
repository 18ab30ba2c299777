"""Decoding: CTC prefix scoring and beam search."""
