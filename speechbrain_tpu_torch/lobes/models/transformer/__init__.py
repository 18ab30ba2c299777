"""Transformer and conformer ASR models."""
