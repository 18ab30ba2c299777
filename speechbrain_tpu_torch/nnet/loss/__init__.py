"""Loss functions with their own modules (the RNN-T loss)."""
