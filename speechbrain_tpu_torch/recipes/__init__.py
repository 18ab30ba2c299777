"""Recipes that run end to end on the port (``librispeech_asr``)."""
