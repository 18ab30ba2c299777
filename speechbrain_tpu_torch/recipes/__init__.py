"""Recipes that run end to end on the port (``librispeech_asr``,
``librispeech_transducer``, ``timit_ctc``, ``gsc_xvector``) and what they
share (``common``)."""
