"""Recipes that run end to end on the port (``librispeech_asr``,
``librispeech_transducer``, ``timit_ctc``, ``gsc_xvector``,
``voxceleb_speaker`` with ``voxceleb_prepare``) and what they share
(``common``)."""
