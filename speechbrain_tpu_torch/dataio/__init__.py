"""Data I/O: the Kaldi-style WER report."""
