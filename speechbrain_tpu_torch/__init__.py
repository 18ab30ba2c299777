"""PyTorch/CUDA port of ``speechbrain_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module paths and class names so each
piece has an obvious counterpart, and it imports nothing from the JAX
package: what it needs is copied here.  Every Pallas kernel on a ported
path becomes a hand-written CUDA C++ kernel (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes`` (``ops/_build.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``;
nothing falls back to the CPU quietly (see ``device.py``).

The port covers the conformer joint CTC/attention ASR model: serving
(``asr.ConformerASR``), training (``asr.ConformerASRBrain`` on
``core.Brain``, with ``fit``/``evaluate``, checkpoints and resume) and
the LibriSpeech recipe end to end (``recipes.librispeech_asr``: audio
files on disk through ``dataio``, the ``tokenizers.SentencePiece``
tokenizer, whose trainer and encoder and the FLAC decoder are native
C++ host code in ``native/``); and the conformer-transducer's training
step and decoding (``asr.ConformerTransducerBrain``, the RNN-T loss in
``ops.transducer``).
"""

__all__ = ["asr", "bridge", "core", "device"]
