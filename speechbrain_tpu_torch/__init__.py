"""PyTorch/CUDA port of ``speechbrain_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module paths and class names so each
piece has an obvious counterpart, and it imports nothing from the JAX
package: what it needs is copied here.  Every Pallas kernel on a ported
path becomes a hand-written CUDA C++ kernel (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes`` (``ops/_build.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``;
nothing falls back to the CPU quietly (see ``device.py``).

This slice covers the serving path of the conformer joint CTC/attention
ASR model: ``asr.ConformerASR``.
"""

__all__ = ["asr", "bridge", "device"]
