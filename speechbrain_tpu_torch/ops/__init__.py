"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version and a launch counter (``<wrapper>.launches``).

``depthwise_conv`` (conformer convolution module), ``relpos_attention``
(long-utterance encoder attention) and ``beam_cache`` (beam-search
decoder self-attention step).  ``_build`` compiles ``csrc/*.cu``.
"""

from .beam_cache import append_attend, beam_attend_step, beam_attend_step_plain
from .depthwise_conv import depthwise_conv1d, depthwise_conv1d_plain
from .relpos_attention import relpos_attention, relpos_attention_plain

__all__ = [
    "append_attend",
    "beam_attend_step",
    "beam_attend_step_plain",
    "depthwise_conv1d",
    "depthwise_conv1d_plain",
    "relpos_attention",
    "relpos_attention_plain",
    "launch_counters",
    "reset_launch_counters",
]

_WRAPPERS = (depthwise_conv1d, relpos_attention, beam_attend_step)


def launch_counters():
    """``{wrapper name: kernel launches}`` for every kernel wrapper."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counters():
    """Set every kernel wrapper's launch count to 0."""
    for f in _WRAPPERS:
        f.launches = 0
