"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version and a launch counter (``<wrapper>.launches``).

``depthwise_conv`` (conformer convolution module: forward and dx, and
the taps' gradient), ``relpos_attention`` (long-utterance encoder
attention, forward and backward), ``ctc`` (CTC loss: alpha, and beta
with the gradient), ``beam_cache`` (beam-search decoder self-attention
step) and ``transducer`` (RNN-T loss: alpha, and beta with the
occupancy gradients).  ``_build`` compiles ``csrc/*.cu``.
"""

from .beam_cache import append_attend, beam_attend_step, beam_attend_step_plain
from .ctc import (
    ctc_alpha,
    ctc_alpha_plain,
    ctc_beta_grad,
    ctc_beta_grad_plain,
    ctc_loss_per_seq,
    ctc_loss_per_seq_plain,
)
from .depthwise_conv import (
    depthwise_conv1d,
    depthwise_conv1d_dw,
    depthwise_conv1d_dw_plain,
    depthwise_conv1d_plain,
)
from .relpos_attention import (
    relpos_attention,
    relpos_attention_bwd,
    relpos_attention_bwd_plain,
    relpos_attention_plain,
    relpos_dropout_keep,
)
from .transducer import (
    transducer_alpha,
    transducer_alpha_plain,
    transducer_beta_grad,
    transducer_beta_grad_plain,
    transducer_loss_logits,
    transducer_loss_per_seq,
)

__all__ = [
    "append_attend",
    "beam_attend_step",
    "beam_attend_step_plain",
    "ctc_alpha",
    "ctc_alpha_plain",
    "ctc_beta_grad",
    "ctc_beta_grad_plain",
    "ctc_loss_per_seq",
    "ctc_loss_per_seq_plain",
    "depthwise_conv1d",
    "depthwise_conv1d_dw",
    "depthwise_conv1d_dw_plain",
    "depthwise_conv1d_plain",
    "relpos_attention",
    "relpos_attention_bwd",
    "relpos_attention_bwd_plain",
    "relpos_attention_plain",
    "relpos_dropout_keep",
    "transducer_alpha",
    "transducer_alpha_plain",
    "transducer_beta_grad",
    "transducer_beta_grad_plain",
    "transducer_loss_logits",
    "transducer_loss_per_seq",
    "launch_counters",
    "reset_launch_counters",
]

# every kernel wrapper, in the order of the repository's kernel table
_WRAPPERS = (depthwise_conv1d, depthwise_conv1d_dw, ctc_alpha, ctc_beta_grad,
             relpos_attention, relpos_attention_bwd, beam_attend_step,
             transducer_alpha, transducer_beta_grad)


def launch_counters():
    """``{wrapper name: kernel launches}`` for every kernel wrapper."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counters():
    """Set every kernel wrapper's launch count to 0."""
    for f in _WRAPPERS:
        f.launches = 0
