"""RNN-Transducer loss.

Counterpart of ``speechbrain_tpu/nnet/loss/transducer_loss.py``:

- ``transducer_forward_loss``, the JAX package's scan form: per frame,
  the alpha row's u-recurrence ``x_u = logaddexp(x_{u-1} + emit_{u-1},
  alpha[t-1, u] + blank[t-1, u])`` solved as a prefix scan of affine maps
  in the log semiring, gradients through autograd.  It masks emissions
  past U_b only and reads the final cell at ``clip(T_b - 1, 0, T - 1)``.
- ``TransducerLoss``, which always takes the logits entry of
  ``ops.transducer`` (the kernels K8/K9 on the card, their plain
  versions on the CPU or with ``use_kernels=False``): what the JAX
  package computes on the TPU.

The two differ only on rows with T_b = 0 (the masked replica rows of a
padded batch): the lattice kernels never harvest such a row and give
loss 0 with zero gradient, while the scan gives ``-blank[b, 0, U_b]``.
"""

import torch
import torch.nn.functional as F

from ...ops.transducer import NEG, transducer_loss_logits

__all__ = ["transducer_forward_loss", "TransducerLoss"]


def _logaddexp(a, b):
    """The scan's logaddexp: exact for finite inputs, ``max`` otherwise."""
    m = torch.maximum(a, b)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, 0.0)
    return torch.where(
        fin, m + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)), m)


def _affine_scan(a, b):
    """x_u = logaddexp(x_{u-1} + a_u, b_u) for every u of (B, W) rows:
    Hillis-Steele composition of the maps (a1, b1) then (a2, b2) =
    (a1 + a2, logaddexp(b1 + a2, b2)), identity (0, NEG)."""
    d = 1
    while d < a.shape[1]:
        a_sh = F.pad(a[:, :-d], (d, 0), value=0.0)
        b_sh = F.pad(b[:, :-d], (d, 0), value=NEG)
        a, b = a_sh + a, _logaddexp(b_sh + a, b)
        d *= 2
    return b


def transducer_forward_loss(log_probs, targets, t_lens, u_lens, blank_index,
                            normalize_by_T=False):
    """Negative log-likelihood (B,) of the RNN-T lattice, scan form.

    Arguments
    ---------
    log_probs : (B, T, U+1, V) log-softmax outputs of the joint network
    targets : (B, U) int labels
    t_lens, u_lens : (B,) absolute frame and label counts
    blank_index : int
    normalize_by_T : divide each utterance's NLL by max(T_b, 1).

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 2, 2, 3), -1)
    >>> loss = transducer_forward_loss(lp, torch.tensor([[1]]),
    ...     torch.tensor([2]), torch.tensor([1]), 0)
    >>> round(float(loss[0]), 4)  # -log(2 paths x (1/3)^3)
    2.6027
    """
    lp = log_probs if log_probs.dtype == torch.float64 else log_probs.float()
    B, T, U1, _ = lp.shape
    U = U1 - 1
    dev = lp.device
    t_lens = t_lens.to(dev).long()
    u_lens = u_lens.to(dev).long()
    blank_lp = lp[..., blank_index]
    idx = targets.to(dev).long()[:, None, :, None].expand(-1, T, -1, 1)
    emit_lp = lp[:, :, :U].gather(3, idx)[..., 0]
    u_valid = torch.arange(U, device=dev)[None, :] < u_lens[:, None]
    emit_lp = torch.where(u_valid[:, None, :], emit_lp, NEG)
    zero = torch.zeros(B, 1, dtype=lp.dtype, device=dev)
    init = torch.cat([zero, torch.full((B, U), NEG, dtype=lp.dtype,
                                       device=dev)], 1)
    rows = [_affine_scan(torch.cat([zero, emit_lp[:, 0]], 1), init)]
    for t in range(1, T):
        base = rows[-1] + blank_lp[:, t - 1]
        rows.append(_affine_scan(torch.cat([zero, emit_lp[:, t]], 1), base))
    alphas = torch.stack(rows, 1)
    b = torch.arange(B, device=dev)
    t_idx = (t_lens - 1).clamp(0, T - 1)
    nll = -(alphas[b, t_idx, u_lens] + blank_lp[b, t_idx, u_lens])
    if normalize_by_T:
        nll = nll / t_lens.clamp(min=1)
    return nll


class TransducerLoss:
    """Callable per-utterance RNN-T loss on raw logits (B, T, U+1, V),
    cast to float32, through ``ops.transducer.transducer_loss_logits``.

    Example
    -------
    >>> loss_fn = TransducerLoss(blank_index=0)
    >>> loss = loss_fn(torch.zeros(2, 3, 2, 4), torch.tensor([[1], [2]]),
    ...     torch.tensor([3, 0]), torch.tensor([1, 1]))
    >>> loss.shape, float(loss[1]) == 0.0  # a row with no frames: loss 0
    (torch.Size([2]), True)
    """

    def __init__(self, blank_index, normalize_by_T=False, use_kernels=True):
        self.blank_index = blank_index
        self.normalize_by_T = normalize_by_T
        self.use_kernels = use_kernels

    def __call__(self, logits, targets, t_lens, u_lens):
        return transducer_loss_logits(
            logits.float(), targets, t_lens, u_lens, self.blank_index,
            normalize_by_T=self.normalize_by_T, use_kernels=self.use_kernels)
