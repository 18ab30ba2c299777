"""Sequence losses with the masked relative-length convention.

Counterpart of ``speechbrain_tpu/nnet/losses.py`` (``compute_masked_loss``,
``ctc_loss``, ``nll_loss``, ``kldiv_loss``, ``classification_error``, and
the speaker recipes' ``AngularMargin``, ``AdditiveAngularMargin`` and
``LogSoftmaxWrapper``, and the separation recipes' ``PitWrapper``,
``cal_si_snr``, ``get_si_snr_with_pitwrapper`` and ``get_mask``, and the
TIMIT distillation recipe's ``ctc_loss_kd``, ``nll_loss_kd`` and
``ce_kd``, and wav2vec 2.0's ``ContrastiveLoss``):
lengths are RELATIVE (batch,), padded positions are masked before the
reduction, and the reductions keep the reference's definitions, quirks
included.
``ctc_loss`` runs on ``ops.ctc.ctc_loss_per_seq`` (the CTC kernels on
CUDA tensors), or on its plain recursions with ``use_kernels=False``;
``transducer_loss`` on ``nnet.loss.transducer_loss.TransducerLoss`` (the
RNN-T lattice kernels on CUDA tensors).
"""

import itertools
import math

import torch

from ..ops.ctc import ctc_loss_per_seq, ctc_loss_per_seq_plain
from .loss.transducer_loss import TransducerLoss

__all__ = ["compute_masked_loss", "ctc_loss", "transducer_loss", "nll_loss",
           "kldiv_loss", "classification_error", "AngularMargin",
           "AdditiveAngularMargin", "LogSoftmaxWrapper", "PitWrapper",
           "cal_si_snr", "get_si_snr_with_pitwrapper", "get_mask",
           "ctc_loss_kd", "nll_loss_kd", "ce_kd", "ContrastiveLoss"]


def _sequence_mask(lengths, max_len, dtype):
    abs_len = lengths.to(torch.float32) * max_len
    ar = torch.arange(max_len, device=lengths.device)
    return (ar[None, :] < abs_len[:, None]).to(dtype)


def compute_masked_loss(loss_fn, predictions, targets, length=None,
                        label_smoothing=0.0, reduction="mean"):
    """Apply an elementwise loss, mask the padding, reduce.

    ``loss_fn(predictions, targets)`` returns per-element losses of shape
    (batch, time, ...), summed over trailing axes.  Reductions: ``mean``
    (over unmasked elements), ``batchmean`` (sum / batch), ``batch``
    (per sequence), ``sum``.  With ``label_smoothing`` the result mixes
    in the masked mean of ``-mean(predictions, -1)``.

    Example
    -------
    >>> lp = torch.log(torch.tensor([[[0.5, 0.5], [0.9, 0.1]]]))
    >>> nll = lambda p, t: -p.gather(-1, t[..., None])[..., 0]
    >>> round(float(compute_masked_loss(nll, lp, torch.tensor([[0, 0]]),
    ...     torch.tensor([0.5]))), 4)
    0.6931
    """
    per_elem = loss_fn(predictions, targets)
    while per_elem.dim() > 2:
        per_elem = per_elem.sum(-1)
    B, T = per_elem.shape
    if length is not None:
        mask = _sequence_mask(length, T, per_elem.dtype)
    else:
        mask = torch.ones(B, T, dtype=per_elem.dtype, device=per_elem.device)
    per_elem = per_elem * mask
    if reduction == "mean":
        loss = per_elem.sum() / mask.sum().clamp(min=1.0)
    elif reduction == "batchmean":
        loss = per_elem.sum() / B
    elif reduction == "batch":
        loss = per_elem.sum(1) / mask.sum(1).clamp(min=1.0)
    elif reduction == "sum":
        loss = per_elem.sum()
    else:
        raise ValueError(f"Unknown reduction {reduction}")
    if label_smoothing > 0.0:
        loss_reg = -predictions.mean(-1)
        loss_reg = (loss_reg * mask).sum() / mask.sum().clamp(min=1.0)
        loss = label_smoothing * loss_reg + (1 - label_smoothing) * loss
    return loss


def ctc_loss(log_probs, targets, input_lens, target_lens, blank_index,
             reduction="mean", use_kernels=True):
    """CTC loss on (batch, time, labels) float32 log-probs with relative
    lengths, rounded to frames and labels as ``round(rel * T)``.

    Reductions: ``mean`` (each sequence divided by its label count, then
    the batch mean), ``batchmean``, ``batch`` (per sequence, divided by
    its label count), ``none``, ``sum``.  ``use_kernels=False`` runs the
    plain recursions on any device (to check the kernels on the card).

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 4, 3), -1)
    >>> float(ctc_loss(lp, torch.tensor([[1, 2]]), torch.ones(1),
    ...       torch.ones(1), blank_index=0)) > 0
    True
    """
    B, T, C = log_probs.shape
    U = targets.shape[1]
    input_lengths = torch.round(input_lens.float() * T).to(torch.int32)
    target_lengths = torch.round(target_lens.float() * U).to(torch.int32)
    per_seq_fn = ctc_loss_per_seq if use_kernels else ctc_loss_per_seq_plain
    per_seq = per_seq_fn(log_probs, targets, input_lengths, target_lengths,
                         blank_index)
    if reduction == "mean":
        return (per_seq / target_lengths.clamp(min=1)).mean()
    if reduction == "batchmean":
        return per_seq.mean()
    if reduction == "batch":
        return per_seq / target_lengths.clamp(min=1)
    if reduction == "none":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    raise ValueError(f"Unknown reduction {reduction}")


def transducer_loss(logits, targets, input_lens, target_lens, blank_index,
                    reduction="mean", use_kernels=True):
    """RNN-T loss on (batch, time, labels + 1, vocab) logits with relative
    lengths, rounded to frames and labels as ``round(rel * T)`` and
    ``round(rel * U)`` (half to even, as ``jnp.round``).

    Reductions over the per-utterance losses: ``mean``, ``batch`` (none),
    ``sum``.  ``use_kernels=False`` runs the plain recursions on any
    device (to check the kernels on the card).

    Example
    -------
    >>> loss = transducer_loss(torch.zeros(1, 2, 2, 3), torch.tensor([[1]]),
    ...     torch.ones(1), torch.ones(1), blank_index=0)
    >>> round(float(loss), 4)
    2.6027
    """
    T = logits.shape[1]
    U = targets.shape[1]
    abs_t = torch.round(input_lens.float() * T).to(torch.int32)
    abs_u = torch.round(target_lens.float() * U).to(torch.int32)
    loss = TransducerLoss(blank_index, use_kernels=use_kernels)(
        logits, targets, abs_t, abs_u)
    if reduction == "mean":
        return loss.mean()
    if reduction == "batch":
        return loss
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Unknown reduction {reduction}")


def nll_loss(log_probabilities, targets, length=None, label_smoothing=0.0,
             reduction="mean"):
    """Negative log-likelihood of (B, T, C) log-probs at (B, T) ints.

    Example
    -------
    >>> lp = torch.log(torch.tensor([[[0.9, 0.1]]]))
    >>> round(float(nll_loss(lp, torch.tensor([[0]]))), 4)
    0.1054
    """
    if log_probabilities.dim() == 2:
        log_probabilities = log_probabilities[:, None, :]
        targets = targets.reshape(targets.shape[0], 1)

    def fn(pred, tgt):
        return -pred.gather(-1, tgt.long()[..., None])[..., 0]

    return compute_masked_loss(fn, log_probabilities, targets, length,
                               label_smoothing, reduction)


def kldiv_loss(log_probabilities, targets, length=None, label_smoothing=0.0,
               pad_idx=0, reduction="mean"):
    """KL divergence to the label-smoothed one-hot of int targets.

    The target distribution puts ``1 - label_smoothing`` on the target
    and ``label_smoothing / (C - 1)`` on every other class; positions
    whose target is ``pad_idx`` and positions past ``length`` are masked.
    Reductions keep the reference's: ``mean`` is a GLOBAL SUM (the
    reference's ``loss.sum().mean()``), ``batchmean`` that sum over the
    batch size, ``batch`` each row's sum over its relative length.
    Without smoothing it is ``nll_loss``.

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 2, 4), -1)
    >>> round(float(kldiv_loss(lp, torch.tensor([[1, 0]]),
    ...     label_smoothing=0.1, reduction="batchmean")), 4)
    0.9514
    """
    if label_smoothing <= 0:
        return nll_loss(log_probabilities, targets, length,
                        reduction=reduction)
    if log_probabilities.dim() == 2:
        log_probabilities = log_probabilities[:, None, :]
    C = log_probabilities.shape[-1]
    confidence = 1.0 - label_smoothing
    fill = label_smoothing / (C - 1)
    targets = targets.long()
    # sum_c p_c (log p_c - log q_c), with p = fill except at the target;
    # 0 log 0 = 0: the target's term drops at label_smoothing = 1 (fill > 0
    # on this branch)
    log_q_t = log_probabilities.gather(-1, targets[..., None])[..., 0]
    per = fill * ((C - 1) * math.log(fill)
                  - (log_probabilities.sum(-1) - log_q_t))
    if confidence > 0:
        per = per + confidence * (math.log(confidence) - log_q_t)
    per = per * (targets != pad_idx).to(per.dtype)
    if length is not None:
        per = per * _sequence_mask(length, per.shape[1], per.dtype)
    B = per.shape[0]
    if reduction in ("mean", "sum"):
        return per.sum()
    if reduction == "batchmean":
        return per.sum() / B
    if reduction == "batch":
        return per.reshape(B, -1).sum(1) / length
    return per


def classification_error(probabilities, targets, length=None,
                         reduction="mean"):
    """The share of positions whose argmax is not the target, masked by
    ``length`` and reduced as ``compute_masked_loss`` reduces; (B, C)
    inputs are one position a row.

    Example
    -------
    >>> p = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]])
    >>> float(classification_error(p, torch.tensor([0, 0, 0])))
    0.3333333432674408
    """
    if probabilities.dim() == 2:
        probabilities = probabilities[:, None, :]
        targets = targets.reshape(targets.shape[0], 1)

    def fn(pred, tgt):
        return (pred.argmax(-1) != tgt).to(torch.float32)

    return compute_masked_loss(fn, probabilities, targets, length,
                               reduction=reduction)


class AngularMargin:
    """Margin-scaled logits of cosines: ``scale * (outputs - margin *
    targets)``, ``targets`` one-hot.

    Example
    -------
    >>> AngularMargin(0.2, 30)(torch.tensor([[0.5, 0.5]]),
    ...                        torch.tensor([[1.0, 0.0]])).tolist()
    [[9.0, 15.0]]
    """

    def __init__(self, margin=0.0, scale=1.0):
        self.margin = margin
        self.scale = scale

    def __call__(self, outputs, targets):
        return self.scale * (outputs - self.margin * targets)


class AdditiveAngularMargin(AngularMargin):
    """ArcFace's additive angular margin: the target class's cosine
    becomes ``cos(theta + margin)``, computed as ``cos cos_m - sin sin_m``
    with ``sin = sqrt(clip(1 - cos^2, 0, 1))``; where ``cos <= th``
    (``cos(pi - margin)``) it is ``cos - mm`` instead (``cos > 0`` and
    the cosine itself with ``easy_margin``).  The other classes keep
    their cosine; all are scaled by ``scale``.

    Example
    -------
    >>> aam = AdditiveAngularMargin(margin=0.2, scale=30)
    >>> out = aam(torch.tensor([[0.5, -0.5]]), torch.tensor([[1.0, 0.0]]))
    >>> [round(v, 3) for v in out[0].tolist()]
    [9.539, -15.0]
    """

    def __init__(self, margin=0.0, scale=1.0, easy_margin=False):
        super().__init__(margin, scale)
        self.easy_margin = easy_margin
        self.cos_m = math.cos(margin)
        self.sin_m = math.sin(margin)
        self.th = math.cos(math.pi - margin)
        self.mm = math.sin(math.pi - margin) * margin

    def __call__(self, outputs, targets):
        cosine = outputs
        targets = targets.to(cosine.dtype)
        sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
        phi = cosine * self.cos_m - sine * self.sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine > self.th, phi, cosine - self.mm)
        return self.scale * (targets * phi + (1.0 - targets) * cosine)


class LogSoftmaxWrapper:
    """A margin function as a classification loss: the mean over the
    batch of the NLL of ``log_softmax(loss_fn(outputs, one_hot))`` at
    the targets.  ``outputs`` (B, C) or (B, 1, C); ``targets`` (B,) or
    (B, 1) ints.  ``length`` is accepted and ignored, as in JAX.

    Example
    -------
    >>> wrapper = LogSoftmaxWrapper(AdditiveAngularMargin(0.2, 30))
    >>> float(wrapper(torch.tensor([[[0.9, -0.9]]]), torch.tensor([[0]]))) < 1.0
    True
    """

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def __call__(self, outputs, targets, length=None):
        if outputs.dim() == 3:
            outputs = outputs[:, 0, :]
        one_hot = torch.nn.functional.one_hot(
            targets.reshape(-1).long(), outputs.shape[-1]).to(outputs.dtype)
        log_p = torch.log_softmax(self.loss_fn(outputs, one_hot), -1)
        return -(one_hot * log_p).sum(-1).mean()


# ---------------------------------------------------------------------------
# Source-separation losses


class PitWrapper:
    """Permutation-invariant training: ``base_loss`` (no reduction; time
    first, as ``cal_si_snr``) is evaluated once on the all-pairs
    broadcast of each example, ``pred[..., j]`` against ``target[..., i]``
    at entry (i, j); that matrix is averaged over every axis but the
    pair, each permutation scores the mean of its entries, and the lowest
    score wins (the first in ``itertools.permutations`` order on ties).

    ``__call__(preds, targets)`` takes (B, ..., n) tensors and returns
    ``(loss (B,), perms (B, n) int64)``; ``perms[b]`` reorders the last
    axis of the predictions into target order (``reorder_tensor``).  The
    batch runs as one broadcast, with the batch axis just before the
    pair (``base_loss`` keeps every axis but the first).  No host sync.

    Example
    -------
    >>> pit = PitWrapper(lambda p, t: (p - t) ** 2)
    >>> tgts = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])  # (1, 2, 2)
    >>> loss, perms = pit(tgts.flip(-1), tgts)
    >>> float(loss.sum()), perms.tolist()
    (0.0, [[1, 0]])
    """

    def __init__(self, base_loss):
        self.base_loss = base_loss
        self._perms = {}

    def _permutations(self, n, device):
        key = (n, str(device))
        if key not in self._perms:
            self._perms[key] = torch.tensor(
                list(itertools.permutations(range(n))), device=device)
        return self._perms[key]

    def _loss_mat(self, preds, targets):
        """(B, n, n): entry (b, i, j) is ``base_loss(pred[b, ..., j],
        target[b, ..., i])`` averaged over the other axes."""
        n = preds.shape[-1]
        B = preds.shape[0]
        # (..., B, n) with the batch just before the sources
        p = preds.movedim(0, -2)
        t = targets.movedim(0, -2)
        pred_b = p[..., None, :].expand(*p.shape[:-1], n, n)
        tgt_b = t[..., :, None].expand(*t.shape[:-1], n, n)
        mat = self.base_loss(pred_b, tgt_b)  # (..., B, n, n)
        return mat.movedim(-3, 0).reshape(B, -1, n, n).mean(1)

    def __call__(self, preds, targets):
        n = preds.shape[-1]
        perms = self._permutations(n, preds.device)  # (n!, n)
        mat = self._loss_mat(preds, targets)
        rows = torch.arange(n, device=preds.device)[None, :]
        scores = mat[:, rows, perms].mean(-1)  # (B, n!)
        best = scores.argmin(-1)
        return scores.gather(1, best[:, None])[:, 0], perms[best]

    def reorder_tensor(self, tensor, p):
        """``tensor``'s last (source) axis reordered per example by the
        permutations ``p`` (B, n) from ``__call__``."""
        p = torch.as_tensor(p, device=tensor.device)
        idx = p.reshape(p.shape[0:1] + (1,) * (tensor.dim() - 2) + p.shape[1:2])
        return torch.gather(tensor, -1, idx.expand(*tensor.shape[:-1],
                                                   p.shape[1]))


def cal_si_snr(source, estimate_source):
    """Negative scale-invariant SNR in dB over the leading (time) axis:
    (T, ...) inputs -> (1, ...); zero-mean signals, eps 1e-8 on both
    energies and inside the log, as in JAX.

    Example
    -------
    >>> x = torch.tensor([[1.0, 0], [123, 45], [34, 5], [2312, 421]])
    >>> xhat = x[:, (1, 0)]
    >>> x = x[:, :, None].repeat(1, 1, 2)
    >>> xhat = xhat[:, None, :].repeat(1, 2, 1)
    >>> round(float(-cal_si_snr(x, xhat)[0, 0, 0]), 4)
    25.2142
    """
    eps = 1e-8
    s = source - source.mean(0, keepdim=True)
    s_hat = estimate_source - estimate_source.mean(0, keepdim=True)
    dot = (s_hat * s).sum(0, keepdim=True)
    s_energy = (s ** 2).sum(0, keepdim=True) + eps
    proj = dot * s / s_energy
    e_noise = s_hat - proj
    ratio = (proj ** 2).sum(0) / ((e_noise ** 2).sum(0) + eps)
    return -(10 * torch.log10(ratio + eps))[None]


def get_si_snr_with_pitwrapper(source, estimate_source):
    """The permutation-invariant negative SI-SNR of each example: (B, T,
    n) targets and estimates -> (B,).  The targets go in
    ``PitWrapper``'s ``preds`` place, as in JAX (``cal_si_snr`` is
    symmetric in the permutation search, not in its value)."""
    return PitWrapper(cal_si_snr)(source, estimate_source)[0]


def get_mask(source, source_lengths):
    """A mask over the leading (time) axis: ``source`` (T, B, C) or
    (T, E, B, C), ``source_lengths`` (B,) absolute -> ones where
    ``t < length``, shaped (T, B, 1) or (T, 1, B, 1) broadcast to
    ``source``'s rank with a trailing singleton channel.

    Example
    -------
    >>> get_mask(torch.ones(4, 3, 2), torch.tensor([2, 1, 4]))[:, :, 0].T.tolist()
    [[1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]]
    """
    T, B = source.shape[0], source.shape[-2]
    t = torch.arange(T, device=source.device)
    mask = (t[:, None] < source_lengths[None, :B].to(source.device)).to(
        source.dtype)
    return mask.reshape((T,) + (1,) * (source.dim() - 3) + (B, 1))


def ctc_loss_kd(log_probs, targets, input_lens, blank_index,
                use_kernels=True):
    """CTC of the student's ``log_probs`` (B, T, C) against the teacher's
    greedy path, read from its posteriors ``targets`` (B, T, C), as JAX's
    ``ctc_loss_kd`` builds it: the argmax path (the first maximum where
    classes tie) with repeats merged, blanks dropped and frames at or past
    ``round(input_lens * T)`` dropped, the kept labels moved in order to
    the front of a (B, T) buffer padded with the blank (a stable sort of
    the frames, tensor operations only: no host sync), ``max(kept, 1)``
    labels a row (an empty path is one label equal to the blank), and
    the label lengths given to ``ctc_loss`` relative to T.  ``mean``
    reduction; K3/K4 on CUDA tensors (the path may take up to 2T + 1
    lattice states: the kernels' block path past 257).

    Example
    -------
    >>> teacher = torch.eye(3)[torch.tensor([[1, 1, 0, 2, 2, 0]])]
    >>> student = torch.log_softmax(torch.zeros(1, 6, 3), -1)
    >>> float(ctc_loss_kd(student, teacher, torch.ones(1), 0)) > 0
    True
    """
    t_preds = targets.argmax(-1)
    B, T = t_preds.shape
    dev = t_preds.device
    prev = torch.cat([torch.full((B, 1), -1, dtype=t_preds.dtype,
                                 device=dev), t_preds[:, :-1]], 1)
    abs_in = torch.round(input_lens.to(torch.float32) * T)
    frames = torch.arange(T, device=dev)
    keep = ((t_preds != prev) & (t_preds != blank_index)
            & (frames[None, :] < abs_in[:, None]))
    order = torch.argsort(torch.where(keep, frames[None, :], T), dim=1,
                          stable=True)
    tgt = torch.where(keep, t_preds, blank_index).gather(1, order)
    lens = keep.sum(1).clamp(min=1)
    return ctc_loss(log_probs, tgt, input_lens, lens.to(torch.float32) / T,
                    blank_index, use_kernels=use_kernels)


def nll_loss_kd(probabilities, targets, rel_lab_lengths):
    """Sequence distillation as JAX's ``nll_loss_kd``: per position
    ``-(targets * probabilities).sum(-1)`` (the recipes pass the
    student's log-probabilities and the teacher's probabilities: the
    cross-entropy), summed over the positions ``< round(rel * U)`` of
    every row and divided by their count over the whole batch (at least
    1), not averaged row by row.

    Example
    -------
    >>> lp = torch.log(torch.full((2, 3, 2), 0.5))
    >>> round(float(nll_loss_kd(lp, torch.ones(2, 3, 2) / 2,
    ...                         torch.tensor([1.0, 1 / 3]))), 4)
    0.6931
    """
    B, U = probabilities.shape[:2]
    abs_len = torch.round(rel_lab_lengths.to(torch.float32) * U)
    mask = (torch.arange(U, device=probabilities.device)[None, :]
            < abs_len[:, None]).to(probabilities.dtype)
    per = -(targets * probabilities).sum(-1)
    return (per * mask).sum() / mask.sum().clamp(min=1.0)


def ce_kd(inp, target):
    """Distillation cross-entropy of flattened rows: ``(-target *
    inp).sum(1)`` (student log-probs ``inp``, teacher probs ``target``).

    Example
    -------
    >>> round(float(ce_kd(torch.log(torch.tensor([[0.5, 0.5]])),
    ...                   torch.tensor([[1.0, 0.0]]))[0]), 4)
    0.6931
    """
    return (-target * inp).sum(1)


class ContrastiveLoss:
    """wav2vec 2.0's contrastive loss (InfoNCE over sampled negatives), as
    the JAX package computes it: the cosine of each encoded frame with its
    candidates [positive; negatives], the product of the norms plus 1e-8
    below (not ``F.cosine_similarity``'s eps), over ``logit_temp``; a
    log-softmax over the candidates and the mean of -log p(positive) over
    every (B, T) frame, masked or not.

    Example
    -------
    >>> enc = torch.ones(1, 3, 4)
    >>> loss = ContrastiveLoss(0.1)(enc, enc, -torch.ones(2, 1, 3, 4))
    >>> float(loss) < 1e-6
    True
    """

    def __init__(self, logit_temp=0.1):
        self.logit_temp = logit_temp

    def __call__(self, encoded, quantized, negatives):
        """encoded, quantized (B, T, C); negatives (N, B, T, C)."""
        candidates = torch.cat([quantized[None], negatives], 0)
        dots = torch.einsum("btc,nbtc->nbt", encoded, candidates)
        norms = (torch.linalg.vector_norm(encoded, dim=-1)[None]
                 * torch.linalg.vector_norm(candidates, dim=-1) + 1e-8)
        logits = dots / norms / self.logit_temp
        return -torch.log_softmax(logits, 0)[0].mean()
