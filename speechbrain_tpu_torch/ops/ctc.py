"""CTC loss on the extended label lattice (log semiring), with its
analytic gradient.

Counterpart of ``speechbrain_tpu/ops/pallas/ctc.py``: blank-separated
states ``blank, y1, blank, ..., yU, blank`` (S = 2U+1), the skip rule
(a label state may be entered from two states back when its label
differs from that state's), the fill -1e30 and the ``logaddexp`` form
``max + log1p(exp(min - max))`` of the JAX kernel, the loss
``-logsumexp`` of the two end states at t = T_b - 1 (with T_b = 0, a
batch's dummy row: 0 when U_b = 0, as ``optax.ctc_loss`` gives, the
JAX package's CTC off the TPU), and the gradient
``d loss / d log_probs = -exp(alpha + beta - logZ)`` summed per class,
zero from t = T_b on.

``ctc_loss_per_seq`` is an autograd Function.  On CUDA tensors its
forward launches ``ctc_alpha`` (K3, ``sb_ctc_alpha``) and its backward
``ctc_beta_grad`` (K4, ``sb_ctc_beta_grad``), both in ``csrc/ctc.cu``:
one device kernel each up to ``WARP_STATES`` lattice states (a warp per
sequence; K4 also writes the dense gradient's zeros from the same
launch), a block per sequence past it; on CPU tensors it runs
``ctc_alpha_plain`` and ``ctc_beta_grad_plain``, the explicit
recursions over t.  The gradient is the JAX kernel's
(w.r.t. the log-probabilities); ``F.ctc_loss`` returns one w.r.t. the
logits instead, and the two agree through a ``log_softmax``.
"""

import torch

from . import _build

__all__ = [
    "ctc_loss_per_seq",
    "ctc_loss_per_seq_plain",
    "ctc_alpha",
    "ctc_alpha_plain",
    "ctc_beta_grad",
    "ctc_beta_grad_plain",
]

NEG = -1.0e30
# widest lattice the kernels take: 2U+1 states need (2 + frames) (2U+1)
# floats of a block's 227 KB of shared memory, at least one frame
MAX_STATES = 19370
# lattices the warp kernels take (csrc/ctc.cu WARP_STATES and
# WARP_MAX_CLASSES); K4 needs its occ scratch only past them
WARP_STATES = 257
WARP_MAX_CLASSES = 1 << 18


def _lae(x, y):
    """log(exp(x) + exp(y)) in the JAX kernel's form, safe at NEG."""
    m = torch.maximum(x, y)
    return m + torch.log1p(torch.exp(torch.minimum(x, y) - m))


def _lattice(log_probs, targets, blank):
    """Extended labels (B, S), the skip mask (B, S) and the gathered
    lattice log-probs (B, T, S): float64 for float64 log-probs, else
    float32."""
    B, T, C = log_probs.shape
    U = targets.shape[1]
    s = torch.arange(2 * U + 1, device=log_probs.device)
    lab_pos = ((s - 1) // 2).clamp(min=0)
    tg = targets.long().clamp(0, C - 1)  # padding past U_b may hold anything
    if U == 0:  # no label column to index: the lattice is one blank state
        tg = torch.zeros(B, 1, dtype=torch.long, device=log_probs.device)
    labels = torch.where(s % 2 == 1, tg[:, lab_pos], blank)
    prev2 = torch.roll(labels, 2, dims=1)
    skip = (s % 2 == 1) & (s >= 2) & (labels != prev2)
    if log_probs.dtype != torch.float64:
        log_probs = log_probs.float()
    lat = log_probs.gather(2, labels[:, None, :].expand(B, T, -1))
    return labels, skip, lat


def _shift(x, k):
    """x[..., s - k] (k > 0) or x[..., s + |k|] (k < 0), NEG-filled."""
    out = torch.full_like(x, NEG)
    if k > 0:
        out[..., k:] = x[..., :-k]
    else:
        out[..., :k] = x[..., -k:]
    return out


def ctc_alpha_plain(log_probs, targets, input_lengths, target_lengths,
                    blank=0):
    """Plain version of K3: the alpha recursion over every frame.

    log_probs (B, T, C); targets (B, U) ints; lengths (B,) ints.
    Returns ``(alpha (B, T, S), loss (B,), logz (B,))``, float32 (float64
    for float64 log-probs: the recursion keeps their dtype).

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 3, 3), -1)
    >>> alpha, loss, _ = ctc_alpha_plain(lp, torch.tensor([[1]]),
    ...     torch.tensor([3]), torch.tensor([1]))
    >>> round(float(loss[0]), 4)  # -log(6/27): 6 of the 27 paths give "1"
    1.5041
    """
    B, T, _ = log_probs.shape
    _, skip, lat = _lattice(log_probs, targets, blank)
    S = lat.shape[-1]
    s = torch.arange(S, device=lat.device)
    a = torch.where(s <= 1, lat[:, 0], torch.full_like(lat[:, 0], NEG))
    rows = [a]
    for t in range(1, T):
        a2 = torch.where(skip, _shift(a, 2), torch.full_like(a, NEG))
        a = _lae(_lae(a, _shift(a, 1)), a2) + lat[:, t]
        rows.append(a)
    alpha = torch.stack(rows, 1)
    tb = input_lengths.long().clamp(0, T)
    sb = 2 * target_lengths.long().clamp(0, targets.shape[1]) + 1
    last = alpha[torch.arange(B, device=lat.device), (tb - 1).clamp(min=0)]
    a1 = last.gather(1, (sb - 1)[:, None])[:, 0]
    a2 = last.gather(1, (sb - 2).clamp(min=0)[:, None])[:, 0]
    a2 = torch.where(sb >= 2, a2, torch.full_like(a2, NEG))
    # no frame (a batch's dummy row): only the empty path, when ub = 0
    empty = torch.where(sb == 1, 0.0, NEG).to(a1.dtype)
    logz = torch.where(tb == 0, empty, _lae(a1, a2))
    return alpha, -logz, logz


def ctc_beta_grad_plain(log_probs, targets, input_lengths, target_lengths,
                        blank, alpha, logz, g):
    """Plain version of K4: the beta recursion and the gradient
    ``g[b] * d loss[b] / d log_probs`` (B, T, C), scattered onto the
    classes (states sharing a class add up); float32, or float64 for
    float64 log-probs.

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 3, 3), -1)
    >>> args = (lp, torch.tensor([[1]]), torch.tensor([3]), torch.tensor([1]))
    >>> alpha, _, logz = ctc_alpha_plain(*args)
    >>> d = ctc_beta_grad_plain(*args, 0, alpha, logz, torch.ones(1))
    >>> [round(float(x), 4) for x in d[0].sum(-1)]  # -1 per frame
    [-1.0, -1.0, -1.0]
    """
    B, T, C = log_probs.shape
    labels, skip, lat = _lattice(log_probs, targets, blank)
    S = lat.shape[-1]
    s = torch.arange(S, device=lat.device)
    tb = input_lengths.long().clamp(0, T)[:, None]
    sb = 2 * target_lengths.long().clamp(0, targets.shape[1])[:, None] + 1
    dt = lat.dtype
    final = torch.where((s == sb - 1) | ((s == sb - 2) & (sb >= 2)), 0.0,
                        NEG).to(dt)
    beta = torch.full((B, S), NEG, dtype=dt, device=lat.device)
    occ = torch.zeros(B, T, S, dtype=dt, device=lat.device)
    for t in range(T - 1, -1, -1):
        contrib = lat[:, min(t + 1, T - 1)] + beta
        c2 = torch.where(skip, contrib, torch.full_like(contrib, NEG))
        rec = _lae(_lae(contrib, _shift(contrib, -1)), _shift(c2, -2))
        beta = torch.where(t == tb - 1, final, rec)
        post = alpha[:, t] + beta - logz[:, None]
        occ[:, t] = torch.where(t < tb, -torch.exp(post), 0.0)
    occ = occ * g.to(dt)[:, None, None]
    dlp = torch.zeros(B, T, C, dtype=dt, device=lat.device)
    return dlp.scatter_add_(2, labels[:, None, :].expand(B, T, S), occ)


def _index_operand(t, device):
    """An int32 or int64 index tensor on ``device``, contiguous: the
    caller's tensor where it is one already (the kernels read both
    widths and clamp the lengths themselves)."""
    t = t.to(device)
    if t.dtype not in (torch.int32, torch.int64):
        t = t.long()
    return t.contiguous()


def _index_operands(targets, input_lengths, target_lengths, device):
    """The three index operands and the kernels' int64 flags (bit 0
    targets, bit 1 input lengths, bit 2 target lengths)."""
    ops = [_index_operand(t, device)
           for t in (targets, input_lengths, target_lengths)]
    flags = sum(1 << i for i, t in enumerate(ops) if t.dtype == torch.int64)
    return ops, flags


def _check(log_probs, targets, blank, name):
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise TypeError(f"{name}: log_probs must be (B, T, C) float32")
    if not 0 <= blank < log_probs.shape[2]:
        raise ValueError(f"{name}: blank {blank} outside [0, C)")
    if targets.dim() != 2 or targets.shape[0] != log_probs.shape[0]:
        raise ValueError(f"{name}: targets must be (B, U)")
    if 2 * targets.shape[1] + 1 > MAX_STATES:
        raise ValueError(f"{name}: 2U+1 must be <= {MAX_STATES} (shared "
                         "memory of one block)")


_LOG1P_CHECK = _build.Entry("ctc", "sb_ctc_log1p_check", [_build.P] * 2)
_ALPHA = _build.Entry("ctc", "sb_ctc_alpha",
                      [_build.P] * 4 + [_build.I] + [_build.P] * 3
                      + [_build.I] * 5 + [_build.P])
_BETA_GRAD = _build.Entry("ctc", "sb_ctc_beta_grad",
                          [_build.P] * 4 + [_build.I] + [_build.P] * 3
                          + [_build.I64] + [_build.P] * 2 + [_build.I] * 5
                          + [_build.P])


def _log1p_unit_mismatches(device):
    """The floats x in [0, 1] where the kernels' branch-free log1p and
    CUDA's log1pf differ in any bit, counted on ``device`` (a card):
    the kernels' lae holds JAX's numerics only while this is 0."""
    count = torch.zeros(1, dtype=torch.int32, device=device)
    _build.check_launch(_LOG1P_CHECK(count.data_ptr(), _build.stream_of(count)),
                        "log1p check")
    return int(count)


def ctc_alpha(log_probs, targets, input_lengths, target_lengths, blank=0):
    """K3: ``(alpha (B, T, S), loss (B,), logz (B,))`` float32.

    On CUDA, alpha is written only where the lattice is live (t < T_b
    or t = 0, s < 2 U_b + 1); the rest of it is left unset, and 2U+1 may
    be up to ``MAX_STATES`` (19370: the lattice rows a block's shared
    memory holds); wider raises.  Targets and lengths are read as they
    come, int32 or int64, and the lengths are clamped in the kernel: one
    device kernel a call.  On the CPU the plain version runs, with no
    limit.  Counts launches in ``ctc_alpha.launches``.
    """
    if log_probs.device.type == "cpu":
        return ctc_alpha_plain(log_probs, targets, input_lengths,
                               target_lengths, blank)
    if log_probs.device.type != "cuda":
        raise RuntimeError(f"ctc_alpha: unsupported device {log_probs.device}")
    _check(log_probs, targets, blank, "ctc_alpha")
    _build.refuse_grad("ctc_alpha", log_probs)
    lp = log_probs.contiguous()
    dev = lp.device
    B, T, C = lp.shape
    U = targets.shape[1]
    (tg, tlen, ulen), idx64 = _index_operands(targets, input_lengths,
                                              target_lengths, dev)
    alpha = torch.empty(B, T, 2 * U + 1, dtype=torch.float32, device=dev)
    loss = torch.empty(B, dtype=torch.float32, device=dev)
    logz = torch.empty(B, dtype=torch.float32, device=dev)
    rc = _ALPHA(lp.data_ptr(), tg.data_ptr(), tlen.data_ptr(), ulen.data_ptr(),
                idx64, alpha.data_ptr(), loss.data_ptr(), logz.data_ptr(),
                B, T, C, U, int(blank), _build.stream_of(lp))
    _build.check_launch(rc, "ctc_alpha")
    ctc_alpha.launches += 1
    return alpha, loss, logz


def ctc_beta_grad(log_probs, targets, input_lengths, target_lengths, blank,
                  alpha, logz, g):
    """K4: ``g[b] * d loss[b] / d log_probs`` (B, T, C) float32, from
    ``ctc_alpha``'s alpha and logz; the plain version on the CPU.  On
    CUDA 2U+1 <= ``MAX_STATES``, as for ``ctc_alpha``; up to
    ``WARP_STATES`` one device kernel a call (targets and lengths as for
    ``ctc_alpha``; ``g`` read through its stride, so the expanded
    gradient of a ``sum`` is not copied), wider two and an occ scratch.
    Counts launches in ``ctc_beta_grad.launches``.
    """
    if log_probs.device.type == "cpu":
        return ctc_beta_grad_plain(log_probs, targets, input_lengths,
                                   target_lengths, blank, alpha, logz, g)
    if log_probs.device.type != "cuda":
        raise RuntimeError(
            f"ctc_beta_grad: unsupported device {log_probs.device}")
    _check(log_probs, targets, blank, "ctc_beta_grad")
    _build.refuse_grad("ctc_beta_grad", log_probs, alpha, logz, g)
    lp = log_probs.contiguous()
    dev = lp.device
    B, T, C = lp.shape
    U = targets.shape[1]
    S = 2 * U + 1
    if alpha.shape != (B, T, S) or not alpha.is_contiguous():
        raise ValueError("ctc_beta_grad: alpha must be contiguous (B, T, 2U+1)")
    if logz.shape != (B,) or g.shape != (B,):
        raise ValueError("ctc_beta_grad: logz and g must be (B,)")
    (tg, tlen, ulen), idx64 = _index_operands(targets, input_lengths,
                                              target_lengths, dev)
    logz = logz.to(device=dev, dtype=torch.float32).contiguous()
    g = g.to(device=dev, dtype=torch.float32)
    # the block path's per-state scratch (the warp path needs none)
    occ = (None if S <= WARP_STATES and C <= WARP_MAX_CLASSES
           else torch.empty_like(alpha))
    dlp = torch.empty(B, T, C, dtype=torch.float32, device=dev)
    rc = _BETA_GRAD(lp.data_ptr(), tg.data_ptr(), tlen.data_ptr(), ulen.data_ptr(),
                    idx64, alpha.data_ptr(), logz.data_ptr(), g.data_ptr(),
                    g.stride(0), None if occ is None else occ.data_ptr(),
                    dlp.data_ptr(), B, T, C, U, int(blank), _build.stream_of(lp))
    _build.check_launch(rc, "ctc_beta_grad")
    ctc_beta_grad.launches += 1
    return dlp


class _CTCLoss(torch.autograd.Function):
    """Per-sequence CTC loss; forward alpha (K3), backward beta and the
    class scatter (K4).  ``kernel`` selects the CUDA kernels (True) or
    the plain recursions (False)."""

    @staticmethod
    def forward(ctx, log_probs, targets, tlen, ulen, blank, kernel):
        alpha_fn = ctc_alpha if kernel else ctc_alpha_plain
        alpha, loss, logz = alpha_fn(log_probs, targets, tlen, ulen, blank)
        ctx.save_for_backward(log_probs, targets, tlen, ulen, alpha, logz)
        ctx.blank, ctx.kernel = blank, kernel
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, targets, tlen, ulen, alpha, logz = ctx.saved_tensors
        grad_fn = ctc_beta_grad if ctx.kernel else ctc_beta_grad_plain
        dlp = grad_fn(log_probs, targets, tlen, ulen, ctx.blank, alpha, logz,
                      g)
        return dlp.to(log_probs.dtype), None, None, None, None, None


def ctc_loss_per_seq(log_probs, targets, input_lengths, target_lengths,
                     blank_id):
    """Per-sequence CTC negative log-likelihood (B,), differentiable
    w.r.t. ``log_probs``; the kernels on CUDA tensors.

    log_probs (B, T, C) float32 log-probabilities; targets (B, U) ints;
    absolute int lengths (B,).

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 4, 3), -1)
    >>> loss = ctc_loss_per_seq(lp, torch.tensor([[1, 2]]),
    ...     torch.tensor([4]), torch.tensor([2]), 0)
    >>> bool(loss[0] > 0)
    True
    """
    if log_probs.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"ctc_loss_per_seq: unsupported device {log_probs.device}")
    return _CTCLoss.apply(log_probs, targets, input_lengths, target_lengths,
                          blank_id, log_probs.device.type == "cuda")


def ctc_loss_per_seq_plain(log_probs, targets, input_lengths,
                           target_lengths, blank_id):
    """``ctc_loss_per_seq`` through the plain recursions on any device
    (to check the kernels on the card)."""
    return _CTCLoss.apply(log_probs, targets, input_lengths, target_lengths,
                          blank_id, False)


ctc_alpha.launches = 0
ctc_beta_grad.launches = 0
