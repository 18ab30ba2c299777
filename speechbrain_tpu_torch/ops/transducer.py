"""RNN-T loss over the (T, U+1) lattice (log semiring), with its analytic
gradient.

Counterpart of ``speechbrain_tpu/ops/pallas/transducer.py``.  The
lattice of utterance b reads two tables, built from the joint network's
output and masked as ``_pad_tables`` masks them:

    blank[b, t, u] = log P(blank | t, u), 0 (log 1) for t >= T_b
    emit[b, t, u]  = log P(y_{u+1} | t, u), -1e30 for u >= U_b or t >= T_b

``transducer_alpha`` (K8, ``sb_transducer_alpha``) runs the alpha
recursion and returns ``final[b] = alpha[T_b-1, U_b] + blank[T_b-1, U_b]``
(0 when T_b = 0: the TPU kernel never harvests such a row);
``transducer_beta_grad`` (K9, ``sb_transducer_beta_grad``) runs the beta
recursion from the virtual row beta[T, U_b] = 0 and returns the
derivatives of ``-final`` w.r.t. the two tables (minus the occupancies).
Both kernels are in ``csrc/transducer.cu``; on CPU tensors the wrappers
run ``transducer_alpha_plain`` and ``transducer_beta_grad_plain``, the
same recursions walked along the lattice's anti-diagonals in PyTorch.
The fill -1e30, the -80 clamp inside the log-add-exp and in the
gradients, and the masks are the JAX kernel's, so impossible states
behave identically.  The tables are batch-major (B, T, U+1) and (B, T, U),
unpadded: the TPU's padding to 8 rows and 128 lanes and its time-major
swap are layout devices of that chip.

Two autograd entries sit on top:

- ``transducer_loss_logits`` (JAX ``transducer_loss_pallas_logits``) on
  raw logits: the forward keeps ``logits`` and ``denom = logsumexp``
  only, never a (B, T, U+1, V) log-softmax, and the backward is one
  elementwise pass ``-softmax * (dblank + demit) + dblank [v = blank] +
  demit [v = y_{u+1}]``;
- ``transducer_loss_per_seq`` (JAX ``transducer_loss_pallas``) on
  log-probabilities, with the scatter of the two table gradients.

Both return the per-utterance negative log-likelihood (B,), divided by
``max(T_b, 1)`` with ``normalize_by_T``.
"""

import torch

from . import _build

__all__ = [
    "transducer_alpha",
    "transducer_alpha_plain",
    "transducer_beta_grad",
    "transducer_beta_grad_plain",
    "transducer_tables",
    "transducer_loss_logits",
    "transducer_loss_per_seq",
]

NEG = -1.0e30
# widest lattice the kernels take: U + 1 columns need 2 (U + 1) floats of
# a block's 227 KB of shared memory
MAX_COLS = 29056


def _lae(a, b):
    """The JAX kernel's ``_log_add``: exponents clamped at -80, the max
    floored at NEG, so NEG + NEG stays finite."""
    m = torch.maximum(a, b).clamp(min=NEG)
    return m + torch.log(torch.exp((a - m).clamp(min=-80.0))
                         + torch.exp((b - m).clamp(min=-80.0)))


def _diagonal_index(T, W, device):
    """Cells of the anti-diagonals d = t + u of a (T, W) lattice: row
    indices (D, W) clamped into range, and which of them are real."""
    d = torch.arange(T + W - 1, device=device)[:, None]
    u = torch.arange(W, device=device)[None, :]
    t = d - u
    return t.clamp(0, T - 1), u.expand_as(t), (t >= 0) & (t < T), t


def _skew(x, fill):
    """(B, T, W) -> (B, T+W-1, W) with out[:, d, u] = x[:, d-u, u] (the
    lattice's anti-diagonals as rows), ``fill`` off the lattice."""
    T, W = x.shape[1:]
    t, u, real, _ = _diagonal_index(T, W, x.device)
    return torch.where(real, x[:, t, u], torch.full((), fill, device=x.device))


def _unskew(xs, T):
    """The inverse of ``_skew``: (B, T+W-1, W) -> (B, T, W)."""
    W = xs.shape[2]
    t = torch.arange(T, device=xs.device)[:, None]
    u = torch.arange(W, device=xs.device)[None, :]
    return xs[:, t + u, u]


def _emit_cols(emit):
    """emit (B, T, U) widened to U+1 columns with a NEG last column."""
    B, T, _ = emit.shape
    return torch.cat([emit, torch.full((B, T, 1), NEG, device=emit.device)], -1)


def _shift(x, k):
    """x[..., u - k] (k = 1) or x[..., u + 1] (k = -1), NEG-filled."""
    out = torch.full_like(x, NEG)
    if k > 0:
        out[..., 1:] = x[..., :-1]
    else:
        out[..., :-1] = x[..., 1:]
    return out


def transducer_alpha_plain(blank, emit, t_lens, u_lens):
    """Plain version of K8: the alpha recursion along the anti-diagonals.

    blank (B, T, U+1), emit (B, T, U) float32 masked tables; t_lens,
    u_lens (B,) ints.  Returns ``(alpha (B, T, U+1), final (B,))``.

    Example
    -------
    >>> blank = torch.log(torch.full((1, 2, 2), 0.5))
    >>> emit = torch.log(torch.full((1, 2, 1), 0.5))
    >>> _, final = transducer_alpha_plain(blank, emit, torch.tensor([2]),
    ...     torch.tensor([1]))
    >>> round(float(torch.exp(final[0])), 4)  # 2 paths of 3 steps at 1/2
    0.25
    """
    B, T, U1 = blank.shape
    dev = blank.device
    bk = _skew(blank.float(), 0.0)
    ek = _skew(_emit_cols(emit.float()), NEG)
    _, _, real, t = _diagonal_index(T, U1, dev)
    u = torch.arange(U1, device=dev)
    a = torch.where(u == 0, 0.0, NEG).expand(B, U1)
    rows = [a]
    for d in range(1, T + U1 - 1):
        up = torch.where(t[d] == 0, NEG, a + bk[:, d - 1])
        a = torch.where(real[d], _lae(up, _shift(a + ek[:, d - 1], 1)), NEG)
        rows.append(a)
    alpha = _unskew(torch.stack(rows, 1), T)
    tb = t_lens.long().to(dev)
    ub = u_lens.long().to(dev)
    b = torch.arange(B, device=dev)
    tl = (tb - 1).clamp(min=0)
    final = alpha[b, tl, ub] + blank.float()[b, tl, ub]
    return alpha, torch.where(tb > 0, final, 0.0)


def transducer_beta_grad_plain(blank, emit, alpha, t_lens, u_lens, logz):
    """Plain version of K9: the beta recursion along the anti-diagonals,
    from the virtual row beta[T, U_b] = 0, and the gradients of
    ``-final`` w.r.t. the tables: ``(dblank (B, T, U+1), demit (B, T, U))``.

    Example
    -------
    >>> blank = torch.log(torch.full((1, 2, 2), 0.5))
    >>> emit = torch.log(torch.full((1, 2, 1), 0.5))
    >>> tl, ul = torch.tensor([2]), torch.tensor([1])
    >>> alpha, final = transducer_alpha_plain(blank, emit, tl, ul)
    >>> db, de = transducer_beta_grad_plain(blank, emit, alpha, tl, ul, final)
    >>> float(de.sum()), float(db.sum())  # one emission, two blanks per path
    (-1.0, -2.0)
    """
    B, T, U1 = blank.shape
    U = U1 - 1
    dev = blank.device
    blank, emit = blank.float(), emit.float()
    bk = _skew(blank, 0.0)
    ek = _skew(_emit_cols(emit), NEG)
    ak = _skew(alpha.float(), NEG)
    _, _, real, t = _diagonal_index(T, U1, dev)
    u = torch.arange(U1, device=dev)
    ub = u_lens.long().to(dev)[:, None]
    virtual = torch.where(u == ub, 0.0, NEG)  # beta[T, :]
    D = T + U1 - 1
    # beta on diagonal d + 1 (the lattice's cells) with the virtual row's
    # cell where d + 1 - u = T; every other position is NEG
    nxt = torch.where(D - u == T, virtual, NEG)
    downs, rights = [None] * D, [None] * D
    for d in range(D - 1, -1, -1):
        down = nxt + bk[:, d]  # beta[t+1, u] + blank[t, u]
        right = _shift(nxt, -1) + ek[:, d]  # beta[t, u+1] + emit[t, u]
        cur = torch.where(real[d], _lae(down, right), NEG)
        nxt = torch.where(t[d] == T, virtual, cur)
        downs[d], rights[d] = down, right
    z = logz.float().to(dev)[:, None, None]
    tb = t_lens.long().to(dev)[:, None, None]
    occ_b = -torch.exp((ak + torch.stack(downs, 1) - z).clamp(min=-80.0))
    occ_e = -torch.exp((ak + torch.stack(rights, 1) - z).clamp(min=-80.0))
    tt = torch.arange(T, device=dev)[None, :, None]
    dblank = torch.where((tt < tb) & (blank > NEG / 2), _unskew(occ_b, T), 0.0)
    demit = torch.where(emit > NEG / 2, _unskew(occ_e, T)[..., :U], 0.0)
    return dblank, demit


def _check_tables(blank, emit, name, *others):
    """The kernels take contiguous float32 (B, T, U+1) / (B, T, U) tables
    with T >= 1 and U + 1 <= ``MAX_COLS`` (29056: the two anti-diagonals
    a block's shared memory holds); anything else raises."""
    for x in (blank, emit) + others:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: tables must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tables must be contiguous")
        if x.device != blank.device:
            raise ValueError(f"{name}: tables on different devices")
    if blank.dim() != 3 or emit.dim() != 3:
        raise ValueError(f"{name}: blank (B, T, U+1) and emit (B, T, U)")
    B, T, U1 = blank.shape
    if emit.shape != (B, T, U1 - 1):
        raise ValueError(f"{name}: emit {tuple(emit.shape)} is not "
                         f"(B, T, U) for blank {tuple(blank.shape)}")
    for x in others:
        if x.shape != blank.shape:
            raise ValueError(f"{name}: alpha must have blank's shape")
    if T < 1 or U1 > MAX_COLS:
        raise ValueError(f"{name}: needs T >= 1 and U + 1 <= {MAX_COLS} "
                         "(shared memory of one block)")


def _validated(t_lens, u_lens, T, U, device, name, targets=None, V=None):
    """int32 lengths on ``device``; raises, after one host sync, if a
    length lies outside [0, T] or [0, U], or a target id (padding
    included: it is gathered) outside [0, V)."""
    tl = t_lens.to(device=device, dtype=torch.int32).contiguous()
    ul = u_lens.to(device=device, dtype=torch.int32).contiguous()
    if tl.shape != ul.shape or tl.dim() != 1:
        raise ValueError(f"{name}: t_lens and u_lens must be (B,)")
    bad_len = ((tl < 0) | (tl > T)).any() | ((ul < 0) | (ul > U)).any()
    bad_tg = torch.zeros((), dtype=torch.bool, device=device)
    if targets is not None:
        bad_tg = ((targets < 0) | (targets >= V)).any().to(device)
    bad = torch.stack([bad_len, bad_tg]).tolist()
    if bad[0]:
        raise ValueError(f"{name}: a length outside [0, T] or [0, U]")
    if bad[1]:
        raise ValueError(f"{name}: a target id outside [0, {V})")
    return tl, ul


_ALPHA = _build.Entry("transducer", "sb_transducer_alpha",
                      [_build.P] * 6 + [_build.I] * 3 + [_build.P])
_BETA_GRAD = _build.Entry("transducer", "sb_transducer_beta_grad",
                          [_build.P] * 8 + [_build.I] * 3 + [_build.P])


def _alpha_kernel(blank, emit, tl, ul):
    """Launch K8 on checked tables and validated int32 lengths (no host
    sync)."""
    B, T, U1 = blank.shape
    alpha = torch.empty_like(blank)
    final = torch.empty(B, dtype=torch.float32, device=blank.device)
    rc = _ALPHA(blank.data_ptr(), emit.data_ptr(), tl.data_ptr(), ul.data_ptr(),
            alpha.data_ptr(), final.data_ptr(), B, T, U1 - 1,
            _build.stream_of(blank))
    _build.check_launch(rc, "transducer_alpha")
    transducer_alpha.launches += 1
    return alpha, final


def _beta_grad_kernel(blank, emit, alpha, tl, ul, logz):
    """Launch K9 on checked tables and validated int32 lengths (no host
    sync)."""
    B, T, U1 = blank.shape
    dblank = torch.empty_like(blank)
    demit = torch.empty_like(emit)
    rc = _BETA_GRAD(blank.data_ptr(), emit.data_ptr(), alpha.data_ptr(),
            tl.data_ptr(), ul.data_ptr(), logz.data_ptr(), dblank.data_ptr(),
            demit.data_ptr(), B, T, U1 - 1, _build.stream_of(blank))
    _build.check_launch(rc, "transducer_beta_grad")
    transducer_beta_grad.launches += 1
    return dblank, demit


def transducer_alpha(blank, emit, t_lens, u_lens):
    """K8: ``(alpha (B, T, U+1), final (B,))`` float32 from the masked
    tables; the plain version on the CPU.  On CUDA, U + 1 <= ``MAX_COLS``
    (29056); wider raises.  Counts launches in
    ``transducer_alpha.launches``.
    """
    if blank.device.type == "cpu":
        return transducer_alpha_plain(blank, emit, t_lens, u_lens)
    if blank.device.type != "cuda":
        raise RuntimeError(f"transducer_alpha: unsupported device {blank.device}")
    _check_tables(blank, emit, "transducer_alpha")
    _build.refuse_grad("transducer_alpha", blank, emit)
    T, U1 = blank.shape[1:]
    tl, ul = _validated(t_lens, u_lens, T, U1 - 1, blank.device,
                        "transducer_alpha")
    return _alpha_kernel(blank, emit, tl, ul)


def transducer_beta_grad(blank, emit, alpha, t_lens, u_lens, logz):
    """K9: ``(dblank (B, T, U+1), demit (B, T, U))`` float32, the
    gradients of ``-final`` from ``transducer_alpha``'s alpha and logz =
    final; the plain version on the CPU.  On CUDA, U + 1 <= ``MAX_COLS``
    (29056).  Counts launches in ``transducer_beta_grad.launches``.
    """
    if blank.device.type == "cpu":
        return transducer_beta_grad_plain(blank, emit, alpha, t_lens, u_lens,
                                          logz)
    if blank.device.type != "cuda":
        raise RuntimeError(
            f"transducer_beta_grad: unsupported device {blank.device}")
    _check_tables(blank, emit, "transducer_beta_grad", alpha)
    _build.refuse_grad("transducer_beta_grad", blank, emit, alpha, logz)
    B, T, U1 = blank.shape
    if logz.shape != (B,):
        raise ValueError("transducer_beta_grad: logz must be (B,)")
    tl, ul = _validated(t_lens, u_lens, T, U1 - 1, blank.device,
                        "transducer_beta_grad")
    logz = logz.to(device=blank.device, dtype=torch.float32).contiguous()
    return _beta_grad_kernel(blank, emit, alpha, tl, ul, logz)


def _mask_tables(blank_lp, emit_lp, t_lens, u_lens):
    """``_pad_tables``'s masks: blank 0 for t >= T_b, emit NEG for
    u >= U_b or t >= T_b."""
    B, T, U1 = blank_lp.shape
    dev = blank_lp.device
    tt = torch.arange(T, device=dev)[None, :, None]
    uu = torch.arange(U1 - 1, device=dev)[None, None, :]
    tb = t_lens.to(dev).long()[:, None, None]
    ub = u_lens.to(dev).long()[:, None, None]
    blank_m = torch.where(tt < tb, blank_lp, 0.0).contiguous()
    emit_m = torch.where((uu < ub) & (tt < tb), emit_lp, NEG).contiguous()
    return blank_m, emit_m


def transducer_tables(log_probs, targets, blank_index, t_lens, u_lens):
    """The masked tables from (B, T, U+1, V) log-probabilities:
    ``(blank (B, T, U+1), emit (B, T, U))`` float32.

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 2, 2, 3), -1)
    >>> blank, emit = transducer_tables(lp, torch.tensor([[2]]), 0,
    ...     torch.tensor([1]), torch.tensor([1]))
    >>> blank[0, :, 0].tolist()  # frame 1 is padding: log 1
    [-1.0986123085021973, 0.0]
    >>> bool(emit[0, 0, 0] == blank[0, 0, 0]), bool(emit[0, 1, 0] < -1e29)
    (True, True)
    """
    U = targets.shape[1]
    lp = log_probs.float()
    blank_lp = lp[..., blank_index]
    idx = targets.long()[:, None, :, None].expand(-1, lp.shape[1], -1, 1)
    emit_lp = lp[:, :, :U].gather(3, idx)[..., 0]
    return _mask_tables(blank_lp, emit_lp, t_lens, u_lens)


def _scale(t_lens, normalize_by_T, device):
    if not normalize_by_T:
        return None
    return 1.0 / t_lens.to(device).float().clamp(min=1.0)


class _TransducerLoss(torch.autograd.Function):
    """Per-utterance RNN-T loss; forward alpha (K8), backward beta and the
    occupancies (K9).  ``logits`` True: the input is raw logits and the
    softmax is fused into the backward; False: log-probabilities and a
    scatter.  ``kernel`` selects the CUDA kernels or the plain versions."""

    @staticmethod
    def forward(ctx, x, targets, t_lens, u_lens, blank, normalize_by_T,
                logits, kernel):
        B, T, U1, V = x.shape
        if targets.shape != (B, U1 - 1):
            raise ValueError("transducer loss: targets must be (B, U) for "
                             "(B, T, U+1, V) inputs")
        if not 0 <= blank < V:
            raise ValueError(f"transducer loss: blank {blank} outside [0, V)")
        # one host sync per call: lengths and labels in range
        t_lens, u_lens = _validated(t_lens, u_lens, T, U1 - 1, x.device,
                                    "transducer loss", targets, V)
        denom = None
        if logits:
            denom = torch.logsumexp(x, -1)  # (B, T, U+1)
            lp_blank = x[..., blank] - denom
            idx = targets.long()[:, None, :, None].expand(-1, T, -1, 1)
            lp_emit = x[:, :, : U1 - 1].gather(3, idx)[..., 0] - denom[:, :, :-1]
            tables = _mask_tables(lp_blank, lp_emit, t_lens, u_lens)
        else:
            tables = transducer_tables(x, targets, blank, t_lens, u_lens)
        if kernel:
            _check_tables(*tables, "transducer loss")
        alpha_fn = _alpha_kernel if kernel else transducer_alpha_plain
        alpha, final = alpha_fn(*tables, t_lens, u_lens)
        nll = -final
        scale = _scale(t_lens, normalize_by_T, x.device)
        if scale is not None:
            nll = nll * scale
        ctx.save_for_backward(x, denom, targets, *tables, alpha, final,
                              t_lens, u_lens, scale)
        ctx.blank, ctx.logits, ctx.kernel = blank, logits, kernel
        return nll

    @staticmethod
    def backward(ctx, g):
        (x, denom, targets, blank_t, emit_t, alpha, final, t_lens, u_lens,
         scale) = ctx.saved_tensors
        B, T, U1, V = x.shape
        U = U1 - 1
        grad_fn = _beta_grad_kernel if ctx.kernel else transducer_beta_grad_plain
        dblank, demit = grad_fn(blank_t, emit_t, alpha, t_lens, u_lens, final)
        g_row = g.float() if scale is None else g.float() * scale
        dblank = dblank * g_row[:, None, None]
        demit = demit * g_row[:, None, None]
        if ctx.logits:
            # -softmax * (dblank + demit), one pass in place over a fresh
            # (B, T, U+1, V) buffer; the emit of the last column is 0
            row = dblank.clone()
            row[:, :, :U] += demit
            dx = torch.sub(x, denom[..., None]).exp_().mul_(-row[..., None])
        else:
            dx = torch.zeros_like(x)
        dx[..., ctx.blank] += dblank
        # one entry per (b, t, u) row: no two additions meet; a padded
        # target (the pad id, often blank) gets demit = 0
        idx = targets.long()[:, None, :, None].expand(-1, T, -1, 1)
        dx[:, :, :U].scatter_add_(3, idx, demit[..., None])
        return dx, None, None, None, None, None, None, None


def _entry(x, targets, t_lens, u_lens, blank_index, normalize_by_T, logits,
           use_kernels, name):
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32:
        raise TypeError(f"{name}: input must be float32 (B, T, U+1, V)")
    kernel = use_kernels and x.device.type == "cuda"
    dev = x.device
    return _TransducerLoss.apply(
        x, targets.to(dev), t_lens.to(dev), u_lens.to(dev), int(blank_index),
        bool(normalize_by_T), logits, kernel)


def transducer_loss_logits(logits, targets, t_lens, u_lens, blank_index,
                           normalize_by_T=False, use_kernels=True):
    """Per-utterance RNN-T negative log-likelihood (B,) from raw logits
    (B, T, U+1, V), differentiable w.r.t. ``logits``, with the softmax
    fused into the backward.  targets (B, U) ints (padding: any id in
    [0, V)); absolute int lengths (B,).  The kernels run on CUDA tensors
    unless ``use_kernels`` is False (the plain recursions, to check them
    on the card); on CPU tensors the plain recursions run.

    Example
    -------
    >>> logits = torch.zeros(1, 2, 2, 3, requires_grad=True)
    >>> loss = transducer_loss_logits(logits, torch.tensor([[1]]),
    ...     torch.tensor([2]), torch.tensor([1]), 0)
    >>> round(float(loss[0].detach()), 4)  # -log(2 paths x (1/3)^3)
    2.6027
    >>> loss.sum().backward()
    >>> abs(float(logits.grad.sum())) < 1e-6  # softmax rows: no net change
    True
    """
    return _entry(logits, targets, t_lens, u_lens, blank_index,
                  normalize_by_T, True, use_kernels, "transducer_loss_logits")


def transducer_loss_per_seq(log_probs, targets, t_lens, u_lens, blank_index,
                            normalize_by_T=False, use_kernels=True):
    """``transducer_loss_logits`` on (B, T, U+1, V) log-probabilities:
    the gradient is scattered onto the blank and target columns only.

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 2, 2, 3), -1).requires_grad_()
    >>> loss = transducer_loss_per_seq(lp, torch.tensor([[1]]),
    ...     torch.tensor([2]), torch.tensor([1]), 0)
    >>> loss.sum().backward()
    >>> float(lp.grad[..., 2].abs().sum())  # never on the path
    0.0
    """
    return _entry(log_probs, targets, t_lens, u_lens, blank_index,
                  normalize_by_T, False, use_kernels,
                  "transducer_loss_per_seq")


transducer_alpha.launches = 0
transducer_beta_grad.launches = 0
