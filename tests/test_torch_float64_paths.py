"""Float64 inputs stay float64 through the attention softmax, the plain
CTC recursions and the RNN-T loss's scan form, as they do in JAX
(``jax.nn.softmax`` and the JAX recursions keep their input's dtype).
Float32 and bfloat16 keep their float32 arithmetic; the CUDA kernels
stay float32.  A float64 card-vs-CPU check through these paths then
sees a float32 leak without a float32 control.

Each test holds the port's float64 result to a float64 reference
written here in numpy (the softmax, the CTC alpha recursion over the
blank-extended lattice, the RNN-T forward variables), within 1e-13 of
its scale: a float32 island misses by ~1e-7.  The plain CTC's gradient
passes ``torch.autograd.gradcheck`` in float64.
"""

import numpy as np
import pytest
import torch

from speechbrain_tpu_torch.nnet.attention import MultiheadAttention, _softmax
from speechbrain_tpu_torch.nnet.loss.transducer_loss import (
    transducer_forward_loss,
)
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.ops.ctc import ctc_loss_per_seq_plain

from .test_torch_kernels import one_torch_thread  # noqa: F401

TOL = 1e-13


def _logsumexp(a):
    m = np.max(a)
    return -np.inf if m == -np.inf else m + np.log(np.sum(np.exp(a - m)))


def _ctc_nll(lp, labels, t_len, blank=0):
    """-log p(labels | lp[:t_len]) by the alpha recursion over the
    blank-extended lattice, float64."""
    ext = [blank]
    for y in labels:
        ext += [y, blank]
    S = len(ext)
    alpha = np.full(S, -np.inf)
    alpha[0] = lp[0, ext[0]]
    if S > 1:
        alpha[1] = lp[0, ext[1]]
    for t in range(1, t_len):
        new = np.full(S, -np.inf)
        for s in range(S):
            terms = [alpha[s]] + ([alpha[s - 1]] if s >= 1 else [])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                terms.append(alpha[s - 2])
            new[s] = _logsumexp(np.array(terms)) + lp[t, ext[s]]
        alpha = new
    return -_logsumexp(alpha[-2:] if S > 1 else alpha[-1:])


def _rnnt_nll(lp, labels, t_len, blank=0):
    """-log p(labels | lp) of the RNN-T lattice (T_b, U_b + 1), float64."""
    U = len(labels)
    alpha = np.full((t_len, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(t_len):
        for u in range(U + 1):
            if t == 0 and u == 0:
                continue
            terms = []
            if t > 0:
                terms.append(alpha[t - 1, u] + lp[t - 1, u, blank])
            if u > 0:
                terms.append(alpha[t, u - 1] + lp[t, u - 1, labels[u - 1]])
            alpha[t, u] = _logsumexp(np.array(terms))
    return -(alpha[t_len - 1, U] + lp[t_len - 1, U, blank])


def test_attention_softmax_keeps_float64():
    """``_softmax`` (the one of ``MultiheadAttention`` and
    ``RelPosMHAXL``) on float64 scores of scale 3 against
    ``torch.softmax`` in float64, and ``MultiheadAttention``'s weights
    against numpy's float64 softmax of its scores; float32 scores keep
    float32."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(3.0 * rng.standard_normal((2, 4, 7, 9)))
    got = _softmax(s, torch.float64)
    want = torch.softmax(s, dim=-1)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= TOL
    assert _softmax(s.float(), torch.float32).dtype == torch.float32

    mha = MultiheadAttention(nhead=2, d_model=8).double()
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)))
    _, attn = mha(x, x, x)
    q = mha.q_proj(x).reshape(2, 5, 2, 4)
    k = mha.k_proj(x).reshape(2, 5, 2, 4)
    sc = (torch.einsum("bqhd,bkhd->bhqk", q, k) / 2.0).detach().numpy()
    w = np.exp(sc - sc.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).mean(1)
    assert attn.dtype == torch.float64
    assert np.abs(attn.detach().numpy() - w).max() <= TOL


def test_plain_ctc_keeps_float64():
    """The plain CTC recursions (``ctc_loss_per_seq_plain``, the CPU's
    route of ``ctc_loss``) on float64 log-probs: float64 losses within
    1e-13 of the numpy recursion for repeated labels, a row shorter than
    T and a label equal to the blank (the distillation's empty path),
    float64 gradients that pass ``gradcheck``."""
    rng = np.random.default_rng(1)
    B, T, C = 4, 9, 5
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((B, T, C))),
                           -1)
    targets = torch.tensor([[1, 2, 2, 3], [3, 1, 0, 0], [0, 0, 0, 0],
                            [4, 4, 1, 0]])
    t_lens = torch.tensor([9, 7, 9, 8])
    u_lens = torch.tensor([4, 2, 1, 3])
    loss = ctc_loss_per_seq_plain(lp, targets, t_lens, u_lens, 0)
    assert loss.dtype == torch.float64
    want = np.array([_ctc_nll(lp[b].numpy(), targets[b, :u_lens[b]].tolist(),
                              int(t_lens[b])) for b in range(B)])
    assert np.abs(loss.numpy() - want).max() <= TOL * np.abs(want).max()
    mean = ctc_loss(lp, targets, t_lens / T, u_lens / 4, blank_index=0)
    assert mean.dtype == torch.float64

    leaf = lp.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(ctc_loss_per_seq_plain(
        leaf, targets, t_lens, u_lens, 0).sum(), leaf)
    assert g.dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda x: ctc_loss_per_seq_plain(x, targets[:2], t_lens[:2],
                                         u_lens[:2], 0),
        (lp[:2, :7].detach().clone().requires_grad_(True),))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rnnt_scan_keeps_float64(dtype):
    """``transducer_forward_loss`` (the scan form) returns the input's
    dtype at float64 and float32, and its float64 losses lie within
    1e-13 of the numpy forward variables (float32 within 1e-5)."""
    rng = np.random.default_rng(2)
    B, T, U, V = 3, 6, 3, 5
    lp = torch.log_softmax(
        torch.from_numpy(rng.standard_normal((B, T, U + 1, V))), -1)
    targets = torch.tensor([[1, 2, 2], [3, 4, 0], [2, 0, 0]])
    t_lens = torch.tensor([6, 4, 5])
    u_lens = torch.tensor([3, 2, 1])
    loss = transducer_forward_loss(lp.to(dtype), targets, t_lens, u_lens, 0)
    assert loss.dtype == dtype
    want = np.array([_rnnt_nll(lp[b].numpy(), targets[b, :u_lens[b]].tolist(),
                               int(t_lens[b])) for b in range(B)])
    tol = TOL if dtype == torch.float64 else 1e-5
    got = loss.detach().double().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
