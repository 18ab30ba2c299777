"""Attention with the Transformer-XL relative-position bias, forward and
backward.

Counterpart of ``speechbrain_tpu/ops/pallas/relpos_attention.py``:

    s[q,k] = ((q + u) . k_k + (q + vb) . p[T-1-q+k]) * scale + madd[k]
    (s = -1e9 where causal and k > q), out = softmax(s) @ v  (f32)

``relpos_attention`` is differentiable.  On CUDA tensors it is an
autograd Function whose forward launches the flash-style kernel
``sb_relpos_attention_fwd`` in ``csrc/relpos_attention.cu`` (which never
forms a (T, T) tensor and also writes the per-row log-sum-exp) and whose
backward launches ``sb_relpos_attention_bwd`` (``relpos_attention_bwd``)
in ``csrc/relpos_attention_bwd.cu``, both on the tensor cores (their
shared pieces in ``csrc/relpos_mma.cuh``).  A bf16 call rounds the
operands of each product to bf16 where JAX's kernel does;
``_relpos_attention_rounded`` is that arithmetic, materialized.  On CPU
tensors it runs ``relpos_attention_plain``, the materialized form (equal
to the JAX ``relpos_attention_reference``), and autograd differentiates it;
``relpos_attention_bwd_plain`` is that gradient as a function.

Attention dropout (``rate > 0``) acts on the normalized weights, as in
the JAX kernels: ``out = (softmax(s) * keep / (1 - rate)) @ v``, the
log-sum-exp taken before dropout.  ``keep`` is a pure function of
``(seed, b, h, q, k)`` from a Philox4x32-10 generator that the kernels
and ``relpos_dropout_keep`` (their plain version) both compute, so the
backward regenerates the forward's mask.  The TPU's hardware generator
runs on a TPU only, so JAX's bits are not reproduced; its threshold
rule, normalizer and gradient formulas are.
"""

import ctypes
import functools
import operator

import torch

from . import _build

__all__ = [
    "relpos_attention",
    "relpos_attention_plain",
    "relpos_attention_bwd",
    "relpos_attention_bwd_plain",
    "relpos_dropout_keep",
]

NEG = -1e9
BLOCK = 64  # query/key tile of the kernel: Tp must be a multiple
HEAD_DIMS = (16, 32, 36, 64)  # head widths the kernels are built for

# Philox4x32-10 (Salmon et al., SC'11): round multipliers, key increments
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _dropout_args(rate, seed):
    """``(rate, seed)`` checked: a rate in [0, 1) (JAX's ``1 / (1 - rate)``
    is infinite at 1) and an integer seed in [0, 2^64)."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"relpos_attention: dropout rate must be in [0, 1), got {rate}")
    seed = operator.index(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"relpos_attention: seed must be in [0, 2^64), got {seed}")
    return rate, seed


def _threshold(rate):
    """JAX's keep threshold: a word >= it is kept."""
    return min(_U32, int(rate * 2 ** 32))


def _mulhilo(a, b):
    """(high, low) 32-bit words of ``a * b``, ``a`` a 32-bit constant and
    ``b`` int64 values below 2^32.  torch has no unsigned 32-bit
    multiply-high and ``a * b`` overflows int64, so ``b`` is split into
    16-bit halves: every partial product stays below 2^49."""
    u = a * (b >> 16)
    t = a * (b & 0xFFFF) + ((u & 0xFFFF) << 16)
    return (u >> 16) + (t >> 32), t & _U32


def _philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on a counter of four 32-bit words and a key of two,
    each an int or an int64 tensor (tensors broadcast); returns the four
    output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def relpos_dropout_keep(B, H, Tp, rate, seed, device):
    """The (B, H, Tp, Tp) bool keep mask of attention dropout: the plain
    version of the kernels' generator.

    Element (b, h, q, k) is word ``k & 3`` of Philox4x32-10 with counter
    ``(k >> 2, q, b*H + h, 0)`` and key ``(seed & 0xffffffff, seed >> 32)``;
    it is kept iff that word is ``>= min(2^32 - 1, floor(rate * 2^32))``
    (JAX's threshold rule).  The mask depends on nothing else, so the mask
    at Tp is the top-left corner of the mask at any larger Tp.

    Example
    -------
    >>> keep = relpos_dropout_keep(1, 2, 8, 0.25, 7, "cpu")
    >>> keep.shape, keep.dtype
    (torch.Size([1, 2, 8, 8]), torch.bool)
    >>> bool((keep == relpos_dropout_keep(1, 2, 16, 0.25, 7, "cpu")[..., :8, :8]).all())
    True
    """
    rate, seed = _dropout_args(rate, seed)
    G = (Tp + 3) // 4  # counters per query row, four keys each
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    words = _philox4x32(ar(G).view(1, 1, G), ar(Tp).view(1, Tp, 1),
                        ar(B * H).view(B * H, 1, 1), 0, seed & _U32, seed >> 32)
    words = torch.stack(torch.broadcast_tensors(*words), -1)  # (BH, Tp, G, 4)
    words = words.reshape(B, H, Tp, 4 * G)[..., :Tp]
    return words >= _threshold(rate)


def _drop_cargs(rate, seed):
    """The kernels' dropout arguments (drop, thresh, inv, key0, key1)."""
    if rate == 0.0:
        return 0, 0, 1.0, 0, 0
    return 1, _threshold(rate), 1.0 / (1.0 - rate), seed & _U32, seed >> 32


_DROP_ARGTYPES = [_build.I, ctypes.c_uint, _build.F, ctypes.c_uint,
                  ctypes.c_uint]
_FWD = _build.Entry(
    "relpos_attention", "sb_relpos_attention_fwd",
    [_build.P] * 9 + [_build.I] * 5 + [_build.F, _build.I] + _DROP_ARGTYPES
    + [_build.I, _build.P])
_BWD_SCRATCH = _build.Entry(
    "relpos_attention_bwd", "sb_relpos_attention_bwd_scratch", [_build.I] * 5,
    restype=ctypes.c_longlong)
_BWD = _build.Entry(
    "relpos_attention_bwd", "sb_relpos_attention_bwd",
    [_build.P] * 17 + [_build.I] * 5 + [_build.F, _build.I] + _DROP_ARGTYPES
    + [_build.I, _build.P])


def relpos_attention_plain(q, k, v, p, u, vb, madd, scale, causal=False,
                           rate=0.0, seed=0):
    """Plain PyTorch version: materialized content and position scores.

    q, k, v : (B, H, Tp, dh); p : (H, 2T-1, dh); u, vb : (H, dh);
    madd : (B, Tp) additive key mask.  Position indices T-1-q+k are
    clipped to [0, 2T-2] (only padded rows q >= T reach the clip).
    With ``rate > 0`` the weights are multiplied by
    ``relpos_dropout_keep(..., rate, seed) / (1 - rate)``.
    Returns (B, H, Tp, dh) float32.

    Example
    -------
    >>> B, H, T, d = 1, 2, 4, 8
    >>> x = torch.randn(B, H, T, d)
    >>> out = relpos_attention_plain(x, x, x, torch.randn(H, 2 * T - 1, d),
    ...     torch.zeros(H, d), torch.zeros(H, d), torch.zeros(B, T), 0.25)
    >>> out.shape
    torch.Size([1, 2, 4, 8])
    """
    rate, seed = _dropout_args(rate, seed)
    B, H, Tp, dh = q.shape
    T = (p.shape[1] + 1) // 2
    qf, kf, vf, pf = q.float(), k.float(), v.float(), p.float()
    u, vb = u.float(), vb.float()
    content = torch.einsum("bhqd,bhkd->bhqk", qf + u[None, :, None], kf)
    ps = torch.einsum("bhqd,hld->bhql", qf + vb[None, :, None], pf)
    ar = torch.arange(Tp, device=q.device)
    idx = (T - 1 - ar[:, None] + ar[None, :]).clamp(0, 2 * T - 2)
    pos = torch.gather(ps, -1, idx.expand(B, H, Tp, Tp))
    s = (content + pos) * scale + madd.float()[:, None, None, :]
    if causal:
        s = s.masked_fill(ar[None, :] > ar[:, None], NEG)
    attn = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = relpos_dropout_keep(B, H, Tp, rate, seed, q.device)
        attn = attn * keep * (1.0 / (1.0 - rate))
    return torch.einsum("bhqk,bhkd->bhqd", attn, vf)


def _relpos_attention_rounded(q, k, v, p, u, vb, madd, scale, causal=False,
                              rate=0.0, seed=0, key_tile=None):
    """The bf16 kernel's arithmetic, materialized: (out, lse) float32.

    The operands of each product are rounded to bf16 where the JAX
    package's Pallas kernel rounds them (``_scores`` and ``_fwd_kernel``):
    (q + u), k, (q + vb), the position rows p, the weights
    exp(s - max) keep / (1 - rate) and v; every product and sum is f32,
    and the normalizer is taken before dropout.  With ``key_tile=None``
    the max is the row's global one, as in JAX's single pass; with
    ``key_tile=64`` the keys are taken in tiles of 64 with a running max
    and the earlier tiles' sums rescaled, as in the CUDA kernel's online
    softmax, so each weight is rounded against the max so far.

    Example
    -------
    >>> x = torch.randn(1, 1, 4, 8)
    >>> out, lse = _relpos_attention_rounded(x, x, x, torch.randn(1, 7, 8),
    ...     torch.zeros(1, 8), torch.zeros(1, 8), torch.zeros(1, 4), 0.3)
    >>> out.shape, lse.shape
    (torch.Size([1, 1, 4, 8]), torch.Size([1, 1, 4]))
    """
    rate, seed = _dropout_args(rate, seed)
    B, H, Tp, dh = q.shape
    T = (p.shape[1] + 1) // 2

    def bf(t):
        return t.float().to(torch.bfloat16).float()

    qf = q.float()
    content = torch.einsum("bhqd,bhkd->bhqk", bf(qf + u.float()[None, :, None]),
                           bf(k))
    ps = torch.einsum("bhqd,hld->bhql", bf(qf + vb.float()[None, :, None]),
                      bf(p))
    ar = torch.arange(Tp, device=q.device)
    idx = (T - 1 - ar[:, None] + ar[None, :]).clamp(0, 2 * T - 2)
    pos = torch.gather(ps, -1, idx.expand(B, H, Tp, Tp))
    s = (content + pos) * scale + madd.float()[:, None, None, :]
    if causal:
        s = s.masked_fill(ar[None, :] > ar[:, None], NEG)
    mult = torch.ones_like(s)  # keep / (1 - rate)
    if rate > 0.0:
        keep = relpos_dropout_keep(B, H, Tp, rate, seed, q.device)
        mult = keep * (1.0 / (1.0 - rate))
    vr = bf(v)
    tile = Tp if key_tile is None else key_tile
    mx = torch.full(s.shape[:-1] + (1,), float("-inf"), device=q.device)
    denom = torch.zeros_like(mx)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Tp, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(mx, st.amax(-1, keepdim=True))
        corr = torch.exp(mx - m_new)
        e = torch.exp(st - m_new)
        denom = denom * corr + e.sum(-1, keepdim=True)
        out = out * corr + torch.einsum(
            "bhqk,bhkd->bhqd", bf(e * mult[..., k0:k0 + tile]),
            vr[:, :, k0:k0 + tile])
        mx = m_new
    return out / denom, (mx + torch.log(denom)).squeeze(-1)


def relpos_attention_bwd_plain(q, k, v, p, u, vb, madd, dout, scale,
                               causal=False, rate=0.0, seed=0):
    """The six gradients (dq, dk, dv, dp, du, dvb) of ``sum(out * dout)``,
    by autograd through ``relpos_attention_plain`` (with its dropout mask
    held fixed), in float32.

    Example
    -------
    >>> x = torch.randn(1, 1, 4, 8)
    >>> grads = relpos_attention_bwd_plain(x, x, x, torch.randn(1, 7, 8),
    ...     torch.zeros(1, 8), torch.zeros(1, 8), torch.zeros(1, 4),
    ...     torch.ones(1, 1, 4, 8), 0.3)
    >>> [tuple(g.shape) for g in grads][3:]
    [(1, 7, 8), (1, 8), (1, 8)]
    """
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (q, k, v, p, u, vb)]
        out = relpos_attention_plain(*leaves, madd, scale, causal, rate, seed)
        return torch.autograd.grad(out, leaves, dout.float())


def _check(q, k, v, p, u, vb, madd):
    B, H, Tp, dh = q.shape
    T = (p.shape[1] + 1) // 2
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("relpos_attention: q, k, v must share a shape")
    if p.shape != (H, 2 * T - 1, dh) or T > Tp:
        raise ValueError("relpos_attention: p must be (H, 2T-1, dh), T <= Tp")
    if any(t.dtype != q.dtype for t in (k, v, p)):
        raise TypeError("relpos_attention: q, k, v, p must share a dtype")
    _build.dtype_code(q)
    if Tp % BLOCK or dh not in HEAD_DIMS:
        raise ValueError(
            f"relpos_attention: needs Tp % {BLOCK} == 0 and dh in "
            f"{HEAD_DIMS}, got Tp={Tp}, dh={dh}"
        )
    if not all(t.is_contiguous() for t in (q, k, v, p)):
        raise ValueError("relpos_attention: q, k, v, p must be contiguous")
    if u.shape != (H, dh) or vb.shape != (H, dh) or madd.shape != (B, Tp):
        raise ValueError("relpos_attention: u, vb (H, dh), madd (B, Tp)")
    return B, H, Tp, dh, T


def _fwd_kernel(q, k, v, p, u, vb, madd, scale, causal, rate=0.0, seed=0):
    """K5: (out, lse) float32 from CUDA tensors and dropout arguments
    checked by the caller; lse is taken before dropout."""
    B, H, Tp, dh = q.shape
    T = (p.shape[1] + 1) // 2
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Tp), dtype=torch.float32, device=q.device)
    rc = _FWD(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), madd.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Tp, T, dh, float(scale), int(bool(causal)),
        *_drop_cargs(rate, seed), _build.dtype_code(q), _build.stream_of(q),
    )
    _build.check_launch(rc, "relpos_attention")
    relpos_attention.launches += 1
    return out, lse


@functools.lru_cache(maxsize=64)
def _bwd_scratch(B, H, Tp, T, dh):
    """Floats of scratch K6 needs at this shape (its partial sums)."""
    return _BWD_SCRATCH(B, H, Tp, T, dh)


def relpos_attention_bwd(q, k, v, p, u, vb, madd, dout, lse, dsum, scale,
                         causal=False, rate=0.0, seed=0):
    """K6: the gradients (dq, dk, dv, dp, du, dvb), float32, of
    ``sum(out * dout)``.

    ``lse`` (B, H, Tp) is the forward's per-row log-sum-exp and ``dsum``
    (B, H, Tp) is ``sum(dout * out, -1)``; both feed the kernel, which
    regenerates the scores from them, and the dropout mask from ``rate``
    and ``seed`` (the forward's).  On the CPU the plain version (autograd
    through ``relpos_attention_plain``) runs and does not read them.
    Counts kernel launches in ``relpos_attention_bwd.launches``.
    """
    rate, seed = _dropout_args(rate, seed)
    if q.device.type == "cpu":
        return relpos_attention_bwd_plain(q, k, v, p, u, vb, madd, dout, scale,
                                          causal, rate, seed)
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention_bwd: unsupported device {q.device}")
    B, H, Tp, dh, T = _check(q, k, v, p, u, vb, madd)
    _build.refuse_grad("relpos_attention_bwd", q, k, v, p, u, vb, dout)
    f32 = [t.to(device=q.device, dtype=torch.float32).contiguous()
           for t in (u, vb, madd, dout, lse, dsum)]
    if f32[3].shape != q.shape or f32[4].shape != (B, H, Tp) \
            or f32[5].shape != (B, H, Tp):
        raise ValueError("relpos_attention_bwd: dout (B, H, Tp, dh), lse and "
                         "dsum (B, H, Tp)")
    # the six gradients as views of one buffer, the scratch in another
    n = q.numel()
    sizes = (n, n, n, H * (2 * T - 1) * dh, H * dh, H * dh)
    shapes = (q.shape, q.shape, q.shape, (H, 2 * T - 1, dh), (H, dh), (H, dh))
    out = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
    dq, dk, dv, dp, du, dvb = (
        g.view(shape) for g, shape in zip(out.split(sizes), shapes))
    part = torch.empty(_bwd_scratch(B, H, Tp, T, dh), dtype=torch.float32,
                       device=q.device)
    rc = _BWD(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        *(t.data_ptr() for t in f32),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dp.data_ptr(),
        du.data_ptr(), dvb.data_ptr(), part.data_ptr(),
        B, H, Tp, T, dh, float(scale), int(bool(causal)),
        *_drop_cargs(rate, seed), _build.dtype_code(q), _build.stream_of(q),
    )
    _build.check_launch(rc, "relpos_attention_bwd")
    relpos_attention_bwd.launches += 1
    return dq, dk, dv, dp, du, dvb


class _RelPosAttention(torch.autograd.Function):
    """K5 forward (context + lse), K6 backward.  madd gets no gradient;
    each gradient is returned in its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, p, u, vb, madd, scale, causal, rate, seed):
        out, lse = _fwd_kernel(q, k, v, p, u, vb, madd, scale, causal, rate,
                               seed)
        ctx.save_for_backward(q, k, v, p, u, vb, madd, out, lse)
        ctx.scale, ctx.causal, ctx.rate, ctx.seed = scale, causal, rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, p, u, vb, madd, out, lse = ctx.saved_tensors
        dout = dout.float().contiguous()
        dsum = (dout * out).sum(-1)  # outside the kernel, as in JAX
        grads = relpos_attention_bwd(q, k, v, p, u, vb, madd, dout, lse, dsum,
                                     ctx.scale, ctx.causal, ctx.rate, ctx.seed)
        grads = [g.to(t.dtype) for g, t in zip(grads, (q, k, v, p, u, vb))]
        return (*grads, None, None, None, None, None)


def relpos_attention(q, k, v, p, u, vb, madd, scale, causal=False, rate=0.0,
                     seed=0):
    """Rel-pos attention, (B, H, Tp, dh) layout, differentiable; the
    kernels on CUDA.

    q, k, v and p share a dtype (float32 or bfloat16); u, vb and madd
    are used in float32.  On CUDA, Tp must be a multiple of 64 and dh
    one of ``HEAD_DIMS``.  ``rate`` in [0, 1) is the post-softmax
    attention dropout and ``seed`` (an int in [0, 2^64)) fixes its mask;
    the backward regenerates the same mask.  Returns (B, H, Tp, dh)
    float32.  Counts forward kernel launches in
    ``relpos_attention.launches``.
    """
    rate, seed = _dropout_args(rate, seed)
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, p, u, vb, madd, scale, causal,
                                      rate, seed)
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention: unsupported device {q.device}")
    u = u.to(device=q.device, dtype=torch.float32).contiguous()
    vb = vb.to(device=q.device, dtype=torch.float32).contiguous()
    madd = madd.to(device=q.device, dtype=torch.float32).contiguous()
    _check(q, k, v, p, u, vb, madd)
    return _RelPosAttention.apply(q, k, v, p, u, vb, madd, scale, causal, rate,
                                  seed)


relpos_attention.launches = 0
relpos_attention_bwd.launches = 0
