"""Attention with the Transformer-XL relative-position bias, forward.

Counterpart of ``speechbrain_tpu/ops/pallas/relpos_attention.py``:

    s[q,k] = ((q + u) . k_k + (q + vb) . p[T-1-q+k]) * scale + madd[k]
    (s = -1e9 where causal and k > q), out = softmax(s) @ v  (f32)

On a CUDA tensor ``relpos_attention`` launches the flash-style kernel in
``csrc/relpos_attention.cu``, which never forms a (T, T) tensor; on a
CPU tensor it runs ``relpos_attention_plain``, the materialized form
(equal to the JAX ``relpos_attention_reference``).  Forward only: the
backward belongs to the training slice.
"""

import torch

from . import _build

__all__ = ["relpos_attention", "relpos_attention_plain"]

NEG = -1e9
BLOCK = 64  # query/key tile of the kernel: Tp must be a multiple
HEAD_DIMS = (16, 32, 36, 64)  # head widths the kernel is built for


def relpos_attention_plain(q, k, v, p, u, vb, madd, scale, causal=False):
    """Plain PyTorch version: materialized content and position scores.

    q, k, v : (B, H, Tp, dh); p : (H, 2T-1, dh); u, vb : (H, dh);
    madd : (B, Tp) additive key mask.  Position indices T-1-q+k are
    clipped to [0, 2T-2] (only padded rows q >= T reach the clip).
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
    return torch.einsum("bhqk,bhkd->bhqd", attn, vf)


def relpos_attention(q, k, v, p, u, vb, madd, scale, causal=False):
    """Rel-pos attention, (B, H, Tp, dh) layout; the kernel on CUDA.

    q, k, v and p share a dtype (float32 or bfloat16); u, vb and madd
    are used in float32.  On CUDA, Tp must be a multiple of 64 and dh
    one of ``HEAD_DIMS``.  Returns (B, H, Tp, dh) float32.  Counts
    kernel launches in ``relpos_attention.launches``.
    """
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, p, u, vb, madd, scale, causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention: unsupported device {q.device}")
    B, H, Tp, dh = q.shape
    T = (p.shape[1] + 1) // 2
    code = _build.dtype_code(q)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("relpos_attention: q, k, v must share a shape")
    if p.shape != (H, 2 * T - 1, dh) or T > Tp:
        raise ValueError("relpos_attention: p must be (H, 2T-1, dh), T <= Tp")
    if any(t.dtype != q.dtype for t in (k, v, p)):
        raise TypeError("relpos_attention: q, k, v, p must share a dtype")
    if Tp % BLOCK or dh not in HEAD_DIMS:
        raise ValueError(
            f"relpos_attention: needs Tp % {BLOCK} == 0 and dh in "
            f"{HEAD_DIMS}, got Tp={Tp}, dh={dh}"
        )
    if not all(t.is_contiguous() for t in (q, k, v, p)):
        raise ValueError("relpos_attention: q, k, v, p must be contiguous")
    u = u.to(device=q.device, dtype=torch.float32).contiguous()
    vb = vb.to(device=q.device, dtype=torch.float32).contiguous()
    madd = madd.to(device=q.device, dtype=torch.float32).contiguous()
    if u.shape != (H, dh) or vb.shape != (H, dh) or madd.shape != (B, Tp):
        raise ValueError("relpos_attention: u, vb (H, dh), madd (B, Tp)")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = _build.entry(
        "relpos_attention", "sb_relpos_attention_fwd",
        [_build.P] * 8 + [_build.I] * 5 + [_build.F, _build.I, _build.I,
                                           _build.P],
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), madd.data_ptr(), out.data_ptr(),
        B, H, Tp, T, dh, float(scale), int(bool(causal)), code,
        _build.stream_of(q),
    )
    _build.check_launch(rc, "relpos_attention")
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0
