"""Fused beam-search self-cache step: permute + append + causal attend.

Counterpart of ``speechbrain_tpu/ops/pallas/beam_cache.py``.  The cache
is the merged time-minor K|V layout ``(n, H*Dh, 2L)``: K at lanes
[0, L), V at lanes [L, 2L).  For each beam row i the step copies cache
row ``rows[i]``, writes the new K at lane ``pos`` and the new V at lane
``L + pos``, and attends the pre-scaled query over lanes <= pos per
head.  On a CUDA tensor ``beam_attend_step`` launches the kernel in
``csrc/beam_cache.cu``; on a CPU tensor it runs
``beam_attend_step_plain``, which is ``_xla_ref`` (gather +
``append_attend``, named after its JAX counterpart) with the same casts.
"""

import torch

from . import _build

__all__ = ["beam_attend_step", "beam_attend_step_plain", "append_attend"]

_NEG = -1e30


def _append_attend_(kv, pos, q, k_new, v_new, H):
    """``append_attend`` writing the new columns into ``kv`` itself."""
    n, HD, L2 = kv.shape
    L = L2 // 2
    Dh = HD // H
    kv[:, :, pos] = k_new.to(kv.dtype)
    kv[:, :, L + pos] = v_new.to(kv.dtype)
    kf = kv[:, :, :L].reshape(n, H, Dh, L).float()
    vf = kv[:, :, L:].reshape(n, H, Dh, L).float()
    qf = q.reshape(n, H, Dh).float()
    s = torch.einsum("nhd,nhdl->nhl", qf, kf)
    lane = torch.arange(L, device=kv.device)
    s = s.masked_fill(lane > pos, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("nhl,nhdl->nhd", p, vf).reshape(n, HD)
    return out, kv


def append_attend(kv, pos, q, k_new, v_new, H):
    """Column append + causal attend over a merged time-minor cache, no
    beam permutation; returns ``(ctx (n, H*Dh) f32, new cache)`` and
    leaves ``kv`` as it was.

    Example
    -------
    >>> kv = torch.zeros(2, 4, 16); t = torch.ones(2, 4)
    >>> out, kv2 = append_attend(kv, 0, t, t, t, 2)
    >>> out.shape, float(kv2[0, 0, 0]), float(kv[0, 0, 0])
    (torch.Size([2, 4]), 1.0, 0.0)
    """
    return _append_attend_(kv.clone(), pos, q, k_new, v_new, H)


def _xla_ref(kv, rows, pos, q, k_new, v_new, H):
    """Plain version of the fused step: gather the predecessor rows,
    then ``append_attend`` (the gather already made a fresh tensor)."""
    kv = kv.index_select(0, rows.long())
    return _append_attend_(kv, pos, q, k_new, v_new, H)


def beam_attend_step_plain(kv, rows, q, k_new, v_new, pos, nhead, dst=None):
    """``beam_attend_step``'s plain version, on any device: the same
    dtype casts and ``dst`` handling around ``_xla_ref``."""
    out, new = _xla_ref(kv, rows, int(pos), q.to(kv.dtype),
                        k_new.to(kv.dtype), v_new.to(kv.dtype), nhead)
    if dst is not None:
        new = dst.copy_(new)
    return out, new


def _check_disjoint(a, b):
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    if a0 < b1 and b0 < a1:
        raise ValueError(
            "beam_attend_step: dst overlaps the cache being read; the "
            "permutation is many-to-one, so it must be another buffer"
        )


def beam_attend_step(kv, rows, q, k_new, v_new, pos, nhead, dst=None):
    """Fused permute + append + self-attend over a merged time-minor
    K|V cache.

    Arguments
    ---------
    kv : (n, H*Dh, 2L) cache, float32 or bfloat16.
    rows : (n,) int predecessor rows: output row i is built from cache
        row ``rows[i]``.
    q : (n, H*Dh) pre-scaled query (times 1/sqrt(Dh) upstream).
    k_new, v_new : (n, H*Dh) this step's K/V, written at lanes ``pos``
        and ``L + pos``.
    pos : int decode position; lanes > pos are masked.
    nhead : number of heads H.
    dst : optional (n, H*Dh, 2L) buffer of the cache's dtype, not
        overlapping ``kv``; the new cache is written into it and it is
        returned.  Its contents are ignored.

    Returns ``(ctx (n, H*Dh) float32, new cache)``.  q, k_new and v_new
    are cast to the cache dtype first, as in the JAX package (and made
    contiguous: they are one row each).  Counts
    kernel launches in ``beam_attend_step.launches``.
    """
    q = q.to(kv.dtype).contiguous()
    k_new = k_new.to(kv.dtype).contiguous()
    v_new = v_new.to(kv.dtype).contiguous()
    pos = int(pos)
    n, HD, L2 = kv.shape
    if not 0 <= pos < L2 // 2:
        raise ValueError(f"beam_attend_step: pos {pos} outside [0, {L2 // 2})")
    if dst is not None:
        if dst.shape != kv.shape or dst.dtype != kv.dtype:
            raise ValueError("beam_attend_step: dst must match kv")
        _check_disjoint(kv, dst)
    if kv.device.type == "cpu":
        return beam_attend_step_plain(kv, rows, q, k_new, v_new, pos, nhead,
                                      dst)
    if kv.device.type != "cuda":
        raise RuntimeError(f"beam_attend_step: unsupported device {kv.device}")
    code = _build.dtype_code(kv)
    if HD % nhead:
        raise ValueError("beam_attend_step: H*Dh not divisible by nhead")
    if (HD * L2 * kv.element_size()) % 16 or kv.data_ptr() % 16:
        raise ValueError(
            "beam_attend_step: a cache row must be whole, aligned 16-byte "
            "words (2L * itemsize a multiple of 16)"
        )
    if not kv.is_contiguous():
        raise ValueError("beam_attend_step: kv must be contiguous")
    if q.shape != (n, HD) or k_new.shape != (n, HD) or v_new.shape != (n, HD):
        raise ValueError("beam_attend_step: q/k_new/v_new must be (n, H*Dh)")
    rows = rows.to(device=kv.device, dtype=torch.int32).contiguous()
    if rows.shape != (n,):
        raise ValueError("beam_attend_step: rows must be (n,)")
    ctx = torch.empty((n, HD), dtype=torch.float32, device=kv.device)
    new = dst if dst is not None else torch.empty_like(kv)
    fn = _build.entry(
        "beam_cache", "sb_beam_attend_step",
        [_build.P] * 7 + [_build.I] * 6 + [_build.P],
    )
    rc = fn(
        kv.data_ptr(), rows.data_ptr(), q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ctx.data_ptr(), new.data_ptr(),
        n, nhead, HD // nhead, L2 // 2, pos, code, _build.stream_of(kv),
    )
    _build.check_launch(rc, "beam_attend_step")
    beam_attend_step.launches += 1
    return ctx, new


beam_attend_step.launches = 0
