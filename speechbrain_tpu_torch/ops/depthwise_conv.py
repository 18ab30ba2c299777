"""Depthwise 1-d convolution (conformer convolution module), forward.

Counterpart of ``speechbrain_tpu/ops/pallas/depthwise_conv.py``:

    out[b,t,c] = sum_k w[k,c] * x[b, t+k-pad_left, c]  (+ bias[c])

with centered padding ((K-1)//2, K-1-(K-1)//2) or causal padding
(K-1, 0), f32 accumulation.  On a CUDA tensor ``depthwise_conv1d``
launches the kernel in ``csrc/depthwise_conv.cu``; on a CPU tensor it
runs ``depthwise_conv1d_plain``, the explicit K-tap shifted sum.
"""

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["depthwise_conv1d", "depthwise_conv1d_plain"]


def _pad(K, causal):
    return (K - 1, 0) if causal else ((K - 1) // 2, K - 1 - (K - 1) // 2)


def depthwise_conv1d_plain(x, w, bias=None, causal=False):
    """Plain PyTorch version: K shifted multiply-adds in f32.

    x : (B, T, C); w : (K, C); bias : (C,) or None.  Returns x's dtype;
    the bias is added after the cast, as the JAX package does.

    Example
    -------
    >>> x = torch.ones(2, 8, 4); w = torch.ones(3, 4)
    >>> depthwise_conv1d_plain(x, w)[0, :, 0].tolist()
    [2.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0]
    """
    K = w.shape[0]
    T = x.shape[1]
    left, right = _pad(K, causal)
    xp = F.pad(x.float(), (0, 0, left, right))
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + xp[:, k : k + T] * wf[k]
    out = acc.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def depthwise_conv1d(x, w, bias=None, causal=False):
    """Depthwise conv, same-length output; the kernel on CUDA tensors.

    ``w`` and ``bias`` are cast to ``x``'s dtype (float32 or bfloat16);
    the kernel accumulates in f32 and adds the bias before its single
    rounding.  Counts its launches in ``depthwise_conv1d.launches``.
    """
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w, bias, causal)
    if x.device.type != "cuda":
        raise RuntimeError(f"depthwise_conv1d: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(
            f"depthwise_conv1d: x (B, T, C) and w (K, C), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    code = _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError("depthwise_conv1d: x must be contiguous")
    w = w.to(device=x.device, dtype=x.dtype).contiguous()
    if bias is not None:
        if bias.shape != (x.shape[2],):
            raise ValueError("depthwise_conv1d: bias must be (C,)")
        bias = bias.to(device=x.device, dtype=x.dtype).contiguous()
    B, T, C = x.shape
    K = w.shape[0]
    out = torch.empty_like(x)
    fn = _build.entry(
        "depthwise_conv", "sb_depthwise_conv1d_fwd",
        [_build.P] * 4 + [_build.I] * 6 + [_build.P],
    )
    rc = fn(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), B, T, C, K, _pad(K, causal)[0], code,
        _build.stream_of(x),
    )
    _build.check_launch(rc, "depthwise_conv1d")
    depthwise_conv1d.launches += 1
    return out


depthwise_conv1d.launches = 0
