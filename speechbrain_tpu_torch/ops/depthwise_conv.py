"""Depthwise 1-d convolution (conformer convolution module), forward
and backward.

Counterpart of ``speechbrain_tpu/ops/pallas/depthwise_conv.py``:

    out[b,t,c] = sum_k w[k,c] * x[b, t+k-pad_left, c]  (+ bias[c])
    dx         = the same convolution of dy with the flipped taps
    dw[k,c]    = sum_{b,t} dy[b,t,c] * x[b, t+k-pad_left, c]   (f32)
    dbias[c]   = sum_{b,t} dy[b,t,c]   (f32, from dw's pass)

with centered padding ((K-1)//2, K-1-(K-1)//2) or causal padding
(K-1, 0), f32 accumulation.  ``depthwise_conv1d`` is an autograd
Function: on CUDA tensors its forward and dx launch the kernel
``sb_depthwise_conv1d_fwd`` and its dw and dbias the kernel
``sb_depthwise_conv1d_dw`` (both in ``csrc/depthwise_conv.cu``); on CPU
tensors they run the plain versions beside them.
"""

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "depthwise_conv1d",
    "depthwise_conv1d_plain",
    "depthwise_conv1d_dw",
    "depthwise_conv1d_dw_plain",
]


def _pad(K, causal):
    return (K - 1, 0) if causal else ((K - 1) // 2, K - 1 - (K - 1) // 2)


def _conv_plain(x, w, pad_left):
    """K shifted multiply-adds in f32, zero taps outside [0, T)."""
    K = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x.float(), (0, 0, pad_left, K - 1 - pad_left))
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + xp[:, k : k + T] * wf[k]
    return acc.to(x.dtype)


def depthwise_conv1d_plain(x, w, bias=None, causal=False):
    """Plain PyTorch version: K shifted multiply-adds in f32.

    x : (B, T, C); w : (K, C); bias : (C,) or None.  Returns x's dtype;
    the bias is added after the cast, as the JAX package does.
    Differentiable by autograd.

    Example
    -------
    >>> x = torch.ones(2, 8, 4); w = torch.ones(3, 4)
    >>> depthwise_conv1d_plain(x, w)[0, :, 0].tolist()
    [2.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0]
    """
    out = _conv_plain(x, w, _pad(w.shape[0], causal)[0])
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def depthwise_conv1d_dw_plain(x, dy, K, causal=False, bias_grad=False):
    """Plain version of the taps' gradient: the K-tap sum over (b, t) in
    f32.  x, dy : (B, T, C); returns (K, C) float32, and with
    ``bias_grad`` also dbias = the sum of dy over (b, t), (C,) float32.

    Example
    -------
    >>> x = torch.ones(1, 4, 2); dy = torch.ones(1, 4, 2)
    >>> depthwise_conv1d_dw_plain(x, dy, 3)[:, 0].tolist()
    [3.0, 4.0, 3.0]
    >>> depthwise_conv1d_dw_plain(x, dy, 3, bias_grad=True)[1].tolist()
    [4.0, 4.0]
    """
    T = x.shape[1]
    left, right = _pad(K, causal)
    xp = F.pad(x.float(), (0, 0, left, right))
    dyf = dy.float()
    dw = torch.stack([(xp[:, k : k + T] * dyf).sum((0, 1)) for k in range(K)])
    return (dw, dyf.sum((0, 1))) if bias_grad else dw


def _check(x, w, name):
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(
            f"{name}: x (B, T, C) and w (K, C), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )


_FWD = _build.Entry("depthwise_conv", "sb_depthwise_conv1d_fwd",
                    [_build.P] * 4 + [_build.I] * 8 + [_build.P])
_DW_SCRATCH = _build.Entry("depthwise_conv", "sb_depthwise_conv1d_dw_scratch",
                           [_build.I] * 4, _build.I64)
_DW_TILES = _build.Entry("depthwise_conv", "sb_depthwise_conv1d_dw_tiles",
                         [_build.I])
_DW = _build.Entry("depthwise_conv", "sb_depthwise_conv1d_dw",
                   [_build.P] * 6 + [_build.I] * 7 + [_build.P])

# (B, T, C, K) -> (floats of the taps' gradient's scratch, channel tiles)
_DW_PLANS = {}
# (device index, stream handle) -> the tile counters of the taps'
# gradient: zero, and left zero by every launch; one set a stream, since
# calls on one stream run in order
_DW_COUNTERS = {}


def _dw_counters(t, tiles, stream):
    key = (t.device.index, stream)
    counters = _DW_COUNTERS.get(key)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 64), dtype=torch.int32,
                               device=t.device)
        _DW_COUNTERS[key] = counters
    return counters


def _fwd_kernel(x, w, bias, pad_left, flip=False):
    """Launch K1 on contiguous CUDA tensors of one dtype (checked by the
    caller); ``flip`` reads the taps as ``w[K-1-k]`` (the input
    gradient)."""
    B, T, C = x.shape
    out = torch.empty_like(x)
    ptr = x.data_ptr()
    rc = _FWD(
        ptr, w.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), B, T, C, w.shape[0], pad_left, int(flip),
        int((C * x.element_size()) % 16 == 0 and ptr % 16 == 0),
        _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check_launch(rc, "depthwise_conv1d")
    depthwise_conv1d.launches += 1
    return out


def depthwise_conv1d_dw(x, dy, K, causal=False, bias_grad=False):
    """Taps' gradient dw (K, C) float32 of ``x`` (B, T, C) and ``dy``
    (B, T, C); with ``bias_grad`` also dbias (C,) float32, the sum of
    dy over (b, t), from the same pass.  The kernel on CUDA tensors (x
    and dy of one dtype, float32 or bfloat16): one launch;
    ``depthwise_conv1d_dw_plain`` on the CPU.  Counts its launches in
    ``depthwise_conv1d_dw.launches``.
    """
    if x.device.type == "cpu":
        return depthwise_conv1d_dw_plain(x, dy, K, causal, bias_grad)
    if x.device.type != "cuda":
        raise RuntimeError(f"depthwise_conv1d_dw: unsupported device {x.device}")
    _build.refuse_grad("depthwise_conv1d_dw", x, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype or x.dim() != 3:
        raise ValueError("depthwise_conv1d_dw: x and dy must be (B, T, C) "
                         "of one dtype")
    if not 1 <= K <= 1024:
        raise ValueError(f"depthwise_conv1d_dw: K={K} outside [1, 1024]")
    code = _build.dtype_code(x)
    x, dy = x.contiguous(), dy.contiguous()
    B, T, C = x.shape
    dw = torch.empty(K, C, dtype=torch.float32, device=x.device)
    dbias = (torch.empty(C, dtype=torch.float32, device=x.device)
             if bias_grad else None)
    if B * T * C == 0:  # nothing to sum, nothing launched
        dw.zero_()
        if bias_grad:
            dbias.zero_()
        return (dw, dbias) if bias_grad else dw
    shape = (B, T, C, K)
    plan = _DW_PLANS.get(shape)
    if plan is None:
        plan = _DW_PLANS[shape] = (_DW_SCRATCH(B, T, C, K), _DW_TILES(C))
    n_scratch, tiles = plan
    partial = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    stream = _build.stream_of(x)
    xp, dp = x.data_ptr(), dy.data_ptr()
    vec16 = (C * x.element_size()) % 16 == 0 and xp % 16 == 0 and dp % 16 == 0
    rc = _DW(xp, dp, partial.data_ptr(), _dw_counters(x, tiles, stream).data_ptr(),
             dw.data_ptr(), dbias.data_ptr() if bias_grad else None,
             B, T, C, K, _pad(K, causal)[0], int(vec16), code, stream)
    _build.check_launch(rc, "depthwise_conv1d_dw")
    depthwise_conv1d_dw.launches += 1
    return (dw, dbias) if bias_grad else dw


class _DepthwiseConv1d(torch.autograd.Function):
    """Forward K1 (+ bias); backward dx = K1 reading the taps flipped,
    with the complementary left padding, dw and dbias (the sum of dy)
    from one K2 launch.
    ``kernel`` selects the CUDA kernels (True) or the plain versions
    (False)."""

    @staticmethod
    def forward(ctx, x, w, bias, causal, kernel):
        ctx.save_for_backward(x, w)
        ctx.causal, ctx.kernel = causal, kernel
        ctx.bias_dtype = None if bias is None else bias.dtype
        left = _pad(w.shape[0], causal)[0]
        if kernel:
            return _fwd_kernel(x, w, bias, left)
        return depthwise_conv1d_plain(x, w, bias, causal)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        K = w.shape[0]
        dy = dy.contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            left = K - 1 - _pad(K, ctx.causal)[0]
            dx = (_fwd_kernel(dy, w, None, left, flip=True) if ctx.kernel
                  else _conv_plain(dy, w.flip(0), left))
        want_bias = ctx.bias_dtype is not None and ctx.needs_input_grad[2]
        if ctx.needs_input_grad[1] or want_bias:
            # K2 returns dbias from the pass that makes dw
            dw = (depthwise_conv1d_dw if ctx.kernel
                  else depthwise_conv1d_dw_plain)(x, dy, K, ctx.causal,
                                                  bias_grad=want_bias)
            if want_bias:
                dw, dbias = dw
                dbias = dbias.to(ctx.bias_dtype)
            dw = dw.to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, dbias, None, None


def depthwise_conv1d(x, w, bias=None, causal=False):
    """Depthwise conv, same-length output, differentiable; the kernels
    on CUDA tensors.

    ``w`` and ``bias`` are cast to ``x``'s dtype (float32 or bfloat16)
    before the call, so their gradients come back in their own dtypes;
    the kernel sums in f32, rounds to ``x``'s dtype, then adds the bias
    and rounds again (the JAX package's order).  Where autograd records
    nothing (no grad mode, or no input that requires grad) the kernel is
    launched without the autograd Function.  Counts kernel launches
    (forward and dx) in ``depthwise_conv1d.launches``.
    """
    if x.device.type == "cpu":
        return _DepthwiseConv1d.apply(x, w, bias, causal, False)
    if x.device.type != "cuda":
        raise RuntimeError(f"depthwise_conv1d: unsupported device {x.device}")
    _check(x, w, "depthwise_conv1d")
    _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError("depthwise_conv1d: x must be contiguous")
    B, T, C = x.shape
    if T * C >= 1 << 31:
        raise ValueError("depthwise_conv1d: T * C must be below 2^31")
    if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
        w = w.to(device=x.device, dtype=x.dtype).contiguous()
    if bias is not None:
        if bias.shape != (C,):
            raise ValueError("depthwise_conv1d: bias must be (C,)")
        if bias.dtype != x.dtype or bias.device != x.device:
            bias = bias.to(device=x.device, dtype=x.dtype)
        bias = bias.contiguous()
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (bias is not None and bias.requires_grad)):
        return _DepthwiseConv1d.apply(x, w, bias, causal, True)
    return _fwd_kernel(x, w, bias, _pad(w.shape[0], causal)[0])


depthwise_conv1d.launches = 0
depthwise_conv1d_dw.launches = 0
