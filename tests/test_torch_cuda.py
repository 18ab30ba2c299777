"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips when no CUDA card is present.

On a machine with the card (no JAX needed, so the JAX conftest is
skipped):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from speechbrain_tpu_torch import ops
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL, RelPosMHAXL
from speechbrain_tpu_torch.ops.beam_cache import _xla_ref
from speechbrain_tpu_torch.ops.relpos_attention import _fwd_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A CUDA generator; skips the test when there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_depthwise_conv1d_kernel(gen, dtype, causal):
    x = torch.randn(3, 37, 20, device="cuda", generator=gen).to(dtype)
    w = torch.randn(7, 20, device="cuda", generator=gen).to(dtype) / 3
    b = torch.randn(20, device="cuda", generator=gen).to(dtype)
    before = ops.depthwise_conv1d.launches
    got = ops.depthwise_conv1d(x, w, b, causal=causal)
    ref = ops.depthwise_conv1d_plain(x, w, b, causal=causal)
    assert ops.depthwise_conv1d.launches == before + 1
    # bf16: both round the f32 sum, then the bias sum (JAX's order); the
    # sums differ only by FMA contraction, so at most one bf16 ulp apart
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(ref)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


def _bf16_ulp(t):
    """One bf16 ulp at max|t|: the spacing of bf16 values there."""
    m = float(t.float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("K", [3, 4, 15, 17, 31])
@pytest.mark.parametrize("T", [1, 30, 31, 100, 251, 512])
@pytest.mark.parametrize("C", [1, 7, 144, 256, 512])
def test_depthwise_conv1d_kernel_edges(gen, C, T, K, causal, dtype):
    """K1's time tiles, channel groups and vector paths at their edges: T
    below K and not a multiple of the 32-step tile, C odd, not a multiple
    of the vector width, and over one group (256, 512); K with its taps in
    registers (3, 15, 31) and read from L1 (4, 17).  The forward with and
    without a bias and the dx (taps read flipped) against the plain
    versions; two calls give the same bits."""
    from speechbrain_tpu_torch.ops.depthwise_conv import _conv_plain, _fwd_kernel, _pad

    x = torch.randn(3, T, C, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(K, C, device="cuda", generator=gen) / K ** 0.5).to(dtype)
    b = (0.1 * torch.randn(C, device="cuda", generator=gen)).to(dtype)
    left = _pad(K, causal)[0]
    for bias in (None, b):
        got = ops.depthwise_conv1d(x, w, bias, causal=causal)
        ref = ops.depthwise_conv1d_plain(x, w, bias, causal=causal)
        tol = 1e-4 if dtype == torch.float32 else _bf16_ulp(ref)
        torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)
        assert torch.equal(got, ops.depthwise_conv1d(x, w, bias, causal=causal))
    dx = _fwd_kernel(x, w, None, K - 1 - left, flip=True)
    ref = _conv_plain(x, w.flip(0), K - 1 - left)
    tol = 1e-4 if dtype == torch.float32 else _bf16_ulp(ref)
    torch.testing.assert_close(dx.float(), ref.float(), atol=tol, rtol=0)
    assert torch.equal(dx, _fwd_kernel(x, w, None, K - 1 - left, flip=True))


def test_depthwise_conv1d_dx_is_one_launch_without_a_flipped_copy(gen):
    """The backward's dx (x alone requires grad) is one K1 launch that
    reads the taps flipped: no flip or copy of w runs on the card."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4, 45, 144, device="cuda", generator=gen, requires_grad=True)
    w = torch.randn(31, 144, device="cuda", generator=gen) / 6
    dy = torch.randn(4, 45, 144, device="cuda", generator=gen)
    out = ops.depthwise_conv1d(x, w)
    torch.cuda.synchronize()
    before = ops.depthwise_conv1d.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (dx,) = torch.autograd.grad(out, x, dy)
        torch.cuda.synchronize()
    assert ops.depthwise_conv1d.launches == before + 1
    names = [e.name for e in prof.events()]
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not any("flip" in n for n in names), names
    assert len(kernels) == 1 and "depthwise_conv1d_fwd" in kernels[0], kernels
    ref = ops.depthwise_conv1d_plain(dy, w.flip(0))  # centered K = 31
    torch.testing.assert_close(dx, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp", [(128, 128), (100, 128), (512, 512)])
def test_relpos_attention_kernel(gen, dtype, causal, T, Tp):
    B, H, dh = 2, 3, 36
    mk = lambda *s: (0.5 * torch.randn(*s, device="cuda", generator=gen)).to(dtype)  # noqa: E731
    q, k, v, p = mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(H, 2 * T - 1, dh)
    u, vb = mk(H, dh).float(), mk(H, dh).float()
    madd = torch.zeros(B, Tp, device="cuda")
    madd[:, T:] = -1e9
    madd[1, T // 2:] = -65000.0
    got = ops.relpos_attention(q, k, v, p, u, vb, madd, 0.1, causal)
    ref = ops.relpos_attention_plain(q, k, v, p, u, vb, madd, 0.1, causal)
    _assert_relpos_close(got, ref, (q, k, v, p, u, vb, madd, 0.1, causal), T)


def _assert_relpos_close(got, ref, args, T, rate=0.0, seed=0):
    """K5's output against the plain version's (rows below T).  f32:
    3xTF32 products, ~f32 rounding, sums in other orders (as the CUDA-core
    design before it was held).  bf16: the operands of each product
    rounded to bf16 where JAX's kernel rounds them, so within 1e-2 of
    max|ref| of the f32 plain version, and within 2e-3 of the
    rounding-point reference that takes the keys in the kernel's 64-key
    tiles (each weight rounded against the running max)."""
    from speechbrain_tpu_torch.ops.relpos_attention import _relpos_attention_rounded

    got, ref = got[:, :, :T], ref[:, :, :T]
    if args[0].dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
        return
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-2 * scale
    rounded = _relpos_attention_rounded(*args, rate, seed, key_tile=64)[0]
    assert float((got - rounded[:, :, :T]).abs().max()) <= 2e-3 * scale


def _assert_beam_ctx(ctx, ref, new, H, pos, dtype):
    """K7's context against the plain version, which rounds the weights
    where the kernel does.  f32: 1e-5.  bf16: 1e-5 too, but CUDA's expf
    and the sums' order move a weight's last f32 bit, and a weight on a
    bf16 rounding midpoint then rounds one bf16 step (at most 2^-8 for a
    weight below 1) the other way: that moves the whole head, so at most
    1 % of the heads (and at least one) may differ, each element by at
    most 2^-8 * sum_l |v[l]| over the lanes <= pos."""
    n, HD = ctx.shape
    L = new.shape[2] // 2
    diff = (ctx - ref).abs()
    close = diff <= 1e-5 + 1e-5 * ref.abs()
    if dtype == torch.float32:
        assert bool(close.all()), float(diff.max())
        return
    bad_heads = int((~close).reshape(n, H, -1).any(-1).sum())
    assert bad_heads <= max(1, n * H // 100), (bad_heads, float(diff.max()))
    v = new[:, :, L:L + pos + 1].float().abs().sum(-1)
    assert bool((diff <= 2.0 ** -8 * v + 1e-5).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 63, 255])
def test_beam_attend_step_kernel(gen, dtype, pos):
    n, H, Dh, L = 12, 4, 36, 256
    kv = torch.randn(n, H * Dh, 2 * L, device="cuda", generator=gen).to(dtype)
    rows = torch.tensor([3, 3, 0, 5, 1, 1, 7, 3, 11, 11, 11, 2], device="cuda")
    q, kn, vn = (torch.randn(n, H * Dh, device="cuda", generator=gen).to(dtype) / 6
                 for _ in range(3))
    dst = torch.empty_like(kv)
    ctx, new = ops.beam_attend_step(kv, rows, q, kn, vn, pos, H, dst=dst)
    ref_ctx, ref_new = _xla_ref(kv, rows, pos, q, kn, vn, H)
    assert new.data_ptr() == dst.data_ptr()
    assert torch.equal(new, ref_new)  # bit for bit
    _assert_beam_ctx(ctx, ref_ctx, new, H, pos, dtype)


def _beam_rows(kind, n, gen):
    if kind == "identity":
        return torch.arange(n, device="cuda")
    if kind == "same":
        return torch.full((n,), n // 2, device="cuda", dtype=torch.long)
    if kind == "reversed":
        return torch.arange(n - 1, -1, -1, device="cuda")
    # many-to-one: every row from the first ceil(n / 3)
    return torch.randint(0, (n + 2) // 3, (n,), device="cuda", generator=gen)


# (n, H, Dh, L): the beam counts around the serving shape (1, 3, 80,
# 100 rows); heads and widths; L of 128, 256, 1024 and the largest L
# that the first kernel's shared-memory limit, (H*Dh + H*L) * 4 <= 48 KB,
# allowed at H4 Dh36 (3036) and at H1 Dh8 (12280: the scores alone take
# 48 KB); "half" is an L whose half row is not whole 16-byte words (f32
# 130, bf16 132: the 8-byte copies); Dh 64 and 200 split the rows of a
# tile into chunks
_BEAM_EDGES = [
    (1, 4, 36, 256), (3, 4, 36, 256), (80, 4, 36, 256), (100, 4, 36, 256),
    (5, 1, 8, 128), (5, 2, 36, 1024), (5, 8, 64, 128), (4, 4, 64, 1024),
    (3, 4, 36, 3036), (2, 1, 8, 12280), (4, 2, 8, "half"), (2, 1, 200, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["first", "second", "last"])
@pytest.mark.parametrize("shape", _BEAM_EDGES, ids=str)
def test_beam_attend_step_kernel_edges(gen, shape, where, dtype):
    """K7 at its edges against the plain version, over four kinds of
    rows (identity, all the same, reversed, many-to-one), int32 and
    int64 rows, strided (``qkv.chunk`` views) and contiguous q/k/v, with
    and without ``dst``: the cache bit for bit, the context as
    ``_assert_beam_ctx`` states; two calls give the same bits."""
    n, H, Dh, L = shape
    if L == "half":
        L = 130 if dtype == torch.float32 else 132
    HD = H * Dh
    pos = {"first": 0, "second": 1, "last": L - 1}[where]
    kv = torch.randn(n, HD, 2 * L, device="cuda", generator=gen).to(dtype)
    qkv = (torch.randn(n, 3 * HD, device="cuda", generator=gen) / 6).to(dtype)
    for v, kind in enumerate(("identity", "same", "reversed", "many")):
        rows = _beam_rows(kind, n, gen)
        if v % 2:
            rows = rows.to(torch.int32)
        q, kn, vn = qkv.chunk(3, dim=-1)
        if v >= 2:
            q, kn, vn = q.contiguous(), kn.contiguous(), vn.contiguous()
        dst = torch.empty_like(kv) if v in (0, 3) else None
        ctx, new = ops.beam_attend_step(kv, rows, q, kn, vn, pos, H, dst=dst)
        ref_ctx, ref_new = _xla_ref(kv, rows, pos, q, kn, vn, H)
        assert dst is None or new.data_ptr() == dst.data_ptr()
        assert torch.equal(new, ref_new), kind
        _assert_beam_ctx(ctx, ref_ctx, new, H, pos, dtype)
        ctx2, new2 = ops.beam_attend_step(kv, rows, q, kn, vn, pos, H)
        assert torch.equal(ctx, ctx2) and torch.equal(new, new2), kind


def test_beam_attend_step_decoder_call_is_one_launch(gen):
    """The decoder's call (q scaled, k and v strided views of the fused
    projection, the search's int64 rows) issues K7 and nothing else.
    Over three calls."""
    from torch.profiler import ProfilerActivity, profile

    n, H, Dh, L = 80, 4, 36, 256
    kv = torch.randn(n, H * Dh, 2 * L, device="cuda", generator=gen)
    qkv = torch.randn(n, 3 * H * Dh, device="cuda", generator=gen)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q * (1.0 / math.sqrt(Dh))
    rows = torch.randint(0, 36, (n,), device="cuda", generator=gen)
    dst = torch.empty_like(kv)
    ops.beam_attend_step(kv, rows, q, k, v, 57, H, dst=dst)  # loads the library
    torch.cuda.synchronize()
    before = ops.beam_attend_step.launches
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ctx, new = ops.beam_attend_step(kv, rows, q, k, v, 57, H, dst=dst)
        torch.cuda.synchronize()
    # the wrapper launched K7 once a call; the profiler saw no other
    # kernel (it may miss the first launch of its window: the count is
    # bounded, the names are exact)
    assert ops.beam_attend_step.launches == before + calls
    kernels = {e.key: e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0}
    assert len(kernels) == 1, kernels
    assert all("beam_attend_step" in k for k in kernels), kernels
    assert sum(kernels.values()) <= calls, kernels
    ref_ctx, ref_new = _xla_ref(kv, rows, 57, q, k, v, H)
    assert torch.equal(new, ref_new)
    _assert_beam_ctx(ctx, ref_ctx, new, H, 57, torch.float32)


@pytest.mark.parametrize("T", [256, 512])
def test_relpos_mha_routes_long_inputs_to_the_kernel(gen, T):
    """T = 512 takes the kernel (the JAX gate, on CUDA); T = 256 the
    materialized path.  Both agree with the plain route."""
    torch.manual_seed(0)
    m = RelPosMHAXL(144, 4).cuda()
    with torch.no_grad():
        m.pos_bias_u.normal_(0, 0.1)
        m.pos_bias_v.normal_(0, 0.1)
    x = torch.randn(2, T, 144, device="cuda", generator=gen)
    kpm = torch.zeros(2, T, dtype=torch.bool, device="cuda")
    kpm[1, T - 40:] = True
    pe = RelPosEncXL(144)(x)
    before = ops.relpos_attention.launches
    with torch.no_grad():
        out, _ = m(x, x, x, pe, key_padding_mask=kpm)
        assert ops.relpos_attention.launches == before + (T == 512)
        m.use_kernels = False
        ref, _ = m(x, x, x, pe, key_padding_mask=kpm)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_depthwise_conv1d_backward_kernels(gen, dtype, causal):
    """K1 on flipped taps (dx) and K2 (dw) inside the autograd Function
    against autograd through the plain version."""
    x = torch.randn(4, 45, 150, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(9, 150, device="cuda", generator=gen) / 3).to(dtype)
    b = torch.randn(150, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(4, 45, 150, device="cuda", generator=gen).to(dtype)
    grads = []
    for fn in (ops.depthwise_conv1d, ops.depthwise_conv1d_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        before = (ops.depthwise_conv1d.launches, ops.depthwise_conv1d_dw.launches)
        fn(*leaves, causal=causal).backward(dy)
        grads.append([t.grad.float() for t in leaves])
        if fn is ops.depthwise_conv1d:
            assert (ops.depthwise_conv1d.launches,
                    ops.depthwise_conv1d_dw.launches) == (before[0] + 2, before[1] + 1)
    # f32: sums in other orders; bf16: both round dx, dw and dbias once
    # from f32 sums, at most a bf16 ulp or two of each gradient's scale
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, ref in zip(*grads):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_conv1d_dw_kernel(gen, dtype):
    x = torch.randn(3, 70, 130, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(3, 70, 130, device="cuda", generator=gen).to(dtype)
    for causal in (False, True):
        got = ops.depthwise_conv1d_dw(x, dy, 31, causal)
        ref = ops.depthwise_conv1d_dw_plain(x, dy, 31, causal)
        assert got.dtype == torch.float32
        # the same f32 products, summed in other orders
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def _dw_tol(x, dy, K, causal):
    """K2 against its plain version: the same f32 products summed in
    other orders (the kernel: rows in a thread, then time groups, then
    chunks), within 1e-5 of the sum of the products' magnitudes, and
    dbias within 1e-5 of the sum of |dy|."""
    dw_abs, db_abs = ops.depthwise_conv1d_dw_plain(
        x.float().abs(), dy.float().abs(), K, causal, bias_grad=True)
    return 1e-5 * dw_abs + 1e-6, 1e-5 * db_abs + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [3, 4, 15, 31, 17])
@pytest.mark.parametrize("C", [1, 7, 130, 144, 512])
@pytest.mark.parametrize("T", [1, 30, 31, 64, 65, 251, 512])
@pytest.mark.parametrize("B", [1, 3, 32])
def test_depthwise_conv1d_dw_kernel_edges(gen, B, T, C, K, dtype):
    """K2 at its edges, centred and causal, with and without the bias
    gradient: T below K and around the chunk lengths, C odd, not a
    multiple of the 16-channel tile or of the 16-byte copies, K with its
    taps in registers (3, 4, 15, 31) and in groups of 8 (17); dw and
    dbias against the plain version (``_dw_tol``), the same bits twice."""
    x = torch.randn(B, T, C, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(B, T, C, device="cuda", generator=gen).to(dtype)
    for causal in (False, True):
        ref_dw, ref_db = ops.depthwise_conv1d_dw_plain(x, dy, K, causal,
                                                       bias_grad=True)
        tol_dw, tol_db = _dw_tol(x, dy, K, causal)
        dw, db = ops.depthwise_conv1d_dw(x, dy, K, causal, bias_grad=True)
        assert dw.dtype == db.dtype == torch.float32
        assert bool(((dw - ref_dw).abs() <= tol_dw).all()), float((dw - ref_dw).abs().max())
        assert bool(((db - ref_db).abs() <= tol_db).all()), float((db - ref_db).abs().max())
        dw2, db2 = ops.depthwise_conv1d_dw(x, dy, K, causal, bias_grad=True)
        assert torch.equal(dw, dw2) and torch.equal(db, db2)
        assert torch.equal(dw, ops.depthwise_conv1d_dw(x, dy, K, causal))


def test_depthwise_conv1d_backward_with_bias_is_two_launches(gen):
    """The backward of a conv with a bias (x, w and b require grad) is
    K1 reading the taps flipped (dx) and one K2 launch (dw and dbias):
    no other kernel runs on the card (f32: no casts).  Over three calls."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4, 45, 144, device="cuda", generator=gen, requires_grad=True)
    w = (torch.randn(31, 144, device="cuda", generator=gen) / 6).requires_grad_(True)
    b = torch.randn(144, device="cuda", generator=gen, requires_grad=True)
    dy = torch.randn(4, 45, 144, device="cuda", generator=gen)
    out = ops.depthwise_conv1d(x, w, b)
    torch.autograd.grad(out, (x, w, b), dy, retain_graph=True)  # first call
    torch.cuda.synchronize()
    before = (ops.depthwise_conv1d.launches, ops.depthwise_conv1d_dw.launches)
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            dx, dw, db = torch.autograd.grad(out, (x, w, b), dy, retain_graph=True)
        torch.cuda.synchronize()
    # the wrappers launched K1 and K2 once a call; the profiler saw no
    # other kernel (it may miss the first launch of its window: the
    # count is bounded, the names are exact)
    assert (ops.depthwise_conv1d.launches - before[0],
            ops.depthwise_conv1d_dw.launches - before[1]) == (calls, calls)
    kernels = {e.key: e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0}
    assert len(kernels) == 2, kernels
    assert any("depthwise_conv1d_dw_kernel" in k for k in kernels), kernels
    assert any("depthwise_conv1d_fwd" in k for k in kernels), kernels
    assert sum(kernels.values()) <= 2 * calls, kernels
    ref_dw, ref_db = ops.depthwise_conv1d_dw_plain(x.detach(), dy, 31,
                                                   bias_grad=True)
    tol_dw, tol_db = _dw_tol(x.detach(), dy, 31, False)
    assert bool(((dw - ref_dw).abs() <= tol_dw).all())
    assert bool(((db - ref_db).abs() <= tol_db).all())


@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_kernels(gen, blank):
    """K3 (alpha, loss) and K4 (gradient) against the plain recursions,
    float32, with ragged lengths, repeated labels and U_b = 0."""
    B, T, C, U = 6, 50, 40, 9
    lp = torch.log_softmax(torch.randn(B, T, C, device="cuda", generator=gen), -1)
    tg = torch.randint(1, C, (B, U), device="cuda", generator=gen)
    tg[tg == blank] = blank + 1
    tg[:, 3] = tg[:, 2]
    tlen = torch.tensor([50, 31, 44, 50, 20, 9], device="cuda")
    ulen = torch.tensor([9, 5, 9, 0, 7, 3], device="cuda")
    tg[1, 5:] = C + 7  # padding past U_b may hold anything
    tg[3] = -1
    g = torch.randn(B, device="cuda", generator=gen)
    alpha, loss, logz = ops.ctc_alpha(lp, tg, tlen, ulen, blank)
    alpha_p, loss_p, logz_p = ops.ctc_alpha_plain(lp, tg, tlen, ulen, blank)
    torch.testing.assert_close(loss, loss_p, atol=1e-4, rtol=1e-5)
    dlp = ops.ctc_beta_grad(lp, tg, tlen, ulen, blank, alpha, logz, g)
    dlp_p = ops.ctc_beta_grad_plain(lp, tg, tlen, ulen, blank, alpha_p, logz_p, g)
    # the same recursion; exp/log1p of the two libraries differ in ulps
    torch.testing.assert_close(dlp, dlp_p, atol=1e-5, rtol=1e-4)


def _ctc_edge_inputs(gen, B, T, U, C, blank, idx_dtype, variant0):
    """Log-probs, targets and lengths whose sequences take turns through
    the edge cases (sequence i: case (variant0 + i) % 6): full lengths
    with a repeated label; T_b = 0; T_b > T and U_b > U; U_b = 0; all
    labels one class; labels of any class (the blank too) with garbage
    past U_b."""
    lp = torch.log_softmax(torch.randn(B, T, C, device="cuda", generator=gen), -1)
    tg = torch.randint(0, C, (B, U), device="cuda", generator=gen)
    tg[tg == blank] = (blank + 1) % C
    tlen = torch.randint(1, T + 1, (B,), device="cuda", generator=gen)
    ulen = torch.randint(0, U + 1, (B,), device="cuda", generator=gen)
    for i in range(B):
        case = (variant0 + i) % 6
        if case == 0:
            tlen[i], ulen[i] = T, U
            if U >= 2:
                tg[i, 1] = tg[i, 0]
        elif case == 1:
            tlen[i] = 0
        elif case == 2:
            tlen[i], ulen[i] = T + 7, U + 3
        elif case == 3:
            ulen[i] = 0
        elif case == 4:
            tg[i] = (blank + 1) % C
        else:
            tg[i] = torch.randint(0, C, (U,), device="cuda", generator=gen)
            ub = int(ulen[i])
            tg[i, ub:ub + 1] = C + 7  # padding past U_b may hold anything
            tg[i, ub + 1:] = -1
    return lp, tg.to(idx_dtype), tlen.to(idx_dtype), ulen.to(idx_dtype)


# one U past the warp path's WARP_STATES = 257 (2U+1 = 301)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("U", [0, 1, 15, 16, 31, 32, 40, 128, 150])
@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 251])
@pytest.mark.parametrize("B", [1, 3, 32])
def test_ctc_kernels_edges(gen, B, T, U, idx_dtype):
    """K3 and K4 against their plain recursions at every side of the warp
    kernels' steps (2U+1 = 1 ... 257 states, NC = 1 ... 9 a lane; 301
    takes the block path), chunk edges in T, ragged and out-of-range
    lengths, int32 and int64 targets and lengths taken as they come;
    blank 0 or 5 and C = 3 (< S), 37 (< S from U = 19; not a multiple of
    4: the fill's scalar head and tail) or 5000, by case.  Loss, alpha's
    live part and the gradient at test_ctc_kernels' tolerances; rows
    t >= T_b and classes outside the lattice exactly 0; two calls give
    the same bits."""
    case = B + 7 * T + 3 * U
    blank, C = ((0, 3), (5, 37), (0, 5000), (5, 6))[case % 4]
    lp, tg, tlen, ulen = _ctc_edge_inputs(gen, B, T, U, C, blank, idx_dtype,
                                          case)
    g = torch.randn(B, device="cuda", generator=gen)
    args = (lp, tg, tlen, ulen, blank)
    alpha, loss, logz = ops.ctc_alpha(*args)
    alpha_p, loss_p, logz_p = ops.ctc_alpha_plain(*args)
    dlp = ops.ctc_beta_grad(*args, alpha, logz, g)
    dlp_p = ops.ctc_beta_grad_plain(*args, alpha_p, logz_p, g)
    alpha2, loss2, logz2 = ops.ctc_alpha(*args)
    dlp2 = ops.ctc_beta_grad(*args, alpha2, logz2, g)
    torch.cuda.synchronize()
    tb = tlen.long().clamp(0, T)
    sb = 2 * ulen.long().clamp(0, U) + 1
    live = torch.zeros(B, T, 2 * U + 1, dtype=torch.bool, device="cuda")
    lattice = torch.zeros(B, T, C, dtype=torch.bool, device="cuda")
    for b in range(B):
        live[b, : max(int(tb[b]), 1), : int(sb[b])] = True
        classes = [blank] + [min(max(int(c), 0), C - 1)
                             for c in tg[b, : (int(sb[b]) - 1) // 2]]
        lattice[b, : int(tb[b]), classes] = True
    torch.testing.assert_close(loss, loss_p, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(alpha[live], alpha_p[live], atol=1e-4, rtol=1e-5)
    # the same recursion; exp/log1p of the two libraries differ in ulps
    torch.testing.assert_close(dlp, dlp_p, atol=1e-5, rtol=1e-4)
    assert bool((dlp[~lattice] == 0).all())
    assert torch.equal(alpha2[live], alpha[live]) and torch.equal(loss2, loss)
    assert torch.equal(logz2, logz) and torch.equal(dlp2, dlp)


def test_ctc_log1p_unit_is_log1pf_bit_for_bit(gen):
    """The lattice kernels' branch-free log1p gives CUDA's log1pf's bits
    for every float in [0, 1], the only arguments their lae passes it."""
    from speechbrain_tpu_torch.ops.ctc import _log1p_unit_mismatches

    assert _log1p_unit_mismatches(torch.device("cuda")) == 0


LAUNCH_CALLS = 3  # calls in a launch test's profiled window


def _launch_window(kind):
    """Run in a fresh process by ``_kernels_of``: build ``kind``'s inputs
    at the training shape, call its wrapper once (the library loads,
    first-call allocations), then profile ``LAUNCH_CALLS`` calls.  Returns
    ``{"kernels": {device kernel: count}, "launches": the wrapper's
    count over the window}``."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind.startswith("ctc"):
        B, T, C, U = 32, 251, 5000, 40
        lp = torch.log_softmax(
            torch.randn(B, T, C, device="cuda", generator=gen), -1)
        tg = torch.randint(1, C, (B, U), device="cuda", generator=gen)
        tlen = torch.tensor([T - (i % 8) * 4 for i in range(B)], device="cuda",
                            dtype=torch.int32)
        ulen = torch.tensor([U - (i % 5) for i in range(B)], device="cuda",
                            dtype=torch.int32)
        g = torch.randn(B, device="cuda", generator=gen)
        args = (lp, tg, tlen, ulen, 0)
        alpha, _, logz = ops.ctc_alpha(*args)
        wrapper = getattr(ops, kind)
        fn = {"ctc_alpha": lambda: ops.ctc_alpha(*args),
              "ctc_beta_grad": lambda: ops.ctc_beta_grad(*args, alpha, logz, g),
              }[kind]
    else:
        ot = ops.transducer
        tables, _, _, tl, ul = _transducer_tables(gen, 12, 251, 64, True)
        alpha, final = ot._alpha_kernel(*tables, tl, ul)
        wrapper = getattr(ot, kind)
        fn = {"transducer_alpha": lambda: ot._alpha_kernel(*tables, tl, ul),
              "transducer_beta_grad": lambda: ot._beta_grad_kernel(
                  *tables, alpha, tl, ul, final)}[kind]
    fn()
    torch.cuda.synchronize()
    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCH_CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0}
    return {"kernels": kernels, "launches": wrapper.launches - before}


def _kernels_of(kind):
    """``_launch_window(kind)`` in a new Python process.  The card's
    profiler (torch 2.11.0+cu128) records windows with no kernel at all
    once a process has profiled a few, so a launch count read in this
    long test process would depend on the tests before it; a fresh
    process profiles this window alone."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import json; from tests import test_torch_cuda as t; "
            f"print(json.dumps(t._launch_window({kind!r})))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _assert_one_kernel(kind, name):
    """The window's device kernels: one name, ``name``; at most one
    launch a call (the profiler may miss the first of a window), at
    least one in all; and the wrapper counted every call."""
    got = _kernels_of(kind)
    kernels = got["kernels"]
    assert got["launches"] == LAUNCH_CALLS, got
    assert len(kernels) == 1, kernels
    assert all(name in k for k in kernels), kernels
    assert 1 <= sum(kernels.values()) <= LAUNCH_CALLS, kernels


def test_ctc_wrappers_are_one_launch(gen):
    """At the training shape (B32 T251 C5000 U40; int64 targets, int32
    lengths, as ``ctc_loss`` passes them) each of K3 and K4 is one device
    kernel a call: no casts or clamps around it.  Over three calls, each
    wrapper profiled in a process of its own."""
    _assert_one_kernel("ctc_alpha", "ctc_alpha_warp_kernel")
    _assert_one_kernel("ctc_beta_grad", "ctc_beta_grad_warp_kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp", [(128, 128), (100, 128), (512, 512)])
def test_relpos_attention_backward_kernel(gen, dtype, causal, T, Tp):
    """K6 through the autograd Function against autograd through the
    plain version: all six gradients, padded rows included."""
    B, H, dh = 2, 3, 36
    mk = lambda *s: (0.5 * torch.randn(*s, device="cuda", generator=gen)).to(dtype)  # noqa: E731
    q, k, v, p = mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(H, 2 * T - 1, dh)
    u, vb = mk(H, dh).float(), mk(H, dh).float()
    madd = torch.zeros(B, Tp, device="cuda")
    madd[:, T:] = -1e9
    madd[1, T // 2:] = -65000.0
    dout = torch.randn(B, H, Tp, dh, device="cuda", generator=gen)
    dout[:, :, T:] = 0.0
    grads = []
    for fn in (ops.relpos_attention, ops.relpos_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, p, u, vb)]
        before = ops.relpos_attention_bwd.launches
        fn(*leaves, madd, 0.1, causal).backward(dout)
        grads.append([t.grad.float() for t in leaves])
        if fn is ops.relpos_attention:
            assert ops.relpos_attention_bwd.launches == before + 1
    # f32 arithmetic from the same stored values; the gradients come back
    # in the inputs' dtype (bf16: one rounding of each)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, ref in zip(*grads):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp", [(100, 128), (512, 512), (1024, 1024)])
@pytest.mark.parametrize("dh", [16, 32, 36, 64])
def test_relpos_attention_bwd_kernel_widths(gen, dh, T, Tp, causal, rate, dtype):
    """K6 on the tensor cores against the plain gradients at every head
    width the kernels are built for (36 is padded to the MMA depth), with
    and without dropout, padded rows (the clipped band rows) included; two
    calls with one seed give the same bits (no atomics)."""
    (q, k, v, p, u, vb, madd), dout = _relpos_inputs(gen, dtype, T, Tp, dh=dh)
    scale = dh ** -0.5
    out, lse = _fwd_kernel(q, k, v, p, u, vb, madd, scale, causal, rate, 5)
    dsum = (dout * out).sum(-1)
    before = ops.relpos_attention_bwd.launches
    args = (q, k, v, p, u, vb, madd, dout, lse, dsum, scale, causal, rate, 5)
    got = ops.relpos_attention_bwd(*args)
    again = ops.relpos_attention_bwd(*args)
    assert ops.relpos_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ops.relpos_attention_bwd_plain(q, k, v, p, u, vb, madd, dout, scale,
                                         causal, rate, 5)
    # f32: 3xTF32 products, ~f32 rounding, sums in other orders.  bf16:
    # JAX's rounding points (q+u, q+vb, dO, dS, P keep/(1-rate) to bf16
    # before each product) against f32 autograd: each product's operands
    # carry a relative error up to 2^-9
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("dq", "dk", "dv", "dp", "du", "dvb"), got, ref):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= tol, (name, err)


def _relpos_inputs(gen, dtype, T, Tp, B=2, H=3, dh=36):
    """q, k, v, p in ``dtype``, f32 u, vb, a key mask with the T..Tp pad
    and a shorter second utterance, and a cotangent zero past T."""
    mk = lambda *s: (0.5 * torch.randn(*s, device="cuda", generator=gen)).to(dtype)  # noqa: E731
    q, k, v, p = mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(H, 2 * T - 1, dh)
    u, vb = mk(H, dh).float(), mk(H, dh).float()
    madd = torch.zeros(B, Tp, device="cuda")
    madd[:, T:] = -1e9
    madd[1, T // 2:] = -65000.0
    dout = torch.randn(B, H, Tp, dh, device="cuda", generator=gen)
    dout[:, :, T:] = 0.0
    return (q, k, v, p, u, vb, madd), dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp", [(100, 128), (512, 512)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_relpos_attention_dropout_kernel(gen, dtype, causal, T, Tp, rate):
    """K5 with dropout against the plain version with the same seed (the
    same mask by construction); one seed gives the same bits twice,
    another seed another output."""
    args, _ = _relpos_inputs(gen, dtype, T, Tp)
    before = ops.relpos_attention.launches
    got = ops.relpos_attention(*args, 0.1, causal, rate, 1234)
    again = ops.relpos_attention(*args, 0.1, causal, rate, 1234)
    other = ops.relpos_attention(*args, 0.1, causal, rate, 1235)
    ref = ops.relpos_attention_plain(*args, 0.1, causal, rate, 1234)
    assert ops.relpos_attention.launches == before + 3
    assert torch.equal(got, again)
    assert float((got - other)[:, :, :T].abs().max()) > 1e-3
    _assert_relpos_close(got, ref, (*args, 0.1, causal), T, rate, 1234)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp", [(100, 128), (512, 512), (1024, 1024)])
@pytest.mark.parametrize("dh", [16, 32, 36, 64])
def test_relpos_attention_fwd_kernel_widths(gen, dh, T, Tp, causal, rate, dtype):
    """K5 on the tensor cores at every head width the kernels are built
    for (36 is padded to the MMA depth), with and without dropout, padded
    rows included: out against the plain version (and, in bf16, the
    rounding-point reference), lse against the materialized scores of the
    same arithmetic; two calls give the same bits."""
    from speechbrain_tpu_torch.ops.relpos_attention import _relpos_attention_rounded

    (q, k, v, p, u, vb, madd), _ = _relpos_inputs(gen, dtype, T, Tp, dh=dh)
    scale = dh ** -0.5
    args = (q, k, v, p, u, vb, madd, scale, causal, rate, 5)
    before = ops.relpos_attention.launches
    out, lse = _fwd_kernel(*args)
    again = _fwd_kernel(*args)
    assert ops.relpos_attention.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref = ops.relpos_attention_plain(*args)
    _assert_relpos_close(out, ref, args[:9], T, rate, 5)
    # lse: f32 against the f32 scores; bf16 against the scores of the
    # rounded operands (the same products, sums in other orders)
    if dtype == torch.bfloat16:
        ref_lse = _relpos_attention_rounded(*args, key_tile=64)[1]
    else:
        ref_lse = torch.logsumexp(_plain_scores(*args[:9]), -1)
    torch.testing.assert_close(lse[:, :, :T], ref_lse[:, :, :T], atol=1e-4,
                               rtol=1e-5)


def _plain_scores(q, k, v, p, u, vb, madd, scale, causal):
    """The materialized f32 scores of ``relpos_attention_plain``."""
    B, H, Tp, _ = q.shape
    T = (p.shape[1] + 1) // 2
    content = torch.einsum("bhqd,bhkd->bhqk", q.float() + u[None, :, None],
                           k.float())
    ps = torch.einsum("bhqd,hld->bhql", q.float() + vb[None, :, None], p.float())
    ar = torch.arange(Tp, device=q.device)
    idx = (T - 1 - ar[:, None] + ar[None, :]).clamp(0, 2 * T - 2)
    s = (content + torch.gather(ps, -1, idx.expand(B, H, Tp, Tp))) * scale
    s = s + madd[:, None, None, :]
    if causal:
        s = s.masked_fill(ar[None, :] > ar[:, None], -1e9)
    return s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp", [(100, 128), (512, 512)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_relpos_attention_dropout_backward_kernel(gen, dtype, causal, T, Tp, rate):
    """K6 with dropout through the autograd Function against autograd
    through the plain version with the same seed: all six gradients,
    padded rows (pass D's clipped pairs) included."""
    (q, k, v, p, u, vb, madd), dout = _relpos_inputs(gen, dtype, T, Tp)
    grads = []
    for fn in (ops.relpos_attention, ops.relpos_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, p, u, vb)]
        before = ops.relpos_attention_bwd.launches
        fn(*leaves, madd, 0.1, causal, rate, 99).backward(dout)
        grads.append([t.grad.float() for t in leaves])
        if fn is ops.relpos_attention:
            assert ops.relpos_attention_bwd.launches == before + 1
    # as without dropout: f32 from the same stored values, the gradients
    # returned in the inputs' dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, ref in zip(*grads):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("B,T,U,ub,C", [(2, 1100, 520, 520, 30),
                                        (2, 1500, 700, 700, 12),
                                        (1, 1500, 8499, 1400, 3)])
def test_ctc_kernels_wide(gen, B, T, U, ub, C):
    """K3 and K4 on lattices wider than a block has threads (2U+1 = 1041
    and 1401: two states a thread; 16999: 32 states a thread, one frame
    gathered at a time, 2801 of them live) against the plain recursions."""
    lp = torch.log_softmax(torch.randn(B, T, C, device="cuda", generator=gen), -1)
    tg = torch.randint(1, C, (B, U), device="cuda", generator=gen)
    tg[:, 1] = tg[:, 0]
    tlen = torch.tensor([T - 5 * i for i in range(B)], device="cuda")
    ulen = torch.tensor([ub - 3 * i for i in range(B)], device="cuda")
    g = torch.randn(B, device="cuda", generator=gen)
    alpha, loss, logz = ops.ctc_alpha(lp, tg, tlen, ulen, 0)
    alpha_p, loss_p, logz_p = ops.ctc_alpha_plain(lp, tg, tlen, ulen, 0)
    torch.testing.assert_close(loss, loss_p, atol=2e-2, rtol=1e-5)
    dlp = ops.ctc_beta_grad(lp, tg, tlen, ulen, 0, alpha, logz, g)
    dlp_p = ops.ctc_beta_grad_plain(lp, tg, tlen, ulen, 0, alpha_p, logz_p, g)
    torch.testing.assert_close(dlp, dlp_p, atol=2e-3, rtol=1e-4)


def test_relpos_mha_other_head_widths_take_the_materialized_path(gen):
    """d_head 18 (144 / 8) is no width the kernels are built for: at
    T = 512 on CUDA the module takes the materialized path (JAX's kernel
    takes any width) instead of raising, and matches the plain route."""
    m = RelPosMHAXL(144, 8).cuda().eval()
    x = torch.randn(2, 512, 144, device="cuda", generator=gen)
    pe = RelPosEncXL(144)(x)
    before = ops.relpos_attention.launches
    with torch.no_grad():
        out, attn = m(x, x, x, pe)
        m.use_kernels = False
        ref, _ = m(x, x, x, pe)
    assert ops.relpos_attention.launches == before
    assert attn is not None and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_relpos_dropout_kernel_mask_is_the_plain_mask(gen):
    """With v = the identity (dh = Tp = 64) K5's output is the dropped
    weights themselves: zero exactly where the plain mask drops."""
    B, H, T = 2, 2, 64
    q = 0.5 * torch.randn(B, H, T, T, device="cuda", generator=gen)
    v = torch.eye(T, device="cuda").expand(B, H, T, T).contiguous()
    p = 0.5 * torch.randn(H, 2 * T - 1, T, device="cuda", generator=gen)
    z = torch.zeros(H, T, device="cuda")
    out = ops.relpos_attention(q, q, v, p, z, z, torch.zeros(B, T, device="cuda"),
                               0.1, False, 0.3, (7 << 32) + 5)
    keep = ops.relpos_dropout_keep(B, H, T, 0.3, (7 << 32) + 5, "cuda")
    assert torch.equal(out > 0, keep)


def _transducer_inputs(gen, B, T, U, V):
    """Logits (B, T, U+1, V), labels 1..V-1 padded with 0 past U_b, and
    ragged frame and label counts (U_b <= 40 and a U_b = U row)."""
    logits = torch.randn(B, T, U + 1, V, device="cuda", generator=gen)
    tg = torch.randint(1, V, (B, U), device="cuda", generator=gen)
    tlen = torch.tensor([max(1, T - 7 * (i % 4)) for i in range(B)],
                        device="cuda")
    ulen = torch.tensor([U if i == 1 else max(0, min(U, 40) - 3 * (i % 5))
                         for i in range(B)], device="cuda")
    tg[torch.arange(U, device="cuda")[None, :] >= ulen[:, None]] = 0
    return logits, tg, tlen, ulen


def _transducer_tables(gen, B, T, U, edges=False):
    """The masked tables of ``_transducer_inputs`` (V 16), its lengths and
    the same as the kernels take them (int32); with ``edges`` (B >= 4)
    the last row has T_b = 0 and the third U_b = 0."""
    logits, tg, tlen, ulen = _transducer_inputs(gen, B, T, U, 16)
    if edges:
        assert B >= 4
        tlen[B - 1] = 0
        ulen[2] = 0
    tables = ops.transducer.transducer_tables(
        torch.log_softmax(logits, -1), tg, 0, tlen, ulen)
    tl, ul = ops.transducer._validated(tlen, ulen, T, U, tables[0].device, "t")
    return tables, tlen, ulen, tl, ul


# the warp-chain path's edges (U+1 = 1 ... 160: one to five chain warps;
# 161 and 257 take the block path), at T 251 and T 1, B 4 with a T_b = 0
# row, a U_b = 0 row and a U_b = U row
_CHAIN_WIDTHS = [(4, T, U) for T in (251, 1)
                 for U in (0, 31, 32, 63, 64, 95, 96, 127, 128, 159, 160, 256)]


@pytest.mark.parametrize("B,T,U", [(12, 251, 64), (12, 1001, 64), (2, 37, 256),
                                   (3, 1, 5), (2, 9, 1023), (2, 9, 1099),
                                   (1, 5, 5000), (1, 3, 16999)] + _CHAIN_WIDTHS)
def test_transducer_kernels(gen, B, T, U):
    """K8 (alpha, final) and K9 (dblank, demit) against their plain
    versions, float32, at the training shapes (B 12, T 251, U 64; the
    CRDNN-transducer's T 1001), T = 1,
    the warp-chain path's edges (U+1 = 1, 32, 33, ..., 129, 160 at T 251
    and T 1) and the block path: U+1 = 161 and 257 (several warps),
    1024 (one column a thread), and lattices wider than a block has
    threads: U+1 = 1100 (two columns a thread), 5001 (eight) and 17000
    (32, the inputs loaded when each cell is reached instead of
    prefetched).  At the path's edges the last row has T_b = 0 (final 0,
    zero gradients) and the third U_b = 0."""
    edges = (B, T, U) in _CHAIN_WIDTHS
    tables, tlen, ulen, _, _ = _transducer_tables(gen, B, T, U, edges)
    before = (ops.transducer_alpha.launches, ops.transducer_beta_grad.launches)
    alpha, final = ops.transducer_alpha(*tables, tlen, ulen)
    alpha_p, final_p = ops.transducer_alpha_plain(*tables, tlen, ulen)
    grads = ops.transducer_beta_grad(*tables, alpha, tlen, ulen, final)
    grads_p = ops.transducer_beta_grad_plain(*tables, alpha_p, tlen, ulen,
                                             final_p)
    assert (ops.transducer_alpha.launches,
            ops.transducer_beta_grad.launches) == (before[0] + 1, before[1] + 1)
    # the same recursion, cell by cell in the same order; expf/logf of the
    # two libraries differ in ulps, ~1e-4 at |alpha| ~ 1e3
    torch.testing.assert_close(final, final_p, atol=1e-3, rtol=2e-5)
    torch.testing.assert_close(alpha, alpha_p, atol=1e-3, rtol=2e-5)
    for got, ref in zip(grads, grads_p):  # occupancies in [-1, 0]
        torch.testing.assert_close(got, ref, atol=2e-3, rtol=0)
    if edges:
        assert final[B - 1] == 0
        assert not grads[0][B - 1].any() and not grads[1][B - 1].any()


@pytest.mark.parametrize("B,T,U", [(12, 251, 64), (4, 251, 256), (4, 1, 0),
                                   (2, 9, 1099)])
def test_transducer_kernels_repeat_their_bits(gen, B, T, U):
    """Two calls of K8 and of K9 give identical tensors (each element is
    written by one thread, no float atomics), on the warp-chain path and
    the block path (U+1 = 1100)."""
    tables, _, _, tl, ul = _transducer_tables(gen, B, T, U, B >= 4)
    ot = ops.transducer
    runs = []
    for _ in range(2):
        alpha, final = ot._alpha_kernel(*tables, tl, ul)
        runs.append((alpha, final,
                     *ot._beta_grad_kernel(*tables, alpha, tl, ul, final)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_transducer_kernels_are_one_launch(gen):
    """At the training shape (B12 T251 U64) each of K8 and K9 is one device
    kernel a call, the warp-chain kernels by exact name.  Over three
    calls, each kernel profiled in a process of its own."""
    _assert_one_kernel("transducer_alpha", "transducer_alpha_chain_kernel")
    _assert_one_kernel("transducer_beta_grad",
                       "transducer_beta_grad_chain_kernel")


@pytest.mark.parametrize("normalize_by_T", [False, True])
def test_transducer_loss_logits_kernels_vs_plain(gen, normalize_by_T):
    """The logits entry through K8/K9 against its plain route: the loss and
    d loss / d logits, with a T_b = 0 row (loss 0, zero gradient)."""
    logits, tg, tlen, ulen = _transducer_inputs(gen, 5, 40, 12, 30)
    tlen[3] = 0
    g = torch.randn(5, device="cuda", generator=gen)
    out = []
    for use_kernels in (True, False):
        x = logits.clone().requires_grad_(True)
        loss = ops.transducer_loss_logits(x, tg, tlen, ulen, 0, normalize_by_T,
                                          use_kernels=use_kernels)
        loss.backward(g)
        out.append((loss.detach(), x.grad))
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-3, rtol=2e-5)
    torch.testing.assert_close(out[0][1], out[1][1], atol=2e-3, rtol=0)
    assert out[0][0][3] == 0 and not out[0][1][3].any()


def test_every_kernel_wrapper_keeps_the_graph(gen):
    """On CUDA inputs that require grad, each differentiable wrapper's
    result requires grad (the kernels sit inside autograd Functions);
    the decode-only beam step refuses such inputs."""
    x = torch.randn(2, 9, 4, device="cuda", generator=gen, requires_grad=True)
    assert ops.depthwise_conv1d(x, torch.randn(3, 4, device="cuda")).requires_grad
    q = torch.randn(1, 1, 64, 16, device="cuda", generator=gen, requires_grad=True)
    p = torch.randn(1, 127, 16, device="cuda", generator=gen)
    z = torch.zeros(1, 16, device="cuda")
    out = ops.relpos_attention(q, q, q, p, z, z, torch.zeros(1, 64, device="cuda"), 0.25)
    assert out.requires_grad
    out.sum().backward()
    assert q.grad is not None
    q.grad = None
    out = ops.relpos_attention(q, q, q, p, z, z, torch.zeros(1, 64, device="cuda"),
                               0.25, False, 0.1, 3)
    assert out.requires_grad
    out.sum().backward()
    assert q.grad is not None
    lp = torch.log_softmax(torch.randn(1, 6, 4, device="cuda", generator=gen), -1)
    lp.requires_grad_(True)
    loss = ops.ctc_loss_per_seq(lp, torch.tensor([[1, 2]], device="cuda"),
                                torch.tensor([6], device="cuda"),
                                torch.tensor([2], device="cuda"), 0)
    assert loss.requires_grad
    loss.sum().backward()
    assert lp.grad is not None
    # the kernels that exist only inside a backward refuse to be recorded
    with pytest.raises(RuntimeError, match="no backward"):
        ops.depthwise_conv1d_dw(x, x, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ctc_alpha(lp, torch.tensor([[1, 2]], device="cuda"),
                      torch.tensor([6], device="cuda"),
                      torch.tensor([2], device="cuda"))
    x = torch.randn(1, 3, 3, 4, device="cuda", generator=gen, requires_grad=True)
    loss = ops.transducer_loss_logits(x, torch.tensor([[1, 2]], device="cuda"),
                                      torch.tensor([3], device="cuda"),
                                      torch.tensor([2], device="cuda"), 0)
    assert loss.requires_grad
    loss.sum().backward()
    assert x.grad is not None
    blank = torch.zeros(1, 3, 3, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.transducer_alpha(blank, torch.zeros(1, 3, 2, device="cuda"),
                             torch.tensor([3]), torch.tensor([2]))
    kv = torch.zeros(2, 8, 8, device="cuda")
    with pytest.raises(RuntimeError, match="decode-only"):
        ops.beam_attend_step(kv, torch.zeros(2, dtype=torch.long, device="cuda"),
                             kv[:, :, 0].clone().requires_grad_(True),
                             kv[:, :, 0], kv[:, :, 0], 1, 2)


def test_wrappers_reject_bad_inputs(gen):
    x = torch.randn(2, 8, 4, device="cuda", generator=gen).to(torch.float16)
    with pytest.raises(TypeError):
        ops.depthwise_conv1d(x, torch.ones(3, 4, device="cuda", dtype=torch.float16))
    kv = torch.zeros(2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="overlaps"):
        ops.beam_attend_step(kv, torch.zeros(2, dtype=torch.long), kv[:, :, 0],
                             kv[:, :, 0], kv[:, :, 0], 1, 2, dst=kv)
    # the rel-pos dropout rate lies in [0, 1)
    q = torch.zeros(1, 1, 64, 16, device="cuda")
    rel = (q, q, q, torch.zeros(1, 127, 16, device="cuda"),
           torch.zeros(1, 16, device="cuda"), torch.zeros(1, 16, device="cuda"),
           torch.zeros(1, 64, device="cuda"), 0.25, False)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            ops.relpos_attention(*rel, rate, 0)
        with pytest.raises(ValueError, match="rate"):
            ops.relpos_attention_bwd(*rel[:7], q, q[..., 0], q[..., 0], 0.25,
                                     False, rate, 0)
    # the lattice kernels: type, layout, lengths, labels, width
    blank = torch.zeros(2, 5, 4, device="cuda")
    emit = torch.zeros(2, 5, 3, device="cuda")
    lens = (torch.tensor([5, 4]), torch.tensor([3, 1]))
    with pytest.raises(TypeError):
        ops.transducer_alpha(blank.double(), emit.double(), *lens)
    with pytest.raises(ValueError, match="contiguous"):
        ops.transducer_alpha(blank.transpose(1, 2).contiguous().transpose(1, 2),
                             emit, *lens)
    with pytest.raises(ValueError, match="length"):
        ops.transducer_alpha(blank, emit, torch.tensor([6, 4]), lens[1])
    with pytest.raises(ValueError, match="length"):
        ops.transducer_beta_grad(blank, emit, blank, lens[0],
                                 torch.tensor([4, 1]), torch.zeros(2))
    with pytest.raises(ValueError, match="shared memory"):
        ops.transducer_alpha(torch.zeros(1, 2, 29057, device="cuda"),
                             torch.zeros(1, 2, 29056, device="cuda"),
                             torch.tensor([2]), torch.tensor([3]))
    lp = torch.zeros(1, 2, 3, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ops.ctc_alpha(lp, torch.ones(1, 9685, dtype=torch.long, device="cuda"),
                      torch.tensor([2]), torch.tensor([1]))
    with pytest.raises(ValueError, match="target"):
        ops.transducer_loss_logits(torch.zeros(1, 2, 3, 4, device="cuda"),
                                   torch.tensor([[1, 4]], device="cuda"),
                                   torch.tensor([2]), torch.tensor([2]), 0)


def test_lm_fused_search_kernels_vs_plain(gen):
    """The recipe's decode on the card (full CTC scoring at 0.4, a
    ``TransformerLM`` fused at 0.6, no eos threshold, length
    normalization) over conformer_small's widths, cut to 2 encoder and 2
    decoder layers: the kernel route and the plain route give the same
    hypotheses from the same encoder states; K7 runs once per decoder
    layer and beam step, K1 once per encoder layer."""
    import numpy as np

    from speechbrain_tpu_torch.asr import (
        CONFORMER_SMALL,
        TRANSFORMER_LM,
        ConformerASR,
        build_transformer_lm,
    )

    cfg = dict(CONFORMER_SMALL, num_encoder_layers=2, num_decoder_layers=2,
               vocab_size=500)
    asr = ConformerASR(cfg, seed=0)
    with torch.no_grad():
        asr.ctc_lin.bias[cfg["blank_index"]] += 8.0
        asr.seq_lin.bias[cfg["eos_index"]] += 5.0
    lm = build_transformer_lm(dict(TRANSFORMER_LM, vocab=500,
                                   num_encoder_layers=2), seed=0)
    sig = 0.1 * torch.randn(3, 48000, device="cuda", generator=gen)
    lens = torch.tensor([1.0, 0.9, 0.7], device="cuda")
    ops.reset_launch_counters()
    enc = asr.encode(sig, lens)
    assert ops.launch_counters()["depthwise_conv1d"] == 2
    searcher = asr.make_searcher(beam_size=6, lm=lm)
    assert (searcher.ctc_score_mode, searcher.lm_weight) == ("full", 0.6)
    steps = [0]
    step = searcher.forward_step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    searcher.forward_step = counted
    ops.reset_launch_counters()
    hyps, scores = searcher(enc, lens)
    assert ops.launch_counters()["beam_attend_step"] == 2 * steps[0] > 0
    asr.set_kernels(False)
    hyps_p, scores_p = asr.make_searcher(beam_size=6, lm=lm)(enc, lens)
    assert hyps == hyps_p
    assert np.isfinite(scores).all()
    np.testing.assert_allclose(scores, scores_p, atol=1e-4, rtol=0)


def test_transducer_search_kernels_vs_plain(gen):
    """The conformer-transducer's serving at full width (12 layers,
    d_model 144, vocab 1000, joint 320, GRU 256; random weights, the
    blank bias raised +4 as a trained model's), B 3 x 4 s: the encoder's
    K1 route and plain route agree, K1 runs once a layer; the recipe's
    beam 4 gives the same hypotheses from both encoders' states, the
    device beam the host beam's, and no frame is force-advanced."""
    import numpy as np

    from speechbrain_tpu_torch.asr import CONFORMER_TRANSDUCER, ConformerTransducer

    model = ConformerTransducer(CONFORMER_TRANSDUCER, seed=0)
    with torch.no_grad():
        model.out_lin.bias[CONFORMER_TRANSDUCER["blank_index"]] += 4.0
    sig = 0.1 * torch.randn(3, 64000, device="cuda", generator=gen)
    lens = torch.tensor([1.0, 0.9, 0.7], device="cuda")
    ops.reset_launch_counters()
    enc = model.encode(sig, lens)
    assert ops.launch_counters()["depthwise_conv1d"] == 12
    enc_p = model.set_kernels(False).encode(sig, lens)
    model.set_kernels(True)
    assert float((enc - enc_p).abs().max()) <= 1e-3
    searcher = model.make_searcher()
    hyps, scores = searcher(enc, lens)
    assert searcher.forced_advance_count == 0
    hyps_p, scores_p = model.make_searcher()(enc_p, lens)
    assert hyps == hyps_p and sum(map(len, hyps)) > 0
    np.testing.assert_allclose(scores, scores_p, atol=1e-4, rtol=0)
    # the random model's beam emits ~3 tokens a frame (T_enc 101)
    toks, tok_lens, dev_scores = searcher.transducer_beam_search_device(
        enc, lens, max_symbols=512)
    assert int(tok_lens.max()) < 512
    assert [toks[b, :tok_lens[b]].tolist() for b in range(3)] == hyps
    np.testing.assert_allclose(dev_scores.cpu().numpy(), scores, atol=1e-4,
                               rtol=0)
    greedy, _ = model.make_searcher(beam_size=1)(enc, lens)
    assert len(greedy) == 3


def test_spec_augment_on_a_cuda_generator(gen):
    """SpecAugment draws on the card's generator with no host sync (the
    sync debug mode raises on one), the same draws for the same seed, and
    draws in their ranges."""
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL
    from speechbrain_tpu_torch.lobes.augment import SpecAugment

    aug = SpecAugment(**CONFORMER_SMALL["augmentation"])
    x = torch.randn(8, 1000, 80, device="cuda", generator=gen)
    outs = []
    for seed in (3, 3, 4):
        g = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(aug(x, g))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    d = aug.draw((4096, 1000, 80), torch.Generator(device="cuda").manual_seed(0))
    lens, pos = d["freq"]
    assert lens.is_cuda and 0 <= int(lens.min()) and int(lens.max()) == 29
    assert int(pos.min()) == 0 and int(pos.max()) == 49
    lens, pos = d["time"]
    assert int(lens.max()) == 39 and int(pos.max()) == 959
    c, w = d["warp"]
    assert 5 <= int(c) < 995 and abs(int(w - c)) <= 5


def test_ctc_kernels_dummy_rows(gen):
    """A batch's dummy rows (T_b = 0, U_b = 0; ``batch_mask`` 0) cost 0
    in K3 as in the plain recursion (the empty path), T_b = 0 with
    U_b > 0 is infeasible, and K4 gives them no gradient."""
    B, T, C, U = 4, 40, 30, 6
    lp = torch.log_softmax(torch.randn(B, T, C, device="cuda", generator=gen), -1)
    tg = torch.randint(1, C, (B, U), device="cuda", generator=gen)
    tlen = torch.tensor([40, 25, 0, 0], device="cuda")
    ulen = torch.tensor([6, 3, 0, 2], device="cuda")
    args = (lp, tg, tlen, ulen, 0)
    alpha, loss, logz = ops.ctc_alpha(*args)
    alpha_p, loss_p, logz_p = ops.ctc_alpha_plain(*args)
    torch.testing.assert_close(loss, loss_p, atol=1e-4, rtol=1e-5)
    assert float(loss[2]) == 0.0 and float(loss[3]) >= 1e29
    g = torch.ones(B, device="cuda")
    dlp = ops.ctc_beta_grad(*args, alpha, logz, g)
    torch.testing.assert_close(
        dlp, ops.ctc_beta_grad_plain(*args, alpha_p, logz_p, g),
        atol=1e-5, rtol=1e-4)
    assert bool((dlp[2:] == 0).all())


class _Stack(torch.nn.Module):
    """A few wide matmuls, so a step takes long enough that a batch
    staged on a side stream would be read early if the streams were not
    ordered."""

    def __init__(self):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(256, 256) for _ in range(4))

    def forward(self, x):
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x


def _cuda_brain(ckpt_dir=None, device="cuda", **run_opts):
    from speechbrain_tpu_torch.core import Brain
    from speechbrain_tpu_torch.utils.checkpoints import Checkpointer

    class Fit(Brain):
        def compute_forward(self, batch, stage):
            return self.modules.net(batch["x"])

        def compute_objectives(self, pred, batch, stage):
            return ((pred - batch["y"]) ** 2).mean()

    torch.manual_seed(0)
    return Fit({"net": _Stack()},
               lambda p: torch.optim.AdamW(p, lr=1e-3), {"lr": 1e-3},
               dict({"device": device, "loss_sync_interval": 1,
                     "noprogressbar": True}, **run_opts),
               checkpointer=None if ckpt_dir is None
               else Checkpointer(ckpt_dir))


def _cuda_loader(n_batches=3):
    import numpy as np

    from speechbrain_tpu_torch.dataio.dataloader import SaveableDataLoader

    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((16, 2048, 256)).astype(np.float32),
                "y": rng.standard_normal((16, 2048, 256)).astype(np.float32)}
               for _ in range(n_batches)]
    return SaveableDataLoader(batches, batch_size=1,
                              collate_fn=lambda exs: exs[0])


def test_staged_fit_on_cuda_matches_sync(gen):
    """Staging on the card (pinned copies on a side stream, the consumer
    waiting on an event, ``record_stream``) changes only the schedule:
    over 3 steps the same losses and parameters, bit for bit."""
    from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter

    runs = []
    for depth in (0, 2):
        brain = _cuda_brain(staging_depth=depth)
        losses = []
        end = brain.on_fit_batch_end
        brain.on_fit_batch_end = lambda b, o, l, s: (losses.append(l),
                                                     end(b, o, l, s))
        brain.fit(EpochCounter(1), _cuda_loader())
        runs.append((losses, brain.modules.state_dict()))
    (sync, sd0), (staged, sd1) = runs
    assert len(sync) == 3 and sync == staged
    for k, v in sd0.items():
        assert torch.equal(v, sd1[k]), k


def test_checkpoint_saved_on_card_loads_on_cpu_and_back(gen, tmp_path):
    """A checkpoint saved on the card recovers on the CPU (modules and
    AdamW state equal, on the CPU), and one saved there recovers on the
    card again."""
    from speechbrain_tpu_torch.utils.checkpoints import Checkpointer
    from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter

    card = _cuda_brain(tmp_path / "a")
    card.fit(EpochCounter(1), _cuda_loader(2))
    card.checkpointer.save_checkpoint()
    cpu = _cuda_brain(tmp_path / "a", device="cpu")
    cpu.checkpointer.recover_if_possible()
    for k, v in card.modules.state_dict().items():
        got = cpu.modules.state_dict()[k]
        assert got.device.type == "cpu" and torch.equal(got, v.cpu()), k
    from speechbrain_tpu_torch.core import _TrainStateRecoverable

    Checkpointer(tmp_path / "b", {
        "brain": cpu, "train_state": _TrainStateRecoverable(cpu),
    }).save_checkpoint()
    back = _cuda_brain(tmp_path / "b")
    back.checkpointer.recover_if_possible()
    s_card, s_back = card.optimizer.state_dict(), back.optimizer.state_dict()
    for i, st in s_card["state"].items():
        for k, v in st.items():
            assert torch.equal(s_back["state"][i][k].cpu(), v.cpu()), (i, k)
    for k, v in card.modules.state_dict().items():
        got = back.modules.state_dict()[k]
        assert got.is_cuda and torch.equal(got, v), k


def test_ligru_on_the_card_matches_the_cpu(gen):
    """The LiGRU (2 layers, bidirectional, training mode, float32, TF32
    off) on the card against the same module on the CPU: outputs, last
    states, the input's and every parameter's gradient, and the running
    statistics after the step, within 1e-5 of each tensor's largest
    entry; its recurrence runs the same PyTorch loop on both."""
    from speechbrain_tpu_torch.nnet.RNN import LiGRU

    torch.manual_seed(0)
    cpu = LiGRU(24, 32, num_layers=2, bidirectional=True).train()
    card = LiGRU(24, 32, num_layers=2, bidirectional=True).cuda().train()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 50, 24)
    hx = torch.randn(4, 3, 32)
    outs = []
    for net, dev in ((cpu, "cpu"), (card, "cuda")):
        xi = x.to(dev).detach().requires_grad_()
        y, h = net(xi, hx=hx.to(dev))
        ((y * y).sum() + (h ** 3).sum()).backward()
        outs.append([y, h, xi.grad] + [p.grad for p in net.parameters()]
                    + list(net.buffers()))
    for a, b in zip(*outs):
        b = b.detach().cpu()
        scale = max(float(a.detach().abs().max()), 1e-6)
        assert float((a.detach() - b).abs().max()) <= 1e-5 * scale


def test_crdnn_transducer_step_kernels_vs_plain(gen):
    """A ``CRDNNTransducerBrain`` training step at full width (train.yaml:
    CNN 64/128, LiGRU 4 x 512, DNN 2 x 512, vocab 1000; dropout 0, no
    SpecAugment), B 2 x 3 s: the loss and every gradient through K8/K9
    against the plain lattice, from the same weights; K8 and K9 launch
    once each on the kernel route and not on the plain one."""
    import numpy as np

    from speechbrain_tpu_torch.asr import CRDNN_TRANSDUCER, CRDNNTransducerBrain
    from speechbrain_tpu_torch.core import Stage

    cfg = dict(CRDNN_TRANSDUCER, dropout=0.0, augmentation=None)
    brain = CRDNNTransducerBrain(cfg, seed=0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 1000, (2, 16))
    tokens[1, 12:] = 0
    batch = brain.prepare_batch({
        "sig": rng.standard_normal((2, 48000)).astype(np.float32),
        "sig_lens": np.array([1.0, 0.8], np.float32), "tokens": tokens,
        "tokens_lens": np.array([1.0, 0.75], np.float32),
        "tokens_blank": np.concatenate([np.zeros((2, 1), np.int64), tokens],
                                       1)})
    names, params = zip(*brain.modules.named_parameters())
    routes = []
    for flag in (True, False):
        saved = {k: v.clone() for k, v in brain.modules.named_buffers()}
        brain.set_kernels(flag).modules.train()
        ops.reset_launch_counters()
        loss = brain._loss(batch, Stage.TRAIN)
        grads = torch.autograd.grad(loss, params)
        counts = ops.launch_counters()
        assert (counts["transducer_alpha"], counts["transducer_beta_grad"]) == (
            (1, 1) if flag else (0, 0))
        with torch.no_grad():
            for k, v in brain.modules.named_buffers():
                v.copy_(saved[k])
        routes.append((float(loss), grads))
    (lk, gk), (lp, gp) = routes
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    G = max(float(g.abs().max()) for g in gp)
    for n, a, b in zip(names, gk, gp):
        assert float((a - b).abs().max()) <= 1e-3 * (float(b.abs().max()) + 1e-3 * G), n


def test_time_domain_augment_on_the_card(gen):
    """``TimeDomainSpecAugment`` (the x-vector recipe's: speeds 95/100/105,
    notches, chunks with a noise fill) on the card: with the same draws
    the same waveforms and lengths as on the CPU (within 1e-6 of their
    scale), and with draws from a card generator, no synchronising call
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one)."""
    from speechbrain_tpu_torch.lobes.augment import TimeDomainSpecAugment

    aug = TimeDomainSpecAugment(sample_rate=16000, drop_chunk_noise_factor=0.5)
    x = torch.randn(4, 16000, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([1.0, 0.8, 0.6, 0.9])
    for seed in range(3):
        draws = aug.draw(x.shape, torch.Generator().manual_seed(seed))
        want = aug(x, lens, draws=draws)
        on_card = {part: {k: None if v is None else v.cuda()
                          for k, v in d.items()} for part, d in draws.items()}
        got = aug.to("cuda")(x.cuda(), lens.cuda(), draws=on_card)
        aug.to("cpu")
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            assert float((a.cpu() - b).abs().max()) <= 1e-6 * scale
    aug.to("cuda")
    xc, lc = x.cuda(), lens.cuda()
    aug(xc, lc, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, new_lens = aug(xc, lc, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == xc.shape and bool(torch.isfinite(out).all())


def test_timit_ctc_step_kernels_vs_plain(gen):
    """A ``timit_ctc.CTCBrain`` training step at full width (train.yaml:
    120 features, CNN 128/256, LiGRU 4 x 512, DNN 2 x 512, 40 outputs;
    dropout 0), B 3 x 2 s with a dummy row (batch mask 0): the loss and
    every gradient through K3/K4 against the plain recursions, from the
    same weights; K3 and K4 launch once each on the kernel route and not
    on the plain one."""
    import numpy as np

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes.timit_ctc import CTCBrain

    brain = CTCBrain({"dropout": 0.0}, run_opts={"seed": 0})
    rng = np.random.default_rng(0)
    phn = rng.integers(1, 40, (3, 30))
    phn[1, 20:] = 0
    batch = brain.prepare_batch({
        "sig": rng.standard_normal((3, 32000)).astype(np.float32),
        "sig_lens": np.array([1.0, 0.7, 1.0], np.float32),
        "phn_encoded": phn,
        "phn_encoded_lens": np.array([1.0, 20 / 30, 1.0], np.float32),
        "batch_mask": np.array([1.0, 1.0, 0.0], np.float32)})
    names, params = zip(*brain.modules.named_parameters())
    routes = []
    for flag in (True, False):
        saved = {k: v.clone() for k, v in brain.modules.named_buffers()}
        brain.set_kernels(flag).modules.train()
        ops.reset_launch_counters()
        loss = brain._loss(batch, Stage.TRAIN)
        grads = torch.autograd.grad(loss, params)
        counts = ops.launch_counters()
        assert (counts["ctc_alpha"], counts["ctc_beta_grad"]) == (
            (1, 1) if flag else (0, 0))
        with torch.no_grad():
            for k, v in brain.modules.named_buffers():
                v.copy_(saved[k])
        routes.append((float(loss), grads))
    (lk, gk), (lp, gp) = routes
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    G = max(float(g.abs().max()) for g in gp)
    for n, a, b in zip(names, gk, gp):
        assert float((a - b).abs().max()) <= 1e-3 * (float(b.abs().max()) + 1e-3 * G), n


@pytest.mark.parametrize("train", [False, True])
def test_ecapa_step_on_the_card_matches_the_cpu(gen, train):
    """The VoxCeleb step's model at ``train_ecapa_tdnn.yaml``'s widths
    (ECAPA 1024 x 4 + 3072, attention 128, 192-d embedding, the AAM head
    of 7205 classes) on B 8 x 2 s of features (``Fbank`` and the sentence
    normalization, computed once on the CPU), with lengths, in eval and
    training mode, on the card against the same weights and features in
    float64 on the CPU, TF32 off (cuDNN's default is on; ``chip_smoke.py``
    turns it off too).  The card's float32 loss within 1e-5 relative.
    In eval mode each float32 gradient within 3e-3 of its tensor's scale
    (or of 5 % of the largest gradient: the attention's conv bias has an
    analytic gradient of 0); the CPU's float32 gradients are within 5e-4
    of the float64 ones (``tools/ecapa_precision_study.py``), and the
    card's cuDNN ones were within 1.2e-3 on an H100.  In training mode
    the BatchNorms' batch statistics enter the backward, and at these
    random weights the float32 gradients are ill conditioned (on the CPU
    up to 6.4e-2 of their scale from the float64 ones; on the card up to
    1.2e-2), so the card runs the step in float64 too and its gradients
    are held within 1e-8 of their scale; the
    float32 step's running statistics within 1e-4 of their scale.  ECAPA
    runs no port kernel (cuDNN and cuBLAS on the card)."""
    import numpy as np

    from speechbrain_tpu_torch.recipes.voxceleb_speaker import SpeakerBrain

    rng = np.random.default_rng(0)
    brain = SpeakerBrain(run_opts={"device": "cpu", "seed": 0})
    lens = torch.from_numpy(rng.uniform(0.5, 1.0, 8).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 7205, 8))
    with torch.no_grad():
        wavs = torch.from_numpy(
            (0.1 * rng.standard_normal((8, 32000))).astype(np.float32))
        feats = brain.normalize(brain.modules.compute_features(wavs), lens)
    model = torch.nn.ModuleDict({k: brain.modules[k]
                                 for k in ("embedding_model", "classifier")})
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    def step(dev, dtype):
        model.load_state_dict(initial)
        net = model.to(dev, dtype).train(train)
        names, params = zip(*net.named_parameters())
        ops.reset_launch_counters()
        emb = net["embedding_model"](feats.to(dev, dtype), lens.to(dev))
        loss = brain.aam_loss(net["classifier"](emb), targets.to(dev))
        grads = torch.autograd.grad(loss, params)
        assert all(v == 0 for v in ops.launch_counters().values())
        return (names, float(loss.detach()),
                [g.detach().cpu().double() for g in grads],
                {k: v.detach().cpu().double().clone()
                 for k, v in net.named_buffers()})

    names, l64, g64, b64 = step("cpu", torch.float64)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, lcard, gcard, bcard = step("cuda", torch.float32)
        if train:
            _, _, gcard64, _ = step("cuda", torch.float64)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert abs(lcard - l64) <= 1e-5 * abs(l64)
    G = max(float(g.abs().max()) for g in g64)
    got, tol = (gcard64, 1e-8) if train else (gcard, 3e-3)
    bad = [(n, float((a - b).abs().max()), float(b.abs().max()))
           for n, a, b in zip(names, got, g64)
           if float((a - b).abs().max()) > tol * max(float(b.abs().max()),
                                                     0.05 * G)]
    assert not bad, bad
    bad = [k for k, v in b64.items()
           if float((bcard[k] - v).abs().max()) > 1e-4 * max(
               float(v.abs().max()), 1.0)]
    assert not bad, bad


def test_voxceleb_step_makes_no_host_sync(gen):
    """The VoxCeleb step's forward, loss and backward on the card (the
    augmentation at speeds 95/100/105 drawn from the card's generator,
    ``Fbank``, the sentence normalization with the augmented lengths,
    ECAPA's length masks, the AAM loss) make no synchronising call:
    ``torch.cuda.set_sync_debug_mode("error")`` raises on one."""
    import numpy as np

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes.voxceleb_speaker import SpeakerBrain

    hp = {"channels": (64,) * 4 + (192,), "attention_channels": 16,
          "lin_neurons": 32, "out_neurons": 50}
    brain = SpeakerBrain(hp, run_opts={"seed": 0})
    rng = np.random.default_rng(1)
    batch = brain.prepare_batch({
        "sig": rng.standard_normal((4, 48000)).astype(np.float32),
        "sig_lens": np.array([1.0, 0.7, 0.9, 0.5], np.float32),
        "spk_id_encoded": rng.integers(0, 50, 4)})
    brain.modules.train()
    brain._loss(batch, Stage.TRAIN).backward()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = brain._loss(batch, Stage.TRAIN)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("intra", ["transformer", "conformer"])
def test_sepformer_step_on_the_card_matches_the_cpu(gen, intra):
    """The SepFormer's training loss and gradients at ``sepformer.yaml``'s
    widths (encoder 256 x 16 taps, 2 x (8 + 8) layers, chunks of 250), and
    ``sepformer-conformerintra.yaml``'s (its intra blocks conformers:
    K1/K2 launch 32 and 16 times), on B 2 x 0.5 s mixtures (T' 499), on
    the card in float32 (TF32 off) against the same weights in float64
    on the CPU: the loss within 1e-5 relative, each gradient within 1e-3
    of its tensor's scale (or of 5 % of the largest gradient: the
    attention's key bias has an analytic gradient of 0)."""
    import numpy as np

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes import wsj0mix_separation as sep

    hp = (sep.HPARAMS_SEPFORMER if intra == "transformer"
          else sep.HPARAMS_SEPFORMER_CONFORMERINTRA)
    brain = sep.Separation(hp, run_opts={"device": "cpu", "seed": 0})
    rng = np.random.default_rng(2)
    s = (0.1 * rng.standard_normal((2, 2, 4000))).astype(np.float32)
    host = {"mix_sig": s[0] + s[1], "s1_sig": s[0], "s2_sig": s[1],
            "batch_mask": np.ones(2, np.float32)}
    initial = {k: v.clone() for k, v in brain.modules.state_dict().items()}

    def step(dev, dtype):
        brain.modules.load_state_dict(initial)
        brain.modules.to(dev, dtype).train()
        brain.device, brain.dtype = torch.device(dev), dtype
        batch = {k: torch.from_numpy(v).to(dev, dtype) for k, v in host.items()}
        names, params = zip(*brain.modules.named_parameters())
        ops.reset_launch_counters()
        loss = brain._loss(batch, Stage.TRAIN)
        grads = torch.autograd.grad(loss, params)
        counts = ops.launch_counters()
        return (names, float(loss.detach()), [g.cpu().double() for g in grads],
                counts)

    names, l64, g64, _ = step("cpu", torch.float64)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, lcard, gcard, counts = step("cuda", torch.float32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    want = ((32, 16) if intra == "conformer" else (0, 0))
    assert (counts["depthwise_conv1d"], counts["depthwise_conv1d_dw"]) == want
    assert abs(lcard - l64) <= 1e-5 * abs(l64)
    G = max(float(g.abs().max()) for g in g64)
    bad = [(n, float((a - b).abs().max()), float(b.abs().max()))
           for n, a, b in zip(names, gcard, g64)
           if float((a - b).abs().max()) > 1e-2 * max(float(b.abs().max()),
                                                      0.05 * G)]
    assert not bad, bad


@pytest.mark.parametrize("name", ["sepformer", "conformer", "convtasnet"])
def test_separation_step_makes_no_host_sync(gen, name):
    """A separation step's forward, PIT SI-SNR loss and backward on the
    card (narrow widths; the conformer blocks through K1/K2) make no
    synchronising call: ``torch.cuda.set_sync_debug_mode("error")``
    raises on one."""
    import numpy as np

    from speechbrain_tpu_torch.core import Stage
    from speechbrain_tpu_torch.recipes import wsj0mix_separation as sep

    hp = {"sepformer": sep.HPARAMS_SEPFORMER,
          "conformer": sep.HPARAMS_SEPFORMER_CONFORMERINTRA,
          "convtasnet": sep.HPARAMS_CONVTASNET}[name]
    toy = dict(encoder_out_nchannels=32, masknet_chunksize=50,
               intra_numlayers=1, inter_numlayers=1, intra_dffn=64,
               inter_dffn=64, N=32, B=16, H=32, X=2, R=1)
    brain = sep.Separation(dict(hp, **toy), run_opts={"seed": 0})
    rng = np.random.default_rng(3)
    s = (0.1 * rng.standard_normal((2, 2, 8000))).astype(np.float32)
    batch = brain.prepare_batch({"mix_sig": s[0] + s[1], "s1_sig": s[0],
                                 "s2_sig": s[1]})
    brain.modules.train()
    brain._loss(batch, Stage.TRAIN).backward()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = brain._loss(batch, Stage.TRAIN)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("kind", ["LSTM", "RNN_tanh", "RNN_relu"])
def test_recurrence_on_the_card_matches_the_cpu(gen, kind):
    """The port's LSTM and RNN (2 layers, bidirectional, from a random
    state, TF32 off, cuDNN's too) in float32 on the card against the same
    module in float64 on the CPU: outputs, last states and the input's,
    the state's and every parameter's gradient within 1e-4 of each
    float64 tensor's largest entry (``chip_smoke.LSTM_CARD_TOL``; cuDNN's
    f32 sums lie up to 1e-5 of the scale from float64 at the DPRNN's
    shape, and 1.7e-5 from the CPU's f32 ones here, 6.1e-6 absolute).
    Then one Adam step on the card: ``bias_hh`` (a buffer: JAX's LSTM
    and RNN have no recurrent bias) is still zero, ``bias_ih`` moved,
    and the weights are still one cuDNN buffer."""
    from speechbrain_tpu_torch.nnet import RNN

    name, _, act = kind.partition("_")
    kw = {"nonlinearity": act} if act else {}
    torch.manual_seed(0)
    cpu = getattr(RNN, name)(24, 32, num_layers=2, bidirectional=True,
                             **kw).double()
    card = getattr(RNN, name)(24, 32, num_layers=2, bidirectional=True,
                              **kw).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 50, 24, dtype=torch.float64)
    hx = tuple(torch.randn(4, 3, 32, dtype=torch.float64)
               for _ in range(2 if name == "LSTM" else 1))
    outs = []
    tf32 = torch.backends.cudnn.allow_tf32  # cuDNN's recurrences use it
    torch.backends.cudnn.allow_tf32 = False
    try:
        for net, dev, dtype in ((cpu, "cpu", torch.float64),
                                (card, "cuda", torch.float32)):
            xi = x.to(dev, dtype).detach().requires_grad_()
            h0 = tuple(h.to(dev, dtype).detach().requires_grad_() for h in hx)
            y, state = net(xi, hx=h0 if name == "LSTM" else h0[0])
            state = state if name == "LSTM" else (state,)
            ((y * y).sum() + sum((s ** 3).sum() for s in state)).backward()
            outs.append([y, *state, xi.grad, *(h.grad for h in h0)]
                        + [p.grad for p in net.parameters()])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for a, b in zip(*outs):
        b = b.detach().cpu().double()
        scale = max(float(a.detach().abs().max()), 1e-6)
        assert float((a.detach() - b).abs().max()) <= 1e-4 * scale
    before = {k: v.clone() for k, v in card.state_dict().items()}
    torch.optim.Adam(card.parameters(), lr=1e-2).step()
    after = card.state_dict()
    for k, v in after.items():
        if "bias_hh" in k:
            assert not v.any(), k
        elif "bias_ih" in k:
            assert not torch.equal(v, before[k]), k
    for rnn in card.rnns:
        assert len({w.untyped_storage().data_ptr()
                    for w in rnn._flat_weights}) == 1
