"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips when no CUDA card is present.

On a machine with the card (no JAX needed, so the JAX conftest is
skipped):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from speechbrain_tpu_torch import ops
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL, RelPosMHAXL
from speechbrain_tpu_torch.ops.beam_cache import _xla_ref

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
    tol = 1e-5 if dtype == torch.float32 else 3e-2  # bf16: one rounding less
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


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
    # same stored values, f32 arithmetic in both; sums in other orders
    torch.testing.assert_close(got[:, :, :T], ref[:, :, :T], atol=1e-5, rtol=1e-5)


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
    torch.testing.assert_close(ctx, ref_ctx, atol=1e-5, rtol=1e-5)


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


def test_wrappers_reject_bad_inputs(gen):
    x = torch.randn(2, 8, 4, device="cuda", generator=gen).to(torch.float16)
    with pytest.raises(TypeError):
        ops.depthwise_conv1d(x, torch.ones(3, 4, device="cuda", dtype=torch.float16))
    kv = torch.zeros(2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="overlaps"):
        ops.beam_attend_step(kv, torch.zeros(2, dtype=torch.long), kv[:, :, 0],
                             kv[:, :, 0], kv[:, :, 0], 1, 2, dst=kv)
