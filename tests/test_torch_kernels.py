"""The port's kernel functions on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels (interpret mode) and their XLA
references, on the same numpy inputs.

Covers K1 ``depthwise_conv1d``, K5 ``relpos_attention`` (forward) and
K7 ``beam_attend_step``.  On the card the CUDA kernels are held against
these same plain versions by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.ops.pallas import beam_cache as jbc
from speechbrain_tpu.ops.pallas.depthwise_conv import (
    depthwise_conv1d as j_depthwise,
)
from speechbrain_tpu.ops.pallas.relpos_attention import (
    relpos_attention as j_relpos,
    relpos_attention_reference as j_relpos_ref,
)
from speechbrain_tpu_torch.ops import (
    append_attend,
    beam_attend_step,
    depthwise_conv1d,
    relpos_attention,
)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("shape", [(2, 37, 16, 7), (8, 25, 144, 31)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_depthwise_conv1d_matches_jax(shape, causal, with_bias):
    B, T, C, K = shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32) if with_bias else None
    got = depthwise_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), causal=causal,
    ).numpy()
    jb = None if b is None else jnp.asarray(b)
    pallas = j_depthwise(jnp.asarray(x), jnp.asarray(w), jb, causal=causal,
                         interpret=True)
    xla = j_depthwise(jnp.asarray(x), jnp.asarray(w), jb, causal=causal)
    # f32 sums of K products in other orders
    np.testing.assert_allclose(got, _np(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _np(xla), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("T,Tp", [(128, 128), (100, 128), (256, 256)])
@pytest.mark.parametrize("causal", [False, True])
def test_relpos_attention_matches_jax(T, Tp, causal):
    B, H, dh = 2, 2, 16
    rng = np.random.default_rng(T + Tp)
    mk = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(B, H, Tp, dh)
    p = mk(H, 2 * T - 1, dh)
    u, vb = 0.2 * mk(H, dh), 0.2 * mk(H, dh)
    madd = np.zeros((B, Tp), np.float32)
    madd[:, T:] = -1e9  # the T..Tp pad region
    madd[1, T - T // 4:] = -65000.0  # padding mask of a shorter utterance
    scale = 1.0 / np.sqrt(H * dh)
    got = relpos_attention(
        *(torch.from_numpy(a) for a in (q, k, v, p, u, vb, madd)), scale,
        causal,
    ).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, p, u, vb, madd)]
    ref = _np(j_relpos_ref(*args, scale, causal))
    kern = _np(j_relpos(*args, scale, causal))
    # rows past T read clipped positions in every version; compare the
    # valid rows.  f32 against the f32 reference; the Pallas kernel
    # multiplies in bf16 (f32 accumulation), hence the bf16-scale bound.
    np.testing.assert_allclose(got[:, :, :T], ref[:, :, :T],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[:, :, :T], kern[:, :, :T],
                               atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------- K7


def _beam_inputs(n, H, Dh, L, seed):
    rng = np.random.default_rng(seed)
    HD = H * Dh
    kv = rng.standard_normal((n, HD, 2 * L)).astype(np.float32)
    rows = np.array([3, 3, 0, 5, 1, 1, 7, 3][:n], np.int32)  # many-to-one
    q, kn, vn = (rng.standard_normal((n, HD)).astype(np.float32)
                 for _ in range(3))
    return kv, rows, q, kn, vn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 7, 15])
def test_beam_attend_step_matches_jax(dtype, pos):
    n, H, Dh, L = 8, 2, 8, 16
    kv, rows, q, kn, vn = _beam_inputs(n, H, Dh, L, seed=pos)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (kv, q, kn, vn)]
    jrows = jnp.asarray(rows)
    jpos = jnp.asarray(pos, jnp.int32)
    j_ctx, j_kv = jbc.beam_attend_step(
        jargs[0], jrows, *jargs[1:], jpos, H, interpret=True
    )
    r_ctx, r_kv = jbc._xla_ref(jargs[0], jrows, jpos, *jargs[1:], H)
    targs = [torch.from_numpy(a).to(td) for a in (kv, q, kn, vn)]
    ctx, new = beam_attend_step(targs[0], torch.from_numpy(rows), *targs[1:],
                                pos, H)
    # the cache is a permutation plus two written columns: bit for bit
    assert np.array_equal(new.float().numpy(), _np(j_kv))
    assert np.array_equal(new.float().numpy(), _np(r_kv))
    # context: f32 softmax and sums from the same stored values as the
    # XLA reference; the Pallas kernel also rounds the probabilities to
    # the cache dtype before the context product (bf16: ~1e-2)
    np.testing.assert_allclose(ctx.numpy(), _np(r_ctx), atol=1e-5, rtol=1e-5)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ctx.numpy(), _np(j_ctx), atol=tol, rtol=tol)


def test_beam_attend_step_dst_and_aliasing():
    n, H, Dh, L = 8, 2, 8, 16
    kv, rows, q, kn, vn = (torch.from_numpy(a) if a.dtype != np.int32
                           else torch.from_numpy(a)
                           for a in _beam_inputs(n, H, Dh, L, seed=3))
    dst = torch.full_like(kv, 7.0)
    ctx, new = beam_attend_step(kv, rows, q, kn, vn, 4, H, dst=dst)
    ctx2, new2 = beam_attend_step(kv, rows, q, kn, vn, 4, H)
    assert new is dst and torch.equal(new, new2) and torch.equal(ctx, ctx2)
    with pytest.raises(ValueError, match="overlaps"):
        beam_attend_step(kv, rows, q, kn, vn, 4, H, dst=kv)
    with pytest.raises(ValueError, match="pos"):
        beam_attend_step(kv, rows, q, kn, vn, L, H)


def test_append_attend_matches_jax():
    n, H, Dh, L = 4, 2, 8, 16
    kv, _, q, kn, vn = _beam_inputs(n, H, Dh, L, seed=5)
    j_out, j_kv = jbc.append_attend(*(jnp.asarray(a) for a in (kv,)), 9,
                                    jnp.asarray(q), jnp.asarray(kn),
                                    jnp.asarray(vn), H)
    t_kv = torch.from_numpy(kv)
    out, new = append_attend(t_kv, 9, torch.from_numpy(q),
                             torch.from_numpy(kn), torch.from_numpy(vn), H)
    assert np.array_equal(new.numpy(), _np(j_kv))
    assert np.array_equal(t_kv.numpy(), kv)  # input left as it was
    np.testing.assert_allclose(out.numpy(), _np(j_out), atol=1e-5, rtol=1e-5)


def test_wrappers_raise_on_unsupported_device():
    x = torch.zeros(1, 4, 2, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        depthwise_conv1d(x, torch.zeros(3, 2, device="meta"))
