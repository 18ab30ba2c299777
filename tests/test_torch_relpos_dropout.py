"""Attention dropout of the port's rel-pos attention (``rate > 0``) on the
CPU: the plain Philox4x32-10 mask that the CUDA kernels K5/K6 regenerate,
and the op's forward and gradients against the JAX package's semantics.

The JAX kernels draw their mask from the TPU's hardware generator, which
runs on a TPU only (``tests/unittests/test_pallas_relpos.py`` skips its
dropout test elsewhere), so JAX's bits cannot be reproduced.  What is
held to JAX is everything else: the threshold rule, the normalizer taken
before dropout, the gradient formulas (``jax.grad`` of the reference with
the port's mask held fixed), determinism for a seed and the preserved
expectation.  On the card ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels against these same plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.ops.pallas.relpos_attention import (
    relpos_attention_reference as j_relpos_ref,
)
from speechbrain_tpu_torch.ops.relpos_attention import (
    _philox4x32,
    relpos_attention,
    relpos_attention_bwd,
    relpos_attention_bwd_plain,
    relpos_attention_plain,
    relpos_dropout_keep,
)

from .test_torch_kernels import one_torch_thread  # noqa: F401

# the module (the package's ``relpos_attention`` attribute is the function)
ops_relpos = importlib.import_module("speechbrain_tpu_torch.ops.relpos_attention")

B, H, DH = 2, 2, 16
SHAPES = [(128, 128), (100, 128)]  # (T, Tp): Tp > T pads with masked rows


def _inputs(T, Tp, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, H, Tp, DH), mk(B, H, Tp, DH), mk(B, H, Tp, DH)
    p = mk(H, 2 * T - 1, DH)
    u, vb = 0.2 * mk(H, DH), 0.2 * mk(H, DH)
    madd = np.zeros((B, Tp), np.float32)
    madd[:, T:] = -1e9  # the T..Tp pad region
    madd[1, T - T // 4:] = -65000.0  # padding mask of a shorter utterance
    dout = mk(B, H, Tp, DH)
    dout[:, :, T:] = 0.0
    return (q, k, v, p, u, vb, madd), dout, 1.0 / np.sqrt(H * DH)


# ------------------------------------------------------------ the mask


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Philox4x32-10 against the generator's published known answers
    (Random123), on int64 tensors: a wrong 16-bit split of the 32-bit
    multiply-high shows here."""
    words = _philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in counter),
                        *key)
    assert tuple(int(w) for w in words) == expected


def test_keep_mask_follows_the_counter_layout():
    """Element (b, h, q, k) is word k & 3 of the counter (k >> 2, q,
    b*H + h, 0) under the key (seed low word, seed high word)."""
    seed, rate = (5 << 32) + 17, 0.3
    keep = relpos_dropout_keep(2, 3, 12, rate, seed, "cpu")
    thresh = int(rate * 2 ** 32)
    for b, h, q, k in [(0, 0, 0, 0), (1, 2, 11, 11), (1, 0, 3, 6), (0, 2, 7, 9)]:
        words = _philox4x32(torch.tensor(k >> 2), torch.tensor(q),
                            torch.tensor(b * 3 + h), torch.tensor(0), 17, 5)
        assert bool(keep[b, h, q, k]) == (int(words[k & 3]) >= thresh)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_fraction(rate):
    """The kept share lies within 5 sigma of 1 - rate."""
    keep = relpos_dropout_keep(B, H, 256, rate, 11, "cpu")
    n = keep.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(float(keep.float().mean()) - (1 - rate)) <= 5 * sigma


def test_mask_does_not_depend_on_tp():
    """The mask at Tp = 128 is the top-left corner of the mask at 256."""
    small = relpos_dropout_keep(B, H, 128, 0.3, 3, "cpu")
    large = relpos_dropout_keep(B, H, 256, 0.3, 3, "cpu")
    assert torch.equal(small, large[:, :, :128, :128])
    # an odd Tp (not a multiple of 4) is a corner too
    assert torch.equal(relpos_dropout_keep(B, H, 37, 0.3, 3, "cpu"),
                       large[:, :, :37, :37])


def test_mask_uses_both_halves_of_the_seed():
    a = relpos_dropout_keep(1, 1, 64, 0.5, 9, "cpu")
    b = relpos_dropout_keep(1, 1, 64, 0.5, 9 + (1 << 32), "cpu")
    c = relpos_dropout_keep(1, 1, 64, 0.5, 9, "cpu")
    assert torch.equal(a, c) and not torch.equal(a, b)


# ------------------------------------------------------- rate 0 unchanged


@pytest.mark.parametrize("T,Tp", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_rate_zero_is_unchanged(T, Tp, causal, monkeypatch):
    """rate = 0 gives the call without dropout arguments bit for bit, and
    runs no generator code."""
    arrays, dout, scale = _inputs(T, Tp, seed=T + Tp)
    args = [torch.from_numpy(a) for a in arrays]
    base = relpos_attention(*args, scale, causal)
    base_grads = relpos_attention_bwd_plain(*args, torch.from_numpy(dout),
                                            scale, causal)

    def no_generator(*a, **k):
        raise AssertionError("the dropout mask was generated at rate 0")

    monkeypatch.setattr(ops_relpos, "relpos_dropout_keep", no_generator)
    monkeypatch.setattr(ops_relpos, "_philox4x32", no_generator)
    for seed in (0, 12345):
        assert torch.equal(relpos_attention(*args, scale, causal, 0.0, seed), base)
        assert torch.equal(relpos_attention_plain(*args, scale, causal, 0.0, seed),
                           base)
        grads = relpos_attention_bwd(*args, torch.from_numpy(dout), None, None,
                                     scale, causal, 0.0, seed)
        for g, r in zip(grads, base_grads):
            assert torch.equal(g, r)


# ------------------------------------------------- parity with JAX semantics


@pytest.mark.parametrize("T,Tp", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate,seed", [(0.1, 0), (0.3, (1 << 64) - 1)])
def test_dropout_matches_jax_semantics(T, Tp, causal, rate, seed):
    """The port's ``relpos_attention(..., rate, seed)`` (forward, and the
    six gradients by autograd) against JAX's semantics with the port's
    mask: the weights of ``relpos_attention_reference`` (run with v = the
    identity, since it returns ``attn @ v``), then ``(attn * keep /
    (1 - rate)) @ v``, its gradients by ``jax.grad`` with keep held
    fixed."""
    arrays, dout, scale = _inputs(T, Tp, seed=3 * T + Tp + causal)
    keep = relpos_dropout_keep(B, H, Tp, rate, seed, "cpu").numpy()
    drop = keep.astype(np.float32) / (1.0 - rate)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:6]]
    madd = torch.from_numpy(arrays[6])
    out = relpos_attention(*leaves, madd, scale, causal, rate, seed)
    out.backward(torch.from_numpy(dout))
    got = [t.grad.numpy() for t in leaves]

    eye = jnp.broadcast_to(jnp.eye(Tp, dtype=jnp.float32), (B, H, Tp, Tp))
    jmadd = jnp.asarray(arrays[6])

    def j_out(q, k, v, p, u, vb):
        attn = j_relpos_ref(q, k, eye, p, u, vb, jmadd, scale, causal)
        return jnp.einsum("bhqk,bhkd->bhqd", attn * drop, v)

    jargs = [jnp.asarray(a) for a in arrays[:6]]
    ref = np.asarray(j_out(*jargs))
    ref_grads = jax.grad(lambda *a: jnp.sum(j_out(*a) * dout),
                         argnums=tuple(range(6)))(*jargs)
    # f32 on both sides from the same values; the padded rows read the
    # same clipped positions in both, so every row is compared
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-5)
    for name, g, r in zip("q k v p u vb".split(), got, ref_grads):
        r = np.asarray(r)
        err = np.abs(g - r).max() / max(1e-6, np.abs(r).max())
        assert err <= 1e-4, f"d{name}: relative max err {err} > 1e-4"


# ------------------------------------- JAX's dropout-test properties, ported


def test_dropout_deterministic_and_consistent():
    """``test_pallas_relpos.py::test_dropout_deterministic_and_consistent``
    on the port: equal outputs for one seed, different ones for another,
    the context's scale kept (E[dropout(attn)] = attn), and finite
    differences against autograd with the seed fixed."""
    T, Tp = 100, 128
    arrays, _, scale = _inputs(T, Tp, seed=21)
    q, k, v, p, u, vb, madd = (torch.from_numpy(a) for a in arrays)
    o1 = relpos_attention(q, k, v, p, u, vb, madd, scale, False, 0.3, 7)
    o2 = relpos_attention(q, k, v, p, u, vb, madd, scale, False, 0.3, 7)
    assert torch.equal(o1, o2)
    o3 = relpos_attention(q, k, v, p, u, vb, madd, scale, False, 0.3, 8)
    assert float((o1 - o3).abs().max()) > 1e-3
    o0 = relpos_attention(q, k, v, p, u, vb, madd, scale)
    ratio = float(o1[:, :, :T].abs().mean() / o0[:, :, :T].abs().mean())
    assert 0.7 < ratio < 1.4
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, H, T, DH)).astype(np.float32))

    def loss(qq):
        o = relpos_attention(qq, k, v, p, u, vb, madd, scale, False, 0.3, 7)
        return (o[:, :, :T] * w).sum()

    qg = q.clone().requires_grad_(True)
    loss(qg).backward()
    ad = float(qg.grad[0, 0, 5, 3])
    eps = 1e-2
    probe = torch.zeros_like(q)
    probe[0, 0, 5, 3] = eps
    fd = float((loss(q + probe) - loss(q - probe)) / (2 * eps))
    assert abs(fd - ad) < 5e-2 * max(1.0, abs(ad)), (fd, ad)


# ------------------------------------------------------------- arguments


@pytest.mark.parametrize("rate", [1.0, -0.1, 1.5, float("nan")])
def test_rate_outside_zero_one_raises(rate):
    arrays, dout, scale = _inputs(100, 128, seed=1)
    args = [torch.from_numpy(a) for a in arrays]
    for fn in (relpos_attention, relpos_attention_plain):
        with pytest.raises(ValueError, match="rate"):
            fn(*args, scale, False, rate, 0)
    with pytest.raises(ValueError, match="rate"):
        relpos_attention_bwd(*args, torch.from_numpy(dout), None, None, scale,
                             False, rate, 0)
    with pytest.raises(ValueError, match="rate"):
        relpos_dropout_keep(B, H, 128, rate, 0, "cpu")


def test_seed_must_be_an_integer_below_two_to_the_64():
    arrays, _, scale = _inputs(100, 128, seed=1)
    args = [torch.from_numpy(a) for a in arrays]
    for seed in (-1, 1 << 64):
        with pytest.raises(ValueError, match="seed"):
            relpos_attention(*args, scale, False, 0.1, seed)
    with pytest.raises(TypeError):
        relpos_attention(*args, scale, False, 0.1, 1.5)
    top = relpos_attention(*args, scale, False, 0.1, (1 << 64) - 1)
    assert bool(torch.isfinite(top).all())
