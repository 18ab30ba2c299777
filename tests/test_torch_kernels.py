"""The port's kernel functions on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels (interpret mode) and their XLA
references, on the same numpy inputs.

Covers K1 ``depthwise_conv1d`` and its backward (K1 on flipped taps
for dx, K2 for dw), K3/K4 ``ctc_loss_per_seq``, K5/K6
``relpos_attention`` (forward and backward), the bf16 rounding points
of K1 and K5, and K7 ``beam_attend_step``.
On the card the CUDA kernels are held against these same plain versions
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.ops.pallas import beam_cache as jbc
from speechbrain_tpu.ops.pallas import ctc as jctc
from speechbrain_tpu.ops.pallas.depthwise_conv import (
    depthwise_conv1d as j_depthwise,
)
from speechbrain_tpu.ops.pallas.relpos_attention import (
    _fwd as j_relpos_fwd,
    relpos_attention as j_relpos,
    relpos_attention_reference as j_relpos_ref,
)
from speechbrain_tpu_torch.ops import (
    append_attend,
    beam_attend_step,
    ctc_loss_per_seq,
    depthwise_conv1d,
    depthwise_conv1d_dw_plain,
    depthwise_conv1d_plain,
    relpos_attention,
)
from speechbrain_tpu_torch.ops.relpos_attention import _relpos_attention_rounded


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread while a module's tests run, and the
    former count back after it.  The suite runs in several worker
    processes at once, and the plain recursions' and the toy models'
    thousands of small ops each wake an intra-op pool as wide as the
    machine, which the workers then fight over; one thread a worker runs
    them many times faster there and computes the same values.  The other
    port test modules import it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_value_and_grad(f):
    """``jax.value_and_grad(f, has_aux=True)``, traced once and compiled
    by XLA without its backend optimizations
    (``xla_backend_optimization_level`` 0): the same function, computed in
    f32 as before, whose compile takes a little over half as long for the
    JAX Pallas kernels in interpret mode, the slowest thing these tests
    compile.  Called eagerly, ``value_and_grad`` compiles its pieces one
    by one."""
    vg = jax.jit(jax.value_and_grad(f, has_aux=True))

    def call(*args):
        compiled = vg.lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        return compiled(*args)
    return call


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


@pytest.mark.parametrize("shape", [(2, 19, 16, 7), (4, 13, 136, 5)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_depthwise_conv1d_backward_matches_jax(shape, causal, with_bias):
    """dx, dw and dbias of the autograd Function (plain route) against
    ``jax.grad`` of the Pallas kernel (interpret mode) and of the XLA
    route.  C = 136 >= 128 makes the JAX wrapper pack its 8 remainder
    channels; only the gradients are compared."""
    B, T, C, K = shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    out = depthwise_conv1d(leaves[0], leaves[1],
                           leaves[2] if with_bias else None, causal=causal)
    out.backward(torch.from_numpy(dy))
    got = [t.grad.numpy() for t in leaves[:3 if with_bias else 2]]
    for interpret in (True, False):
        def f(x_, w_, b_):
            y = j_depthwise(x_, w_, b_ if with_bias else None, causal=causal,
                            interpret=interpret)
            return jnp.sum(y * dy)

        ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
        # f32 sums of K (dx) or B*T (dw, dbias) products in other orders
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, _np(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 19, 16, 7), (4, 13, 136, 5)])
@pytest.mark.parametrize("causal", [False, True])
def test_depthwise_conv1d_dw_plain_bias_grad_matches_jax(shape, causal):
    """K2's plain version with ``bias_grad``: dw and dbias against
    ``jax.grad`` of JAX's depthwise conv with a bias, on the Pallas route
    (interpret mode) and on the XLA route; without ``bias_grad`` it
    returns the same dw alone."""
    B, T, C, K = shape
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    dw, dbias = depthwise_conv1d_dw_plain(tx, tdy, K, causal, bias_grad=True)
    assert dw.dtype == dbias.dtype == torch.float32 and dbias.shape == (C,)
    assert torch.equal(dw, depthwise_conv1d_dw_plain(tx, tdy, K, causal))
    for interpret in (True, False):
        def f(w_, b_):
            y = j_depthwise(jnp.asarray(x), w_, b_, causal=causal,
                            interpret=interpret)
            return jnp.sum(y * dy)

        r_dw, r_db = jax.grad(f, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
        # f32 sums of B*T products in other orders
        np.testing.assert_allclose(dw.numpy(), _np(r_dw), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dbias.numpy(), _np(r_db), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 37, 16, 7), (8, 25, 144, 31),
                                   (3, 40, 20, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_depthwise_conv1d_plain_bf16_matches_jax_bit_for_bit(shape, causal):
    """bf16 inputs with a bias: the plain version (the reference of the
    kernel on the card) rounds where the JAX package does, the f32 sum to
    bf16 and then the bias add, so the two agree bit for bit.  C = 144
    takes the JAX wrapper's lane packing of its 16 remainder channels."""
    B, T, C, K = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    got = depthwise_conv1d_plain(
        *(torch.from_numpy(a).bfloat16() for a in (x, w, b)), causal)
    assert got.dtype == torch.bfloat16
    ref = j_depthwise(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                      causal=causal, interpret=True)
    np.testing.assert_array_equal(got.float().numpy(), _np(ref.astype(jnp.float32)))


# ---------------------------------------------------------------- K3/K4


def _ctc_inputs(blank, seed=1):
    """Logits, labels (no blank, a repeated pair: the skip rule) and
    ragged lengths with T_b < T and U_b < U, one sequence with U_b = 0.
    B = 8: the JAX Pallas kernel takes the batch in blocks of 8."""
    B, T, C, U = 8, 14, 7, 4
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = [c for c in range(C) if c != blank]
    tg = rng.choice(labels, size=(B, U)).astype(np.int32)
    tg[0, 2] = tg[0, 1]
    tg[3, 1] = tg[3, 0]
    tb = np.array([14, 11, 9, 14, 6, 13, 8, 12], np.int32)
    ub = np.array([4, 3, 2, 2, 0, 4, 1, 3], np.int32)
    g = rng.standard_normal(B).astype(np.float32)
    return logits, tg, tb, ub, g


@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_loss_per_seq_matches_jax(blank):
    """Per-sequence loss and the gradient w.r.t. the pre-softmax logits
    of the port's plain recursions against the JAX optax route and the
    JAX Pallas kernels (interpret mode), with a weight per sequence."""
    logits, tg, tb, ub, g = _ctc_inputs(blank)
    lt = torch.from_numpy(logits).requires_grad_(True)
    per = ctc_loss_per_seq(torch.log_softmax(lt, -1), torch.from_numpy(tg),
                           torch.from_numpy(tb), torch.from_numpy(ub), blank)
    (per * torch.from_numpy(g)).sum().backward()
    for route in ("optax", "pallas"):
        def f(lg):
            lp = jax.nn.log_softmax(lg, -1)
            if route == "pallas":
                loss = jctc._ctc_pallas(lp, jnp.asarray(tg),
                                        (jnp.asarray(tb), jnp.asarray(ub)),
                                        blank, True)
            else:
                loss = jctc.ctc_loss_per_seq(lp, jnp.asarray(tg), tb, ub,
                                             blank)
            return jnp.sum(loss * g), loss

        (_, j_per), j_grad = jax_value_and_grad(f)(jnp.asarray(logits))
        # the same log-semiring recursion in f32; optax's runs in another
        # order and form (its own logaddexp): 1e-4 on losses ~ 20
        np.testing.assert_allclose(per.detach().numpy(), _np(j_per),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(lt.grad.numpy(), _np(j_grad),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("U", [0, 15, 16, 31, 32, 128])
def test_ctc_plain_matches_jax_at_warp_widths(U):
    """The plain recursions, which the card tests hold the kernels to, at
    2U+1 = 1, 31, 33, 63, 65 and 257 states: each side of every step of
    the warp kernels' states per lane (32 a step), and the widest
    lattice that warp path must take.  Per-sequence loss and the
    gradient w.r.t. the logits, with a weight per sequence, against the
    JAX Pallas kernels in interpret mode (B = 8: one of their batch
    blocks).  Ragged lengths: U_b = U, 0 and in between; T_b = T and
    less, T = U + 8, the fewest frames that leave every sequence a path
    (no two neighbouring labels alike but the two repeats placed for
    the skip rule).  JAX's kernel takes no (B, 0) targets: at U = 0 it
    gets one padding column with U_b = 0, the same one-state lattice."""
    B, C = 8, 11
    T = U + 8
    rng = np.random.default_rng(100 + U)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    tg = np.zeros((B, U), np.int32)
    for u in range(U):  # labels 1..C-1, each unlike the one before
        step = rng.integers(1, C - 1, B)
        tg[:, u] = (rng.integers(1, C, B) if u == 0
                    else (tg[:, u - 1] - 1 + step) % (C - 1) + 1)
    if U >= 2:
        tg[0, 1] = tg[0, 0]
        tg[5, U - 1] = tg[5, U - 2]
    tb = np.array([T, T - 1, T - 3, T, T - 2, T, T - 5, T - 4], np.int32)
    ub = np.array([U, U // 2, 0, U, max(U - 1, 0), U, U // 3, 1 if U else 0],
                  np.int32)
    g = rng.standard_normal(B).astype(np.float32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    per = ctc_loss_per_seq(torch.log_softmax(lt, -1), torch.from_numpy(tg),
                           torch.from_numpy(tb), torch.from_numpy(ub), 0)
    (per * torch.from_numpy(g)).sum().backward()
    j_tg = jnp.asarray(tg if U else np.ones((B, 1), np.int32))

    def f(lg):
        loss = jctc._ctc_pallas(jax.nn.log_softmax(lg, -1), j_tg,
                                (jnp.asarray(tb), jnp.asarray(ub)), 0, True)
        return jnp.sum(loss * g), loss

    (_, j_per), j_grad = jax_value_and_grad(f)(jnp.asarray(logits))
    # as test_ctc_loss_per_seq_matches_jax: the same f32 recursion
    np.testing.assert_allclose(per.detach().numpy(), _np(j_per),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), _np(j_grad),
                               atol=1e-5, rtol=1e-4)


def test_ctc_plain_wide_lattice_matches_jax():
    """The plain recursions at 2U+1 = 1041 states, above the 1024 that the
    kernels once took, against the JAX optax route: per-sequence loss and
    the gradient w.r.t. the logits, with a weight per sequence."""
    B, T, C, U = 2, 1100, 8, 520
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    tg = rng.integers(1, C, (B, U)).astype(np.int32)
    tg[:, 1] = tg[:, 0]  # a repeated label: the skip rule
    tb = np.array([1100, 1087], np.int32)
    ub = np.array([520, 497], np.int32)
    g = np.array([1.0, 0.5], np.float32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    per = ctc_loss_per_seq(torch.log_softmax(lt, -1), torch.from_numpy(tg),
                           torch.from_numpy(tb), torch.from_numpy(ub), 0)
    (per * torch.from_numpy(g)).sum().backward()

    def f(lg):
        loss = jctc.ctc_loss_per_seq(jax.nn.log_softmax(lg, -1),
                                     jnp.asarray(tg), tb, ub, 0)
        return jnp.sum(loss * g), loss

    (_, j_per), j_grad = jax_value_and_grad(f)(jnp.asarray(logits))
    # 1100 dependent log-semiring steps in f32 in two forms: losses ~ 2e3,
    # where one ulp is 1.2e-4; the occupancies exp(alpha + beta - logZ)
    # carry alpha's absolute error as a relative one
    np.testing.assert_allclose(per.detach().numpy(), _np(j_per), rtol=2e-5)
    np.testing.assert_allclose(lt.grad.numpy(), _np(j_grad), atol=2e-3)


def test_ctc_plain_alpha_and_occupancy_are_consistent():
    """Autograd through the plain alpha loop (the cross-check the
    explicit beta pass stands beside) gives the explicit gradient."""
    from speechbrain_tpu_torch.ops import ctc_alpha_plain, ctc_beta_grad_plain

    logits, tg, tb, ub, g = _ctc_inputs(0, seed=4)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).requires_grad_(True)
    args = (lp, torch.from_numpy(tg), torch.from_numpy(tb),
            torch.from_numpy(ub))
    alpha, loss, logz = ctc_alpha_plain(*args, 0)
    (loss * torch.from_numpy(g)).sum().backward()
    explicit = ctc_beta_grad_plain(*args, 0, alpha.detach(), logz.detach(),
                                   torch.from_numpy(g))
    torch.testing.assert_close(explicit, lp.grad, atol=1e-5, rtol=1e-5)


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


@pytest.mark.parametrize("T,Tp", [(128, 128), (100, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_relpos_attention_rounded_matches_jax_kernel(T, Tp, causal):
    """The bf16 kernel's reference (bf16 operands where JAX's Pallas
    kernel rounds them, f32 products and sums, the global row max)
    against JAX's Pallas forward in interpret mode on bf16 inputs: out and
    lse.  Rows past T are left out: JAX's kernel reads zero position rows
    there, where every other version clips."""
    B, H, dh = 2, 2, 16
    rng = np.random.default_rng(T + 3 * Tp + causal)
    mk = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(B, H, Tp, dh)
    p = mk(H, 2 * T - 1, dh)
    u, vb = 0.2 * mk(H, dh), 0.2 * mk(H, dh)
    madd = np.zeros((B, Tp), np.float32)
    madd[:, T:] = -1e9
    madd[1, T - T // 4:] = -65000.0
    scale = 1.0 / np.sqrt(H * dh)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v, p)]
    out, lse = _relpos_attention_rounded(
        *bf, *(torch.from_numpy(a) for a in (u, vb, madd)), scale, causal)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, p)]
    j_out, (*_, j_lse) = j_relpos_fwd(*jb, *map(jnp.asarray, (u, vb, madd)),
                                      scale, causal, 0.0, 0)
    # the same bf16 operands and f32 products; f32 sums in other orders.
    # Where a weight exp(s - max) lies within an f32 ulp of a bf16
    # rounding midpoint, XLA's exp and torch's (or a last-bit difference
    # in s) round it to neighbouring bf16 values: a row in a few hundred
    # then differs by that one bf16 step of one weight times v
    d = np.abs(out.numpy()[:, :, :T] - _np(j_out)[:, :, :T])
    close = d <= 1e-5 + 1e-5 * np.abs(_np(j_out)[:, :, :T])
    assert close.all(-1).mean() >= 0.99, close.all(-1).mean()
    assert d.max() <= 2.0 ** -8 * np.abs(v).max(), d.max()
    np.testing.assert_allclose(lse.numpy()[:, :, :T],
                               _np(j_lse)[:, :, :T, 0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,Tp", [(128, 128), (100, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_relpos_attention_backward_matches_jax(T, Tp, causal):
    """The six gradients (q, k, v, p, u, vb) of the plain route against
    ``jax.grad`` of the XLA reference and of the Pallas kernels
    (interpret mode: K5 forward, K6 backward), padded rows included in
    the inputs and masked out of the cotangent (the rows past T read
    clipped positions)."""
    B, H, dh = 2, 2, 16
    rng = np.random.default_rng(T + 7 * Tp + causal)
    mk = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, H, Tp, dh), mk(B, H, Tp, dh), mk(B, H, Tp, dh)
    p = mk(H, 2 * T - 1, dh)
    u, vb = 0.2 * mk(H, dh), 0.2 * mk(H, dh)
    madd = np.zeros((B, Tp), np.float32)
    madd[:, T:] = -1e9
    madd[1, T - T // 4:] = -65000.0
    dout = mk(B, H, Tp, dh)
    dout[:, :, T:] = 0.0
    scale = 1.0 / np.sqrt(H * dh)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (q, k, v, p, u, vb)]
    out = relpos_attention(*leaves, torch.from_numpy(madd), scale, causal)
    out.backward(torch.from_numpy(dout))
    got = [t.grad.numpy() for t in leaves]
    jargs = [jnp.asarray(a) for a in (q, k, v, p, u, vb)]
    jmadd = jnp.asarray(madd)
    for fn, tol in ((j_relpos_ref, 1e-4), (j_relpos, 3e-2)):
        def f(*a):
            return jnp.sum(fn(*a, jmadd, scale, causal) * dout)

        ref = jax.grad(f, argnums=tuple(range(6)))(*jargs)
        # f32 against the f32 reference (sums over up to B*T^2 terms);
        # the Pallas kernels multiply in bf16 with f32 accumulation,
        # hence the bf16-scale bound (as for the forward above)
        for name, g_, r in zip("q k v p u vb".split(), got, ref):
            r = _np(r)
            err = np.abs(g_ - r).max() / max(1e-6, np.abs(r).max())
            assert err <= tol, f"d{name}: relative max err {err} > {tol}"


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
    # context against the Pallas kernel, which rounds the weights to the
    # cache dtype where the port does: the products are exact in f32, so
    # only the order of the sums and exp's last bit differ (1e-5).  In
    # bf16 a weight can land on the other side of a rounding midpoint and
    # move by one bf16 step (at most 2^-8 for a weight below 1), so 1 %
    # of the elements may differ by up to 2^-8 * sum_l |v[l]|.
    got, ref = ctx.numpy(), _np(j_ctx)
    close = np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref)
    if dtype == "float32":
        assert close.all()
    else:
        assert close.mean() >= 0.99, close.mean()
        v = new.float().numpy()[:, :, L:L + pos + 1]
        allowance = 2.0 ** -8 * np.abs(v).sum(-1) + 1e-5
        assert (np.abs(got - ref) <= allowance).all()
    # JAX's XLA fallback keeps the weights f32: in bf16 the rounded
    # weights move the context by ~1e-2
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, _np(r_ctx), atol=tol, rtol=tol)


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
