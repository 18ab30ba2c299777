"""The port's training-side modules against the JAX package on the CPU,
on the same numpy inputs: the losses, BatchNorm and InputNormalization
in training mode, the Noam schedule, dropout, and the repaired faults
(the rel-pos kernel gate, decode-only ``beam_attend_step``, float32
parameters under bfloat16 activations).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.nnet import losses as jl
from speechbrain_tpu.nnet.normalization import BatchNorm1d as JBatchNorm1d
from speechbrain_tpu.nnet.schedulers import NoamScheduler as JNoam
from speechbrain_tpu.processing.features import GlobalNormState as JNormState
from speechbrain_tpu.processing.features import InputNormalization as JNorm
from speechbrain_tpu_torch import ops
from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR, ConformerASRBrain
from speechbrain_tpu_torch.core import Brain, clip_by_global_norm_
from speechbrain_tpu_torch.nnet import losses as tl
from speechbrain_tpu_torch.nnet.attention import RelPosMHAXL
from speechbrain_tpu_torch.nnet.dropout import Dropout
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.schedulers import NoamScheduler
from speechbrain_tpu_torch.processing.features import InputNormalization

from .test_torch_kernels import one_torch_thread  # noqa: F401

TOY = dict(CONFORMER_SMALL, frontend_channels=(4, 4), input_size=40,
           d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
           d_ffn=32, kernel_size=5, vocab_size=12, n_mels=40,
           augmentation=None)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ losses

# relative lengths whose rel * T lands on .5 (round half to even in
# both frameworks), just below and just above it
_REL_T = np.array([1.0, 0.55, 0.7499, 0.7501], np.float32)
_REL_U = np.array([1.0, 0.5, 0.8, 0.3], np.float32)


def _log_probs(B, T, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    return _np(jax.nn.log_softmax(jnp.asarray(x), -1))


@pytest.mark.parametrize("reduction",
                         ["mean", "batchmean", "batch", "none", "sum"])
def test_ctc_loss_matches_jax(reduction):
    B, T, C, U = 4, 20, 6, 5
    lp = _log_probs(B, T, C, seed=3)
    rng = np.random.default_rng(4)
    tg = rng.integers(1, C, (B, U)).astype(np.int32)
    tg[1, 1] = tg[1, 0]
    got = tl.ctc_loss(_t(lp), _t(tg), _t(_REL_T), _t(_REL_U), 0,
                      reduction=reduction)
    ref = jl.ctc_loss(jnp.asarray(lp), jnp.asarray(tg), _REL_T, _REL_U, 0,
                      reduction=reduction)
    # the port's log-semiring recursion against optax's: f32 sums in
    # other orders
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum"])
def test_kldiv_loss_matches_jax(smoothing, reduction):
    """Label smoothing 0.1 (the recipe's) and 0 (nll), the pad-idx mask
    and the relative-length mask, every reduction (``mean`` is a global
    sum in both, the reference's quirk)."""
    B, T, C = 4, 7, 9
    lp = _log_probs(B, T, C, seed=5)
    rng = np.random.default_rng(6)
    tg = rng.integers(1, C, (B, T)).astype(np.int32)
    tg[2, 5:] = 0  # padded targets (pad_idx 0)
    length = np.array([1.0, 0.6, 1.0, 0.43], np.float32)
    got = tl.kldiv_loss(_t(lp), _t(tg), _t(length), smoothing,
                        reduction=reduction)
    ref = jl.kldiv_loss(jnp.asarray(lp), jnp.asarray(tg), length, smoothing,
                        reduction=reduction)
    # f32 sums of B*T*C terms in other orders
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("smoothing", [0.5, 1.0])
@pytest.mark.parametrize("reduction", ["none", "batchmean"])
def test_kldiv_loss_at_full_smoothing_matches_jax(smoothing, reduction):
    """At label_smoothing 1.0 the target's weight is 0 and JAX takes
    0 log 0 = 0; the port returned a math domain error there.  Per
    position and summed, against JAX on the same inputs."""
    B, T, C = 3, 5, 6
    lp = _log_probs(B, T, C, seed=9)
    tg = np.random.default_rng(10).integers(1, C, (B, T)).astype(np.int32)
    tg[1, 3:] = 0  # padded targets (pad_idx 0)
    length = np.array([1.0, 1.0, 0.6], np.float32)
    got = tl.kldiv_loss(_t(lp), _t(tg), _t(length), smoothing,
                        reduction=reduction)
    ref = jl.kldiv_loss(jnp.asarray(lp), jnp.asarray(tg), length, smoothing,
                        reduction=reduction)
    assert np.isfinite(got.numpy()).all()
    # the same f32 terms, C of them per position, summed in other orders
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum"])
def test_nll_loss_with_smoothing_matches_jax(reduction):
    B, T, C = 3, 6, 5
    lp = _log_probs(B, T, C, seed=7)
    tg = np.random.default_rng(8).integers(0, C, (B, T)).astype(np.int32)
    length = np.array([1.0, 0.5, 0.84], np.float32)
    got = tl.nll_loss(_t(lp), _t(tg), _t(length), 0.1, reduction=reduction)
    ref = jl.nll_loss(jnp.asarray(lp), jnp.asarray(tg), length, 0.1,
                      reduction=reduction)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ BatchNorm


def test_batchnorm_training_matches_flax_over_two_steps():
    """Outputs and running statistics after 2 training steps.  Flax
    updates ``var`` with the biased batch variance; torch's
    ``F.batch_norm(training=True)`` would use the unbiased one, which
    the last assertion shows is a different number."""
    C = 6
    rng = np.random.default_rng(9)
    xs = [(3.0 * rng.standard_normal((3, 5, C)) + 1.0).astype(np.float32)
          for _ in range(2)]
    jbn = JBatchNorm1d()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), train=False)
    params = {"BatchNorm_0": {
        "scale": jnp.asarray(rng.uniform(0.5, 1.5, C), jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(C), jnp.float32)}}
    stats = variables["batch_stats"]
    bn = BatchNorm1d(C).train()
    with torch.no_grad():
        bn.weight.copy_(_t(_np(params["BatchNorm_0"]["scale"])))
        bn.bias.copy_(_t(_np(params["BatchNorm_0"]["bias"])))
    for x in xs:
        jy, upd = jbn.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        y = bn(_t(x))
        np.testing.assert_allclose(y.detach().numpy(), _np(jy),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               _np(stats["BatchNorm_0"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               _np(stats["BatchNorm_0"]["var"]), atol=1e-5)
    # the trap: torch's own update, from the same start, differs
    rm, rv = torch.zeros(C), torch.ones(C)
    for x in xs:
        torch.nn.functional.batch_norm(_t(x).reshape(-1, C), rm, rv,
                                       training=True, momentum=0.1)
    assert not np.allclose(rv.numpy(), _np(stats["BatchNorm_0"]["var"]),
                           atol=1e-5)


def test_batchnorm_eval_uses_running_statistics():
    bn = BatchNorm1d(3)
    with torch.no_grad():
        bn.running_mean.fill_(2.0)
        bn.running_var.fill_(4.0)
    y = bn.eval()(torch.full((2, 3), 4.0))
    torch.testing.assert_close(y, torch.full((2, 3), 2.0 / (4.0 + 1e-5) ** 0.5))


# ------------------------------------------------------------ InputNormalization


def test_input_normalization_updates_then_freezes_like_jax():
    """3 training batches with ragged lengths at epochs 0, 1, 2 with
    ``update_until_epoch`` 2: the first sets the statistics, the second
    blends with weight 1/2, the third (epoch 2) leaves them frozen but
    still counts; then an eval call uses them as they are."""
    F_ = 5
    rng = np.random.default_rng(10)
    jnorm = JNorm(norm_type="global", update_until_epoch=2)
    state = JNormState.init(F_)
    norm = InputNormalization(F_, update_until_epoch=2).train()
    for epoch, lens in enumerate(([1.0, 0.7, 0.45], [0.55, 1.0, 0.9],
                                  [1.0, 1.0, 0.3])):
        x = (2.0 * rng.standard_normal((3, 11, F_)) + epoch).astype(np.float32)
        lens = np.asarray(lens, np.float32)
        jy, state = jnorm(jnp.asarray(x), lens, state=state, epoch=epoch,
                          training=True)
        y = norm(_t(x), _t(lens), epoch=epoch)
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
        for k, v in norm.state().items():
            np.testing.assert_allclose(v.numpy(), _np(state[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    assert float(norm.count) == 3.0
    x = rng.standard_normal((2, 4, F_)).astype(np.float32)
    jy, _ = jnorm(jnp.asarray(x), np.ones(2, np.float32), state=state,
                  training=False)
    before = norm.state()
    y = norm.eval()(_t(x), torch.ones(2))
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    for k, v in norm.state().items():
        assert torch.equal(v, before[k])


# ------------------------------------------------------------ Noam


def test_noam_scheduler_matches_jax_over_50_steps():
    ours, ref = NoamScheduler(8e-4, 10), JNoam(8e-4, 10)
    for _ in range(50):
        assert ours() == ref()


# ------------------------------------------------------------ clip, dropout


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(11)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = [_t(g.copy()) for g in grads]
        clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-7, rtol=1e-6)


def test_dropout_uses_its_generator_not_the_global_one():
    drop = Dropout(0.1)
    drop.generator = torch.Generator().manual_seed(3)
    torch.manual_seed(0)
    before = torch.get_rng_state()
    a = drop(torch.ones(200000))
    assert torch.equal(torch.get_rng_state(), before)
    kept = float((a > 0).float().mean())
    assert abs(kept - 0.9) < 0.01, kept
    assert set(torch.unique(a).tolist()) == {0.0, float(torch.tensor(1 / 0.9))}
    drop.generator.manual_seed(3)
    assert torch.equal(drop(torch.ones(200000)), a)
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.1)(torch.ones(3))


def test_brain_seeds_every_dropout_from_run_opts():
    cfg = dict(TOY, transformer_dropout=0.1)
    b1 = ConformerASRBrain(cfg, device="cpu", run_opts={"seed": 5})
    drops = [m for m in b1.modules.modules() if isinstance(m, Dropout)]
    assert len(drops) > 5 and all(d.generator is b1.generator for d in drops)
    b2 = ConformerASRBrain(cfg, device="cpu", run_opts={"seed": 5})
    assert torch.equal(b1.generator.get_state(), b2.generator.get_state())


def test_train_state_restores_the_generator_of_its_own_device_type(tmp_path):
    """The train state's file carries the generator's state with its
    device type: a CPU Brain takes back a CPU generator's state, and
    leaves its generator as it is for a card's Philox state (16 bytes,
    which a CPU generator's ``set_state`` refuses) or a file without
    one."""
    from speechbrain_tpu_torch.core import _TrainStateRecoverable

    brain = ConformerASRBrain(TOY, device="cpu", run_opts={"seed": 5})
    rec = _TrainStateRecoverable(brain)
    saved = brain.generator.get_state()
    rec._save(tmp_path / "cpu.ckpt")
    torch.rand(7, generator=brain.generator)
    rec._load(tmp_path / "cpu.ckpt")
    assert torch.equal(brain.generator.get_state(), saved)

    state = torch.load(tmp_path / "cpu.ckpt", weights_only=True)
    state["generator"] = {"device": "cuda",
                          "state": torch.arange(16, dtype=torch.uint8)}
    torch.save(state, tmp_path / "card.ckpt")
    del state["generator"]
    torch.save(state, tmp_path / "none.ckpt")
    torch.rand(7, generator=brain.generator)
    drawn = brain.generator.get_state()
    for name in ("card.ckpt", "none.ckpt"):
        rec._load(tmp_path / name)
        assert torch.equal(brain.generator.get_state(), drawn), name


# ------------------------------------------------------------ repaired faults


def _fake_cuda(T):
    return types.SimpleNamespace(device=torch.device("cuda"), shape=(1, T, 8))


@pytest.mark.parametrize("T,attn_mask,dropout,training,expected", [
    (512, None, 0.0, True, True),
    (1024, None, 0.0, False, True),
    (512, None, 0.1, False, True),   # eval: dropout is inactive
    (512, None, 0.1, True, False),   # training with dropout: materialized
    (256, None, 0.0, False, False),  # below 512
    (640, None, 0.0, True, True),    # 5 x 128
    (576, None, 0.0, False, False),  # 576 % 128 != 0
    (512, "mask", 0.0, False, False),
])
def test_relpos_gate_is_the_jax_gate(T, attn_mask, dropout, training, expected):
    """``RelPosMHAXL._kernel_ok`` follows the JAX gate
    (``speechbrain_tpu/nnet/attention.py``: T_q == T_k, T % 128 == 0,
    512 <= T <= 1024, no attn_mask, ``dropout == 0 or not train``) with
    "the tensor is on CUDA" for "the backend is a TPU"."""
    m = RelPosMHAXL(32, 2, dropout=dropout).train(training)  # d_head 16
    assert m._kernel_ok(_fake_cuda(T), T, T, attn_mask) is expected
    assert m._kernel_ok(_fake_cuda(T), T, T + 128, attn_mask) is False
    assert m._kernel_ok(torch.zeros(1, T, 8), T, T, attn_mask) is False
    m.use_kernels = False
    assert m._kernel_ok(_fake_cuda(T), T, T, attn_mask) is False


@pytest.mark.parametrize("embed_dim,num_heads,expected", [
    (144, 8, False),  # d_head 18: no kernel built for it
    (144, 4, True),   # d_head 36: conformer_small's
    (128, 2, True),   # d_head 64
])
def test_relpos_gate_needs_a_head_width_the_kernels_take(embed_dim, num_heads,
                                                         expected):
    """The kernels exist for ``ops.relpos_attention.HEAD_DIMS`` only (JAX's
    take any width): other widths take the materialized path on CUDA
    instead of reaching a kernel that raises."""
    m = RelPosMHAXL(embed_dim, num_heads).eval()
    assert m._kernel_ok(_fake_cuda(512), 512, 512, None) is expected


def test_beam_attend_step_refuses_inputs_that_require_grad():
    kv = torch.zeros(2, 8, 8)
    q = torch.zeros(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="decode-only"):
        ops.beam_attend_step(kv, torch.zeros(2, dtype=torch.long), q,
                             torch.zeros(2, 8), torch.zeros(2, 8), 1, 2)


def test_backward_only_kernels_refuse_to_be_recorded():
    """``refuse_grad`` guards the CUDA branch of the wrappers whose kernel
    has no backward of its own (K2, K3, K4, K6)."""
    from speechbrain_tpu_torch.ops import _build

    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", None, x)
    with torch.no_grad():
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", x.detach(), None)


def test_kernel_wrappers_keep_the_graph_on_the_cpu():
    """Every differentiable wrapper returns a result with a ``grad_fn``
    (the CPU runs the same autograd Functions as the card, with the
    plain versions inside)."""
    x = torch.randn(2, 9, 4, requires_grad=True)
    assert ops.depthwise_conv1d(x, torch.randn(3, 4)).requires_grad
    q = torch.randn(1, 1, 64, 16, requires_grad=True)
    p = torch.randn(1, 127, 16)
    out = ops.relpos_attention(q, q, q, p, torch.zeros(1, 16),
                               torch.zeros(1, 16), torch.zeros(1, 64), 0.25)
    assert out.requires_grad
    lp = torch.log_softmax(torch.randn(1, 6, 4), -1).requires_grad_(True)
    loss = ops.ctc_loss_per_seq(lp, torch.tensor([[1, 2]]), torch.tensor([6]),
                                torch.tensor([2]), 0)
    assert loss.requires_grad


def test_bfloat16_keeps_float32_parameters():
    """Serving and training in bf16 keep f32 parameters (and f32
    optimizer state): only the activations are bf16, as in the JAX
    package."""
    asr = ConformerASR(TOY, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in asr.parameters())
    enc = asr.encode(torch.zeros(1, 4000), torch.ones(1))
    assert enc.dtype == torch.bfloat16
    brain = ConformerASRBrain(TOY, device="cpu",
                              run_opts={"precision": "bf16",
                                        "loss_sync_interval": 1})
    tok = np.array([[3, 4, 5]])
    batch = {"sig": np.zeros((1, 4000), np.float32),
             "sig_lens": np.ones(1, np.float32), "tokens": tok,
             "tokens_bos": np.array([[1, 3, 4, 5]]),
             "tokens_eos": np.array([[3, 4, 5, 2]]),
             "tokens_lens": np.ones(1, np.float32),
             "tokens_eos_lens": np.ones(1, np.float32)}
    brain.step = 1
    assert np.isfinite(brain.fit_batch(batch))
    assert all(p.dtype == torch.float32 for p in brain.modules.parameters())
    states = [v for s in brain.optimizer.state.values() for v in s.values()
              if torch.is_tensor(v) and v.is_floating_point() and v.dim() > 0]
    assert states and all(v.dtype == torch.float32 for v in states)
    ctc, seq = brain.compute_forward(brain.prepare_batch(batch), None)
    assert ctc.dtype == seq.dtype == torch.float32  # f32 log_softmax


def test_brain_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        Brain({"lin": torch.nn.Linear(2, 1)})
