"""The Google Speech Commands x-vector recipe (``BASELINE.json`` config 1)
on the port, against the JAX package: its new modules one by one, then
the recipe end to end.

Modules, on the same numpy inputs and weights (through ``bridge.py``):
``Conv1d`` in every padding mode with dilation, stride and groups;
``StatisticsPooling`` with lengths (a dummy row included) and its mean
noise; ``Xvector`` and ``Classifier`` (both heads) in training and
eval, with their gradients and running statistics; ``Resample``;
``SpeedPerturb``, ``DropFreq``, ``DropChunk`` and
``TimeDomainSpecAugment`` with JAX's draws recomputed from its key (the
same ``jax.random`` calls as ``speechbrain_tpu/processing/
speech_augmentation.py``); the port's own draws by their ranges and
shares, with no host sync; ``AccuracyStats`` and
``classification_error``; 3 Adam steps behind the clip against optax's
``adam`` behind ``clip_by_global_norm``.  The JAX ``SpeedPerturb``'s
length fault gets a test of its own (``test_speed_perturb_lengths_follow
_the_content``).

The recipe: the port's ``recipes/gsc_xvector`` against the JAX recipe
(``recipes/Google-speech-commands/train.py``, its ``prepare_gsc``,
``SpeakerBrain`` and ``dataio_prep`` taken by path, hparams from
``hparams/xvect.yaml`` through JAX's ``load_hyperpyyaml``) on one
synthetic tree, at toy widths (TDNN 8 x 5, lin 8), f32, with the
augmentation on and its speeds held at 100 (at 95 and 105 the repaired
lengths differ from JAX's by design).  The two preparations give the
same manifests; both loaders collate with one fixed-shape policy (time
and the batch dim padded to one size, so the validation and test
batches have dummy rows and the JAX steps compile once); each port step
takes the draws JAX's step made from its own key.  Both fit 2 epochs from the same weights,
then evaluate the test set from the checkpoint with the best validation
accuracy:

- the per-step losses agree within 1e-5 relative and the rates (NewBob
  on the validation loss) exactly;
- the validation losses within 1e-5 and the accuracies exactly;
- the test loss within 1e-5 and the accuracy exactly;
- ``train_log.txt`` has the same lines up to the numbers.

And the port alone: 2 epochs and a resumed third in a fresh Brain end
with the state of 3 uninterrupted epochs, bit for bit (the generator,
which draws the augmentation, is part of the checkpoint).
"""

import functools
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechbrain_tpu.dataio.batch import BatchShapePolicy as JPolicy
from speechbrain_tpu.dataio.batch import PaddedBatch as JPaddedBatch
from speechbrain_tpu.dataio.dataloader import SaveableDataLoader as JLoader
from speechbrain_tpu.lobes.augment import TimeDomainSpecAugment as JTDSA
from speechbrain_tpu.lobes.models.Xvector import Classifier as JClassifier
from speechbrain_tpu.lobes.models.Xvector import Xvector as JXvector
from speechbrain_tpu.nnet.CNN import Conv1d as JConv1d
from speechbrain_tpu.nnet.losses import classification_error as j_class_error
from speechbrain_tpu.nnet.losses import nll_loss as j_nll_loss
from speechbrain_tpu.nnet.pooling import StatisticsPooling as JStatPool
from speechbrain_tpu.parallel.mesh import make_mesh
from speechbrain_tpu.processing import speech_augmentation as jsa
from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu.utils.metric_stats import AccuracyStats as JAccuracy
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.dataio.batch import BatchShapePolicy, PaddedBatch
from speechbrain_tpu_torch.lobes.augment import TimeDomainSpecAugment
from speechbrain_tpu_torch.lobes.models.Xvector import Classifier, Xvector
from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.losses import classification_error, nll_loss
from speechbrain_tpu_torch.nnet.pooling import StatisticsPooling
from speechbrain_tpu_torch.processing import speech_augmentation as sa
from speechbrain_tpu_torch.recipes import gsc_xvector as recipe
from speechbrain_tpu_torch.utils.metric_stats import AccuracyStats

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_timit import _jax_initialize, _load_path, _optimizer_parity

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "recipes/Google-speech-commands"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(tree, rng, scale=0.3):
    """Every leaf of a JAX variables tree replaced by normal noise (the
    BatchNorm variances kept positive)."""
    def leaf(path, x):
        v = rng.standard_normal(np.shape(x)).astype(np.float32) * scale
        if any(getattr(k, "key", None) == "var" for k in path):
            v = np.abs(v) + 0.5
        return v
    return jax.tree_util.tree_map_with_path(leaf, tree)


# ------------------------------------------------------------ Conv1d


CONV_CASES = (
    # "same" in reflect mode (the x-vector's): every shape option
    [("same", "reflect", *c) for c in ((5, 1, 1, 1), (3, 1, 3, 1),
                                       (4, 2, 1, 1), (3, 1, 2, 2))]
    # the other modes: a plain kernel, and a dilated or strided one
    + [("same", "zeros", 4, 2, 1, 1), ("causal", "reflect", 5, 1, 1, 1),
       ("causal", "reflect", 3, 1, 3, 1), ("valid", "reflect", 4, 2, 1, 1)])


@pytest.mark.parametrize("padding,mode,k,stride,dilation,groups", CONV_CASES)
def test_conv1d_matches_jax(padding, mode, k, stride, dilation, groups):
    """Outputs and gradients through ``bridge.conv1d``; a 2-d input is one
    channel (checked in the "same" modes).  Kernel size 1, the x-vector's
    last two blocks, runs in ``test_xvector_and_classifier_match_jax``."""
    rng = np.random.default_rng(k * 7 + stride + dilation)
    C_in = 4 if groups > 1 else 3
    x = rng.standard_normal((2, 17, C_in)).astype(np.float32)
    jconv = JConv1d(out_channels=6, kernel_size=k, stride=stride,
                    dilation=dilation, padding=padding, groups=groups,
                    padding_mode=mode)
    variables = _randomize(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           rng)
    conv = Conv1d(C_in, 6, k, stride=stride, dilation=dilation,
                  padding=padding, groups=groups, padding_mode=mode)
    conv.load_state_dict(bridge.conv1d(variables["params"]["Conv_0"]))
    R = rng.standard_normal(np.shape(jconv.apply(variables, x))).astype(np.float32)

    def jf(params, x):
        return (jconv.apply({"params": params}, x) * R).sum()

    jg, jgx = jax.grad(jf, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = conv(xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               _np(jconv.apply(variables, x)), atol=1e-5)
    (y * _t(R)).sum().backward()
    want = bridge.conv1d(jax.device_get(jg["Conv_0"]))
    np.testing.assert_allclose(conv.weight.grad.numpy(), want["weight"].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(conv.bias.grad.numpy(), want["bias"].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), atol=1e-5)
    if groups == 1 and padding == "same":
        x2 = x[..., 0]
        jc2 = JConv1d(out_channels=6, kernel_size=k, stride=stride,
                      dilation=dilation, padding=padding, padding_mode=mode)
        v2 = _randomize(jc2.init(jax.random.PRNGKey(1), jnp.asarray(x2)), rng)
        c2 = Conv1d(1, 6, k, stride=stride, dilation=dilation,
                    padding=padding, padding_mode=mode)
        c2.load_state_dict(bridge.conv1d(v2["params"]["Conv_0"]))
        np.testing.assert_allclose(c2(_t(x2)).detach().numpy(),
                                   _np(jc2.apply(v2, x2)), atol=1e-5)


# ------------------------------------------------------------ pooling


@pytest.mark.parametrize("with_lengths", [False, True])
def test_statistics_pooling_matches_jax(with_lengths):
    """The masked mean and the Bessel-corrected std (with its 1e-20 floor
    and + eps) over ``round(lengths * T)`` frames, half to even (0.25 x 10
    = 2.5 -> 2), a dummy row of length 0 with a finite gradient; and the
    mean noise with JAX's normal draw."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 10, 5)).astype(np.float32)
    lens = np.array([1.0, 0.25, 0.65, 0.0], np.float32) if with_lengths else None
    jl = None if lens is None else jnp.asarray(lens)
    R = rng.standard_normal((4, 1, 10)).astype(np.float32)
    want = _np(JStatPool()(jnp.asarray(x), jl))
    jgx = jax.grad(lambda x: (JStatPool()(x, jl) * R).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = StatisticsPooling()(xt, None if lens is None else _t(lens))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    (got * _t(R)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), atol=1e-5)
    key = jax.random.PRNGKey(3)
    want = _np(JStatPool()(jnp.asarray(x), jl, rng=key))
    pool = StatisticsPooling()
    base = pool(_t(x), None if lens is None else _t(lens))
    gnoise = _t(jax.random.normal(key, (4, 5), jnp.float32))
    mean = pool.add_noise(base[:, 0, :5], gnoise)
    np.testing.assert_allclose(mean.numpy(), want[:, 0, :5], atol=1e-6)
    noisy = pool(_t(x), None if lens is None else _t(lens),
                 generator=torch.Generator().manual_seed(0))
    shift = (noisy - base)[:, 0, :5]  # in [eps, 9 eps], up to f32 rounding
    assert float(shift.min()) >= 1e-5 - 2e-7 and float(shift.max()) <= 9e-5 + 2e-7
    assert torch.equal(noisy[:, 0, 5:], base[:, 0, 5:])


# ------------------------------------------------------------ Xvector


def _xvector_pair(rng, lin_blocks=1, cosine=False):
    """JAX and port Xvector (TDNN 8 x 4 + 10, lin 6) and Classifier (4
    classes) with the same random weights and running statistics."""
    x = rng.standard_normal((3, 20, 7)).astype(np.float32)
    jx = JXvector(tdnn_channels=(8, 8, 8, 8, 10), lin_neurons=6)
    jc = JClassifier(out_neurons=4, lin_blocks=lin_blocks, lin_neurons=5,
                     cosine=cosine)
    vx = _randomize(jx.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=False), rng)
    vc = _randomize(jc.init(jax.random.PRNGKey(1), jnp.ones((3, 6)),
                            train=False), rng)
    px = Xvector(7, tdnn_channels=(8, 8, 8, 8, 10), lin_neurons=6)
    pc = Classifier(6, out_neurons=4, lin_blocks=lin_blocks, lin_neurons=5,
                    cosine=cosine)
    px.load_state_dict(bridge.xvector_state_dict(vx))
    pc.load_state_dict(bridge.classifier_state_dict(vc))
    return x, (jx, vx, px), (jc, vc, pc)


@pytest.mark.parametrize("train,cosine,lin_blocks", [
    (True, False, 1), (True, True, 1), (True, False, 2), (False, True, 1),
    (False, False, 2)])
def test_xvector_and_classifier_match_jax(train, cosine, lin_blocks):
    """The embedding over each row's frames and the head's log-probs (or
    cosines), the input's and every parameter's gradient, and (training)
    the BatchNorms' updated running statistics.  The gradients are held
    within 1e-3 of each tensor's largest entry (or of 5 % of the largest
    gradient entry of the two modules, where that is more): in
    training, both packages' BatchNorm takes the variance as E[x^2] -
    E[x]^2 in f32 over 60 rows, and 6 of them lie between the loss and
    the input; at these weights the port's own f32 gradients differ from
    its f64 ones by up to 2.2e-4 of their scale, and those whose value is
    ~0 (a bias before the pooling's std) are f32 noise of ~1e-5."""
    rng = np.random.default_rng(9 + lin_blocks + 2 * cosine)
    x, (jx, vx, px), (jc, vc, pc) = _xvector_pair(rng, lin_blocks, cosine)
    lens = np.array([1.0, 0.55, 0.8], np.float32)
    R = rng.standard_normal((3, 4)).astype(np.float32)

    def jf(px_, pc_, x):
        emb, sx = jx.apply({"params": px_, "batch_stats": vx["batch_stats"]},
                           x, lengths=jnp.asarray(lens), train=train,
                           mutable=["batch_stats"])
        out, sc = jc.apply({"params": pc_, "batch_stats": vc["batch_stats"]},
                           emb[:, 0], train=train, mutable=["batch_stats"])
        return (out * R).sum(), (out, sx, sc)

    (_, (jout, sx, sc)), (gx_, gc_, gxin) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(vx["params"], vc["params"],
                                              jnp.asarray(x))
    px.train(train)
    pc.train(train)
    xt = _t(x).requires_grad_()
    out = pc(px(xt, lengths=_t(lens))[:, 0])
    # the batch statistics' f32 rounding (below) reaches the outputs too
    np.testing.assert_allclose(out.detach().numpy(), _np(jout),
                               atol=1e-4 if train else 2e-5, rtol=0)
    (out * _t(R)).sum().backward()
    wants = [to_sd({"params": jax.device_get(grads),
                    "batch_stats": jax.device_get(stats["batch_stats"])})
             for to_sd, grads, stats in (
                 (bridge.xvector_state_dict, gx_, sx),
                 (bridge.classifier_state_dict, gc_, sc))]
    G = max(float(v.abs().max()) for want in wants for v in want.values())

    def close(got, want, what):
        scale = max(float(np.abs(want).max()), 0.05 * G)
        dev = float(np.abs(got - want).max())
        assert dev <= 1e-3 * scale, f"{what}: {dev} > 1e-3 x {scale}"

    close(xt.grad.numpy(), _np(gxin), "input")
    for module, want in zip((px, pc), wants):
        for name, p in module.named_parameters():
            close(p.grad.numpy(), want[name].numpy(), name)
        sd = module.state_dict()
        for name in want:
            if "running" in name:
                np.testing.assert_allclose(sd[name].numpy(),
                                           want[name].numpy(), atol=1e-5,
                                           err_msg=name)


def test_xvector_bridge_round_trip_is_exact():
    rng = np.random.default_rng(10)
    for cosine in (False, True):
        _, (_, vx, px), (_, vc, pc) = _xvector_pair(rng, cosine=cosine)
        for module, to_jax, to_sd in (
                (px, bridge.to_jax_xvector, bridge.xvector_state_dict),
                (pc, bridge.to_jax_classifier, bridge.classifier_state_dict)):
            back = to_jax(module.state_dict())
            sd = to_sd(back)
            assert sd.keys() == module.state_dict().keys()
            assert all(torch.equal(sd[k], v)
                       for k, v in module.state_dict().items())
        for ref, back in ((vx, bridge.to_jax_xvector(px.state_dict())),
                          (vc, bridge.to_jax_classifier(pc.state_dict()))):
            assert (jax.tree_util.tree_structure(back)
                    == jax.tree_util.tree_structure(jax.device_get(ref)))


# ------------------------------------------------------------ augmentation


@pytest.mark.parametrize("orig,new", [(16000, 15200), (16000, 16800),
                                      (16000, 8000), (8000, 16000),
                                      (16000, 16000)])
def test_resample_matches_jax(orig, new):
    """The polyphase weights (float64 at init) and the output, (B, T)
    (and (B, T, C) at the recipe's speed 95)."""
    rng = np.random.default_rng(11)
    shapes = ((3, 1601), (2, 500, 2)) if new == 15200 else ((3, 1601),)
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        want = _np(jsa.Resample(orig, new)(jnp.asarray(x)))
        got = sa.Resample(orig, new)(_t(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


def _tdsa_draws(aug, key, shape):
    """The values JAX's ``TimeDomainSpecAugment.__call__`` draws from
    ``key`` for (B, T) waveforms, in the port's ``draws`` form."""
    B, T = shape
    k1, k2, k3 = jax.random.split(key, 3)
    sp = aug.speed_perturb
    k_prob, k_speed = jax.random.split(k1)
    speed = {"index": _t(jax.random.randint(k_speed, (), 0, len(sp.speeds))),
             "apply": _t(jax.random.uniform(k_prob, ()) < sp.perturb_prob)}
    df = aug.drop_freq
    k_prob, k_count, k_freq = jax.random.split(k2, 3)
    freq = {"count": _t(jax.random.randint(k_count, (), df.drop_count_low,
                                           df.drop_count_high + 1)),
            "freqs": _t(jax.random.uniform(k_freq, (df.drop_count_high,))
                        * (df.drop_freq_high - df.drop_freq_low)
                        + df.drop_freq_low),
            "apply": _t(jax.random.uniform(k_prob, ()) < df.drop_prob)}
    dc = aug.drop_chunk
    k_prob, k_count, k_len, k_start, k_noise = jax.random.split(k3, 5)
    n = dc.drop_count_high
    end = dc.drop_end if dc.drop_end is not None else T
    chunk = {
        "counts": _t(jax.random.randint(k_count, (B,), dc.drop_count_low, n + 1)),
        "lens": _t(jax.random.randint(k_len, (B, n), dc.drop_length_low,
                                      dc.drop_length_high + 1)),
        "starts": _t(jax.random.randint(k_start, (B, n), dc.drop_start,
                                        max(end, dc.drop_start + 1))),
        "noise": (None if dc.noise_factor == 0.0
                  else _t(jax.random.uniform(k_noise, (B, T)))),
        "apply": _t(jax.random.uniform(k_prob, ()) < dc.drop_prob)}
    return {"speed": speed, "freq": freq, "chunk": chunk}


TDSA_ARGS = [
    {},  # the recipe's: speeds 95/100/105, 0-3 notches, 0-5 chunks
    {"speeds": [100]},
    {"drop_chunk_noise_factor": 0.5, "drop_freq_count_low": 2},
    {"perturb_prob": 0.5, "drop_freq_prob": 0.5, "drop_chunk_prob": 0.5},
]


@pytest.mark.parametrize("args,seed", [(TDSA_ARGS[0], 0), (TDSA_ARGS[0], 1),
                                       (TDSA_ARGS[0], 2), (TDSA_ARGS[1], 0),
                                       (TDSA_ARGS[2], 0), (TDSA_ARGS[2], 1),
                                       (TDSA_ARGS[3], 0)])
def test_time_domain_augment_with_jax_draws_matches_jax(args, seed):
    """The waveforms of the whole chain (speed, notches, chunks, the
    noise fill) equal JAX's with its draws; the lengths equal JAX's
    where the drawn speed is 100 or the perturbation is off, and are the
    repaired ones (``min(lengths * t_new / T, 1)``) otherwise.  The
    noise fill scales with each row's amplitude over its length, so the
    reference runs JAX's three steps with its keys and the port's
    lengths (the whole JAX chain where those agree)."""
    rng = np.random.default_rng(12 + seed)
    x = (0.3 * rng.standard_normal((3, 8000))).astype(np.float32)
    lens = np.array([1.0, 0.7, 0.45], np.float32)
    jaug = JTDSA(sample_rate=16000, **args)
    aug = TimeDomainSpecAugment(sample_rate=16000, **args)
    key = jax.random.PRNGKey(seed)
    jwav, jlens = jaug(jnp.asarray(x), jnp.asarray(lens), key)
    draws = _tdsa_draws(jaug, key, x.shape)
    wav, new_lens = aug(_t(x), _t(lens), draws=draws)
    k1, k2, k3 = jax.random.split(key, 3)
    ref, _ = jaug.speed_perturb(jnp.asarray(x), jnp.asarray(lens), k1)
    ref = jaug.drop_chunk(jaug.drop_freq(ref, k2),
                          jnp.asarray(new_lens.numpy()), k3)
    np.testing.assert_allclose(wav.numpy(), _np(ref), atol=2e-6)
    speed = aug.speed_perturb.speeds[int(draws["speed"]["index"])]
    if speed == 100 or not bool(draws["speed"]["apply"]):
        np.testing.assert_array_equal(new_lens.numpy(), _np(jlens))
        np.testing.assert_allclose(wav.numpy(), _np(jwav), atol=2e-6)
    else:
        t_new = -(-8000 * speed // 100)
        np.testing.assert_allclose(new_lens.numpy(),
                                   np.minimum(lens * t_new / 8000, 1.0),
                                   rtol=1e-6)


@pytest.mark.parametrize("speed", [95, 105])
def test_speed_perturb_lengths_follow_the_content(speed):
    """The repaired fault of the JAX ``SpeedPerturb``: a signal that fills
    half the window is resampled to ``speed``% of its samples, and the
    new relative length is the share of the window it fills (0.475 at 95,
    0.525 at 105).  JAX's ``lengths * 100 / speed`` reads 0.526 and 0.476:
    this test fails if the port copies it.  (The recipe parity holds the
    speed at 100, where the two agree.)"""
    T = 16000
    x = np.zeros((1, T), np.float32)
    x[0, :T // 2] = np.random.default_rng(13).uniform(0.5, 1.0, T // 2)
    sp = sa.SpeedPerturb(16000, speeds=[speed])
    draws = {"index": torch.tensor(0), "apply": torch.tensor(True)}
    wav, lens = sp(_t(x), torch.tensor([0.5]), draws=draws)
    filled = (int(np.nonzero(np.abs(wav.numpy()[0]) > 1e-3)[0].max()) + 1) / T
    assert abs(filled - speed / 200) < 1e-3
    assert abs(float(lens[0]) - filled) < 2e-3
    jwav, jlens = jsa.SpeedPerturb(16000, speeds=[speed])(
        jnp.asarray(x), jnp.asarray([0.5]), jax.random.PRNGKey(0))
    np.testing.assert_allclose(wav.numpy(), _np(jwav), atol=1e-6)
    assert abs(float(jlens[0]) - filled) > 0.04  # JAX's, the fault


def test_own_draws_by_their_ranges_and_shares():
    """Many draws from one generator: the speed index uniform over the
    speeds; the notch count in [low, high] and the frequencies in [low,
    high); the chunk counts, lengths and starts in their ranges; each
    ``apply`` at about its probability; the same seed, the same draws."""
    aug = TimeDomainSpecAugment(sample_rate=16000, perturb_prob=0.3,
                                drop_freq_prob=0.6, drop_chunk_prob=0.9)
    g = torch.Generator().manual_seed(123)
    n = 3000
    d = [aug.draw((4, 8000), g) for _ in range(n)]
    idx = torch.stack([x["speed"]["index"] for x in d])
    counts = torch.bincount(idx, minlength=3).float()
    assert float((counts - n / 3).abs().max()) < 5 * (n / 3) ** 0.5
    for part, p in (("speed", 0.3), ("freq", 0.6), ("chunk", 0.9)):
        share = float(torch.stack([x[part]["apply"] for x in d]).float().mean())
        assert abs(share - p) < 5 * (p * (1 - p) / n) ** 0.5, part
    fc = torch.stack([x["freq"]["count"] for x in d])
    assert int(fc.min()) == 0 and int(fc.max()) == 3
    freqs = torch.stack([x["freq"]["freqs"] for x in d])
    assert float(freqs.min()) >= 1e-14 and float(freqs.max()) < 1.0
    cc = torch.stack([x["chunk"]["counts"] for x in d])
    cl = torch.stack([x["chunk"]["lens"] for x in d])
    cs = torch.stack([x["chunk"]["starts"] for x in d])
    assert (int(cc.min()), int(cc.max())) == (0, 5)
    assert (int(cl.min()), int(cl.max())) == (1000, 2000)
    assert (int(cs.min()), int(cs.max())) == (0, 7999)
    a = aug.draw((4, 8000), torch.Generator().manual_seed(5))
    b = aug.draw((4, 8000), torch.Generator().manual_seed(5))
    assert all(torch.equal(a["chunk"][k], b["chunk"][k])
               for k in ("counts", "lens", "starts"))


def test_augment_makes_no_host_sync_nor_host_copy(monkeypatch):
    """A call draws and augments without reading a value back and without
    making a tensor from host data: every way a tensor reaches the host,
    and ``torch.tensor``/``from_numpy``, raise while it runs."""
    aug = TimeDomainSpecAugment(sample_rate=16000,
                                drop_chunk_noise_factor=0.5)
    x = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([1.0, 0.6])
    g = torch.Generator().manual_seed(1)

    def sync(*args, **kwargs):
        raise AssertionError("host sync or host copy")

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    monkeypatch.setattr(torch, "tensor", sync)
    monkeypatch.setattr(torch, "from_numpy", sync)
    out, new_lens = aug(x, lens, g)
    monkeypatch.undo()
    assert out.shape == x.shape and new_lens.shape == lens.shape


# ------------------------------------------------------------ metrics, Adam


@pytest.mark.parametrize("with_lengths", [False, True])
def test_accuracy_and_classification_error_match_jax(with_lengths):
    """``AccuracyStats`` over two batches of (B, T, C) log-probs and
    ``classification_error`` (each reduction, and (B, C) inputs), with
    ties broken to the first class as ``argmax`` does."""
    rng = np.random.default_rng(14)
    ours, ref = AccuracyStats(), JAccuracy()
    for _ in range(2):
        lp = np.log(rng.dirichlet(np.ones(5), (4, 6))).astype(np.float32)
        lp[0, 0, :] = np.log(0.2)  # a tie
        tgt = rng.integers(0, 5, (4, 6))
        lens = rng.uniform(0.2, 1.0, 4).astype(np.float32) if with_lengths else None
        ours.append(_t(lp), _t(tgt), None if lens is None else _t(lens))
        ref.append(lp, tgt, lens)
        for red in ("mean", "batch", "sum", "batchmean"):
            got = classification_error(_t(lp), _t(tgt),
                                       None if lens is None else _t(lens),
                                       reduction=red)
            want = j_class_error(jnp.asarray(lp), jnp.asarray(tgt),
                                 None if lens is None else jnp.asarray(lens),
                                 reduction=red)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)
    assert ours.summarize() == ref.summarize()
    assert ours.summarize("total") == ref.summarize("total")
    lp2 = np.log(rng.dirichlet(np.ones(5), 7)).astype(np.float32)
    tgt2 = rng.integers(0, 5, 7)
    np.testing.assert_allclose(
        classification_error(_t(lp2), _t(tgt2)).numpy(),
        _np(j_class_error(jnp.asarray(lp2), jnp.asarray(tgt2))), rtol=1e-6)
    # the recipe's nll_loss with length=batch_mask on (B, C) log-probs
    mask = np.array([1, 1, 1, 0, 1, 0, 1], np.float32)
    np.testing.assert_allclose(
        nll_loss(_t(lp2), _t(tgt2), length=_t(mask)).numpy(),
        _np(j_nll_loss(jnp.asarray(lp2), jnp.asarray(tgt2),
                       length=jnp.asarray(mask))), rtol=1e-6)


def test_adam_behind_the_clip_matches_optax():
    """3 steps of the recipe's ``torch.optim.Adam(0.9, 0.999, 1e-8)``
    against ``optax.adam`` (``eps_root`` 0) at NewBob's rates, the clip
    to 5 acting on each."""
    brain = recipe.SpeakerBrain({"tdnn_channels": (2,) * 5, "lin_neurons": 2},
                                run_opts={"device": "cpu"})
    norms = _optimizer_parity(brain.opt_class,
                              lambda lr: optax.adam(learning_rate=lr),
                              [1e-3, 8e-4, 6.4e-4], grad_scale=4.0)
    assert min(norms) > 5.0


# ------------------------------------------------------------ the recipe

# Adam's first steps move every parameter by ~lr x sign(gradient), so a
# gradient that is ~0 analytically (the last TDNN block's BatchNorm
# bias and the embedding's bias: the head's BatchNorm nearly removes
# them), whose sign the frameworks' f32 rounding decides, moves by
# +-lr: at the yaml's 1e-3 the losses drift apart by ~2e-4 within 5
# steps.  The update itself is held to optax at 1e-3 in
# test_adam_behind_the_clip_matches_optax.
LR = 1e-5
TOY = dict(tdnn_channels=(8,) * 5, lin_neurons=8, batch_size=8,
           number_of_epochs=2, lr=LR,
           augmentation={"sample_rate": 16000, "speeds": [100]})
YAML_OVERRIDES = f"""
lr: {LR:.1e}
batch_size: 8
number_of_epochs: 2
augmentation: !new:speechbrain_tpu.lobes.augment.TimeDomainSpecAugment
    sample_rate: 16000
    speeds: [100]
embedding_model: !new:speechbrain_tpu.lobes.models.Xvector.Xvector
    tdnn_channels: !tuple [8, 8, 8, 8, 8]
    lin_neurons: 8
classifier: !new:speechbrain_tpu.lobes.models.Xvector.Classifier
    out_neurons: 12
    lin_neurons: 8
"""
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
# 3 full training batches; the validation and test batches padded to 8
# with 2 dummy rows each (in training, dummy rows of zeros feed the
# BatchNorms' batch statistics, where the two frameworks' f32 sums of
# E[x^2] - E[x]^2 differ enough to move a later loss by ~1e-5)
CLIPS = {"train": 24, "valid": 6, "test": 6}
SAMPLES, ROWS = 16000, 8


def _policy(cls):
    return cls(time_buckets=[SAMPLES], time_keys=("sig",),
               batch_buckets=[ROWS])


def _port_collate(examples):
    return PaddedBatch(examples, shape_policy=_policy(BatchShapePolicy))


def _record(brain, out):
    fit_end, stage_end = brain.on_fit_batch_end, brain.on_stage_end

    def on_fit_batch_end(batch, outputs, loss, should_step):
        out["losses"].append(float(loss))
        out["lrs"].append(brain.lr)
        fit_end(batch, outputs, loss, should_step)

    def on_stage_end(stage, stage_loss, epoch=None):
        if stage.name != "TRAIN":
            out[stage.name].append((float(stage_loss),
                                    brain.acc_metric.summarize()))
        stage_end(stage, stage_loss, epoch)

    brain.on_fit_batch_end = on_fit_batch_end
    brain.on_stage_end = on_stage_end


def _to_jax(pb):
    sd = pb.modules.state_dict()
    xv = bridge.to_jax_xvector(sd, "embedding_model.")
    cl = bridge.to_jax_classifier(sd, "classifier.")
    state = {"params": {"embedding_model": xv["params"],
                        "classifier": cl["params"]},
             "model_state": {"embedding_model": {"batch_stats": xv["batch_stats"]},
                             "classifier": {"batch_stats": cl["batch_stats"]}},
             "extra": {}}
    return jax.tree_util.tree_map(jnp.asarray, state)


class _JaxDraws:
    """The port Brain's augmentation with the draws JAX's steps made:
    ``keys`` holds each JAX training step's "augment" key, in order."""

    def __init__(self, aug, jaug, keys):
        self.aug, self.jaug, self.keys = aug, jaug, keys

    def __call__(self, wavs, lens, generator=None):
        draws = _tdsa_draws(self.jaug, self.keys.pop(0), tuple(wavs.shape))
        return self.aug(wavs, lens, draws=draws)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("gsc_recipe")
    data = str(root / "GSC")
    recipe.write_synthetic_gsc(data, CLIPS, seed=3)
    train = _load_path("gsc_train", RECIPE / "train.py")

    # ---- the port: recipes.gsc_xvector at toy widths
    parts = recipe.build(data, str(root / "port"), TOY, RUN_OPTS)
    pb = parts["brain"]
    for key in ("train_loader", "valid_loader", "test_loader"):
        parts[key].collate_fn = _port_collate

    # ---- JAX: the recipe's __main__
    with open(RECIPE / "hparams" / "xvect.yaml") as f:
        hp = load_hyperpyyaml(f, YAML_OVERRIDES + f"data_folder: {data}\n"
                              f"output_folder: {root / 'jax'}\n")
    train.prepare_gsc(data_folder=data, save_folder=hp["save_folder"])
    manifests = {s: (json.load(open(hp[f"{s}_json"])),
                     json.load(open(parts["hparams"][f"{s}_json"])))
                 for s in ("train", "valid", "test")}
    datasets = train.dataio_prep(hp)

    class JaxSpeaker(train.SpeakerBrain):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.mesh = make_mesh(jax.devices()[:1])
            self.augment_keys = []

        def fit_batch(self, batch):
            # the key this step's augmentation draws from (fit_batch's
            # _next_rng, then _make_step_rngs)
            sub = jax.random.split(self._rng)[1]
            self.augment_keys.append(self._make_step_rngs(sub)["augment"])
            return super().fit_batch(batch)

        @functools.cached_property
        def _forward(self):
            def forward(state, rngs, batch, stage):
                self._bind(state["params"], state["model_state"],
                           state["extra"], rngs, train=False)
                return self.compute_forward(batch, stage)
            return jax.jit(forward, static_argnums=3)

        def evaluate_batch_full(self, batch, stage):
            device_batch = self.prepare_batch(batch)
            predictions = self._forward(
                self.train_state, self._make_step_rngs(self._next_rng()),
                device_batch, stage)
            return float(self.compute_objectives(predictions, device_batch,
                                                 stage))

    jb = JaxSpeaker(
        modules=hp["modules"],
        opt_class=lambda lr: hp["opt_class"](learning_rate=lr), hparams=hp,
        run_opts={"loss_sync_interval": 1, "noprogressbar": True},
        checkpointer=JCheckpointer(hp["save_folder"]))
    _jax_initialize(jb, _to_jax(pb))

    def loader(split, shuffle=False):
        return JLoader(datasets[split], batch_size=ROWS, shuffle=shuffle,
                       collate_fn=lambda ex: JPaddedBatch(
                           ex, shape_policy=_policy(JPolicy)))

    out = {name: {"losses": [], "lrs": [], "VALID": [], "TEST": []}
           for name in ("jax", "port")}
    _record(jb, out["jax"])
    _record(pb, out["port"])
    jb.fit(hp["epoch_counter"], loader("train", True), loader("valid"))
    jb.evaluate(loader("test"), max_key="acc")
    keys = list(jb.augment_keys)
    pb.augment = _JaxDraws(pb.augment, hp["augmentation"], keys)
    pb.fit(parts["epoch_counter"], parts["train_loader"],
           parts["valid_loader"])
    pb.evaluate(parts["test_loader"], max_key="acc")
    return dict(out, root=root, data=data, jb=jb, pb=pb, parts=parts,
                manifests=manifests, unused_keys=keys)


def _rel_close(a, b, rtol=1e-5):
    assert abs(a - b) <= rtol * max(1.0, abs(b)), (a, b)


def test_recipe_manifests_match_jax(fitted):
    """The same clips in the same splits with the same labels; no
    ``_silence_`` row (JAX skips the ``_``-folders) and every 10-command
    word is a command, the 2 others ``_unknown_``."""
    for split, (j, p) in fitted["manifests"].items():
        assert j == p and len(p) == CLIPS[split], split
        ids = [e["command_id"] for e in p.values()]
        assert 11 not in ids
        if split == "train":
            assert sorted(set(ids)) == list(range(11))


def test_recipe_losses_and_lrs_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["losses"]) == len(j["losses"]) == 6  # 3 batches x 2 epochs
    for a, b in zip(p["losses"], j["losses"]):
        _rel_close(a, b)
    assert p["lrs"] == j["lrs"]
    assert fitted["pb"].lr == fitted["jb"].lr
    assert fitted["unused_keys"] == []  # each step took JAX's draws


def test_recipe_validation_and_test_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["VALID"]) == len(j["VALID"]) == 2
    assert len(p["TEST"]) == len(j["TEST"]) == 1
    for (pl, pacc), (jl, jacc) in zip(p["VALID"] + p["TEST"],
                                      j["VALID"] + j["TEST"]):
        _rel_close(pl, jl)
        assert pacc == jacc and 0.0 <= pacc <= 1.0
    pb = fitted["pb"]
    best = max(c.meta["acc"] for c in pb.checkpointer.list_checkpoints())
    assert pb._recovered_ckpt.meta["acc"] == best
    assert pb.stage_stats["TEST"]["acc"] == p["TEST"][0][1]


def test_recipe_train_log_matches_jax(fitted):
    def shape(path):
        return [re.sub(r"-?\d[\d.e+-]*", "#", line)
                for line in Path(path).read_text().splitlines()]

    root = fitted["root"]
    got = shape(root / "port" / "train_log.txt")
    assert got == shape(root / "jax" / "train_log.txt")
    assert len(got) == 2 and got[0].startswith("epoch: #, lr: #")


def test_recipe_resumed_epoch_equals_the_uninterrupted_one(fitted, tmp_path):
    """A fresh Brain on a copy of a 2-epoch folder runs epoch 3 (the
    augmentation on at the yaml's speeds, drawn from the Brain's
    generator, which the checkpoint carries) and ends where 3
    uninterrupted epochs end, bit for bit."""
    hp = dict(TOY, augmentation=recipe.HPARAMS["augmentation"])

    def run(out, epochs):
        parts = recipe.build(fitted["data"], out,
                             dict(hp, number_of_epochs=epochs), RUN_OPTS)
        for key in ("train_loader", "valid_loader"):
            parts[key].collate_fn = _port_collate
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    run(str(tmp_path / "first"), 2)
    shutil.copytree(tmp_path / "first", tmp_path / "resumed")
    resumed = run(str(tmp_path / "resumed"), 3)
    whole = run(str(tmp_path / "whole"), 3)
    a, b = resumed.modules.state_dict(), whole.modules.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = (resumed.optimizer.state_dict()["state"],
              whole.optimizer.state_dict()["state"])
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert resumed.lr == whole.lr
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
