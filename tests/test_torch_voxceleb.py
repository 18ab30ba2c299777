"""The VoxCeleb speaker recognition recipes (``BASELINE.json`` config 3,
ECAPA-TDNN with AAM-softmax and cosine scoring; and the x-vector yaml
with the PLDA backend) on the port, against the JAX package: the new
modules one by one, then the recipes end to end.

Modules, on the same numpy inputs (and weights through ``bridge.py``):
``AngularMargin``, ``AdditiveAngularMargin`` (both margins' branches)
and ``LogSoftmaxWrapper``, values and gradients within 1e-5; the
``CyclicLRScheduler``'s rates in its three modes, exactly, and its
checkpoint both ways; ``InputNormalization`` in sentence and batch mode
with and without ``mean_norm``/``std_norm``, values within 1e-5 and
gradients within 1e-5; every ``ECAPA_TDNN`` class in training and eval
at toy widths, with lengths that leave a short row: outputs within 1e-4
of their scale in training (the BatchNorms' f32 E[x^2] - E[x]^2, as in
``test_torch_gsc.py``) and 1e-5 in eval, gradients within 1e-3 of each
tensor's scale, running statistics within 1e-5; the bridge's round
trips, exactly; ``EER``/``minDCF`` on scores with ties, exactly equal;
``PLDA_LDA`` in float64 (the stat objects' sums and covariances, LDA up
to its columns' signs, PLDA's ``Sigma`` and ``F F^T``, the scores of
``fast_PLDA_scoring`` within 1e-6, ``fa_model_loop``, ``diff``,
``ismember``).

The recipe: the port's ``recipes/voxceleb_speaker`` against the JAX
recipe (``recipes/VoxCeleb/SpeakerRec/train_speaker_embeddings.py``'s
``SpeakerBrain`` and ``dataio_prep`` and ``voxceleb_prepare.py``, taken
by path, hparams from ``train_ecapa_tdnn.yaml`` through JAX's
``load_hyperpyyaml``) on one synthetic tree, at toy widths (ECAPA 16 x 4
+ 48, scale 4, attention 8, lin 8), f32, clips of 2 and 2.5 s (no crop),
the augmentation on with its speeds held at 100 (each port step takes
the draws JAX's step made), both loaders padding the time to 3 s.  Both
fit 2 epochs from the same weights at lr 1e-6 and lr_final 1e-7 with a
cyclic half-period of 3 steps (at the yaml's 1e-3 Adam's sign-like first
steps move near-zero gradients by +-lr: ``test_torch_gsc.py``): the
per-step losses agree within 5e-5 relative (the training-mode
BatchNorms' f32 statistics), the rates exactly, the validation losses
within 1e-5.  Then both verification scripts run on
the same tree and trials with the same weights (the cosine script with
the port's trained ECAPA, the PLDA script with a random x-vector): the
cosine scores within 1e-5, the PLDA scores within 1e-4 relative, EER and
minDCF exactly equal.  And the port alone: 2 epochs and a resumed third
in a fresh Brain end with the state of 3 uninterrupted epochs, bit for
bit, with crops and the yaml's speeds.

Tests of this slice's decisions, each failing on a naive copy of JAX:
the crop keyed by (seed, epoch, id); the trial paths under ``wav/``; the
x-vector yaml's AAM over log-softmax outputs (a JAX fault the port
copies, pinned); EER/minDCF at 20k trials within a memory bound that
JAX's N x 2N comparison matrices exceed.
"""

import functools
import json
import shutil
import sys
import tracemalloc
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import speechbrain_tpu as jsb
from speechbrain_tpu.dataio.batch import BatchShapePolicy as JPolicy
from speechbrain_tpu.dataio.batch import PaddedBatch as JPaddedBatch
from speechbrain_tpu.dataio.dataloader import SaveableDataLoader as JLoader
from speechbrain_tpu.lobes.models import ECAPA_TDNN as J
from speechbrain_tpu.nnet import losses as jl
from speechbrain_tpu.nnet.schedulers import CyclicLRScheduler as JCyclic
from speechbrain_tpu.processing import PLDA_LDA as JP
from speechbrain_tpu.processing.features import InputNormalization as JNorm
from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu.utils.metric_stats import EER as JEER
from speechbrain_tpu.utils.metric_stats import minDCF as JminDCF
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import _random_init
from speechbrain_tpu_torch.dataio.batch import BatchShapePolicy, PaddedBatch
from speechbrain_tpu_torch.dataio.dataloader import SaveableDataLoader
from speechbrain_tpu_torch.lobes.models import ECAPA_TDNN as P
from speechbrain_tpu_torch.nnet import losses as pl
from speechbrain_tpu_torch.nnet.schedulers import CyclicLRScheduler
from speechbrain_tpu_torch.pretrained.training import save_for_pretrained
from speechbrain_tpu_torch.processing import PLDA_LDA as PP
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes import voxceleb_prepare as prep
from speechbrain_tpu_torch.recipes import voxceleb_speaker as recipe
from speechbrain_tpu_torch.utils.metric_stats import EER, minDCF

from .test_torch_gsc import _JaxDraws, _randomize, _rel_close
from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_timit import _jax_initialize, _load_path, _optimizer_parity

REPO = Path(__file__).resolve().parents[1]
SPEAKER_REC = REPO / "recipes/VoxCeleb/SpeakerRec"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ losses


def _cosines(rng, shape):
    """Cosines spread over (-1, 1), with both sides of the AAM's
    threshold cos(pi - 0.2) = -0.980 and values near the edges."""
    c = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    c.flat[:4] = [-0.9999, -0.99, -0.97, 0.9999]
    return c


def _aam_nan_free(margin, scale):
    """JAX's ``AdditiveAngularMargin`` with a sine whose gradient is 0
    where ``1 - cos^2`` is clipped (JAX's own gives 0 x inf = NaN there:
    ``test_xvector_yaml_puts_aam_over_log_softmax``)."""
    import math

    def aam(cosine, targets):
        u = jnp.clip(1.0 - cosine ** 2, 0.0, 1.0)
        sine = jnp.where(u > 0, jnp.sqrt(jnp.where(u > 0, u, 1.0)), 0.0)
        phi = cosine * math.cos(margin) - sine * math.sin(margin)
        phi = jnp.where(cosine > math.cos(math.pi - margin), phi,
                        cosine - math.sin(math.pi - margin) * margin)
        return scale * (targets * phi + (1.0 - targets) * cosine)
    return aam


@pytest.mark.parametrize("kind", ["angular", "aam", "aam_easy", "wrapped",
                                  "wrapped_3d", "wrapped_logsoftmax"])
def test_angular_margin_losses_match_jax(kind):
    """The margins' logits and the wrapper's loss, values and input
    gradients within 1e-5; ``wrapped_logsoftmax`` feeds log-probabilities
    (< -1 included), as the x-vector yaml does: there the gradients are
    held to JAX's formula with a NaN-free sine (``_aam_nan_free``)."""
    rng = np.random.default_rng(len(kind))
    B, C = 6, 5
    x = _cosines(rng, (B, C))
    if kind == "wrapped_logsoftmax":
        x = _np(jax.nn.log_softmax(3 * jnp.asarray(x), -1))
    tgt = rng.integers(0, C, B)
    onehot = np.eye(C, dtype=np.float32)[tgt]
    R = rng.standard_normal((B, C)).astype(np.float32)
    if kind == "angular":
        j, p = jl.AngularMargin(0.2, 30), pl.AngularMargin(0.2, 30)
    else:
        easy = kind == "aam_easy"
        j = jl.AdditiveAngularMargin(0.2, 30, easy_margin=easy)
        p = pl.AdditiveAngularMargin(0.2, 30, easy_margin=easy)
    if kind == "wrapped_logsoftmax":
        j = _aam_nan_free(0.2, 30)
    if kind.startswith("wrapped"):
        j, p = jl.LogSoftmaxWrapper(j), pl.LogSoftmaxWrapper(p)
        xin = x[:, None, :] if kind == "wrapped_3d" else x
        tin = tgt[:, None] if kind == "wrapped_3d" else tgt

        def jf(x):
            return j(x, jnp.asarray(tin))

        def pf(x):
            return p(x, _t(tin))
    else:
        xin = x

        def jf(x):
            return (j(x, jnp.asarray(onehot)) * R).sum()

        def pf(x):
            return (p(x, _t(onehot)) * _t(R)).sum()
    want, jg = jax.value_and_grad(jf)(jnp.asarray(xin))
    xt = _t(xin).requires_grad_()
    got = pf(xt)
    got.backward()
    assert bool(torch.isfinite(xt.grad).all()) and bool(jnp.isfinite(jg).all())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jg), atol=1e-5, rtol=1e-5)
    if not kind.startswith("wrapped"):
        np.testing.assert_allclose(
            p(_t(x), _t(onehot)).numpy(),
            _np(j(jnp.asarray(x), jnp.asarray(onehot))), atol=1e-5, rtol=1e-6)


# ------------------------------------------------------------ schedule


@pytest.mark.parametrize("mode,gamma", [("triangular", 1.0),
                                        ("triangular2", 1.0),
                                        ("exp_range", 0.9)])
def test_cyclic_lr_matches_jax_and_resumes(mode, gamma, tmp_path):
    """40 calls of each mode (half-period 4: five cycles) give JAX's
    ``(previous, new)`` pairs exactly; a schedule loaded from the other's
    checkpoint file (both directions) continues with the same rates."""
    kw = dict(base_lr=1e-4, max_lr=1e-3, step_size=4, mode=mode, gamma=gamma)
    j, p = JCyclic(**kw), CyclicLRScheduler(**kw)
    for _ in range(20):
        assert p() == j()
    p._save(tmp_path / "port.json")
    j._save(tmp_path / "jax.json")
    p2, j2 = CyclicLRScheduler(**kw), JCyclic(**kw)
    p2._load(tmp_path / "jax.json")
    j2._load(tmp_path / "port.json")
    for _ in range(20):
        want = j()
        assert p() == want and p2() == want and j2() == want


def test_recipe_rate_sequence_matches_jax_brain():
    """The recipe's rates: step 1 at ``lr`` (1e-3, the Brain's start),
    then the cyclic schedule's ~1.0001e-4 rising by 9e-4 / 65000 a step,
    each equal to the JAX schedule's."""
    brain = recipe.SpeakerBrain(dict(_ECAPA_TOY, out_neurons=3),
                                run_opts={"device": "cpu"})
    j = JCyclic(base_lr=1e-4, max_lr=1e-3, step_size=65000)
    assert brain.lr == 1e-3
    rates = []
    for _ in range(5):
        rates.append(brain.lr)
        brain.on_fit_batch_end(None, None, None, True)
    want = [1e-3] + [j()[1] for _ in range(4)]
    assert rates == want
    assert abs(rates[1] - 1.0001e-4) < 1e-8


# ------------------------------------------------------------ normalization


@pytest.mark.parametrize("norm_type", ["sentence", "batch"])
@pytest.mark.parametrize("mean_norm,std_norm", [(True, False), (True, True),
                                                (False, True)])
def test_input_normalization_matches_jax(norm_type, mean_norm, std_norm):
    """Over ``round(len * T)`` frames (0.25 x 10 = 2.5 -> 2, half to
    even), a row of length 1 frame (its std's Bessel denominator
    floored), and the statistics detached: values and the input's
    gradient within 1e-5; eval mode gives the same."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 10, 6)).astype(np.float32) * 3 + 1
    lens = np.array([1.0, 0.25, 0.65, 0.1], np.float32)
    R = rng.standard_normal(x.shape).astype(np.float32)
    jn = JNorm(norm_type=norm_type, mean_norm=mean_norm, std_norm=std_norm)
    want, jg = jax.value_and_grad(
        lambda x: (jn(x, jnp.asarray(lens)) * R).sum())(jnp.asarray(x))
    norm = InputNormalization(norm_type=norm_type, mean_norm=mean_norm,
                              std_norm=std_norm)
    xt = _t(x).requires_grad_()
    y = norm(xt, _t(lens))
    np.testing.assert_allclose(
        y.detach().numpy(), _np(jn(jnp.asarray(x), jnp.asarray(lens))),
        atol=1e-5, rtol=1e-5)
    (y * _t(R)).sum().backward()
    np.testing.assert_allclose(float((y * _t(R)).sum()), float(want),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jg), atol=1e-5, rtol=1e-5)
    assert torch.equal(norm.eval()(_t(x), _t(lens)), y.detach())
    # without lengths: every frame
    np.testing.assert_allclose(
        norm(_t(x)).numpy(), _np(jn(jnp.asarray(x), jnp.ones(4))),
        atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ ECAPA

_WIDTHS = dict(channels=(16, 16, 16, 16, 48), lin_neurons=8,
               attention_channels=8, res2net_scale=4, se_channels=8)
_ECAPA_TOY = dict(_WIDTHS, n_mels=10)
# 0.1 x 30: 3 frames; 8 rows, since over 4 the pooled (B, 1, C)
# BatchNorm's f32 gradients drift from JAX's beyond 1e-3 of their scale
LENS = np.array([1.0, 0.55, 0.8, 0.1, 0.9, 1.0, 0.7, 0.35], np.float32)


def _ecapa_case(name, rng):
    """(JAX module, port module, input, call kwargs) of one class."""
    x = rng.standard_normal((len(LENS), 30, 16)).astype(np.float32)
    if name == "TDNNBlock":
        return (J.TDNNBlock(out_channels=12, kernel_size=3, dilation=2),
                P.TDNNBlock(16, 12, 3, 2), x, {})
    if name == "Res2NetBlock":
        return (J.Res2NetBlock(out_channels=16, scale=4, kernel_size=3,
                               dilation=3),
                P.Res2NetBlock(16, 16, 4, 3, 3), x, {})
    if name == "SEBlock":
        return J.SEBlock(se_channels=8, out_channels=16), P.SEBlock(16, 8, 16), x, {}
    if name == "AttentiveStatisticsPooling":
        return (J.AttentiveStatisticsPooling(attention_channels=8),
                P.AttentiveStatisticsPooling(16, 8), x, {})
    if name == "AttentiveStatisticsPooling_local":
        return (J.AttentiveStatisticsPooling(attention_channels=8,
                                             global_context=False),
                P.AttentiveStatisticsPooling(16, 8, global_context=False), x, {})
    if name == "SERes2NetBlock":
        return (J.SERes2NetBlock(out_channels=24, res2net_scale=4,
                                 se_channels=8, kernel_size=3, dilation=2),
                P.SERes2NetBlock(16, 24, 4, 8, 3, 2), x, {})
    if name == "ECAPA_TDNN":  # two SE-Res2Net blocks, to compile faster
        x = rng.standard_normal((len(LENS), 30, 10)).astype(np.float32)
        w = dict(_WIDTHS, channels=(16, 16, 16, 48),
                 kernel_sizes=(5, 3, 3, 1), dilations=(1, 2, 3, 1))
        return J.ECAPA_TDNN(**w), P.ECAPA_TDNN(10, **w), x, {}
    lin_blocks = 1 if name == "Classifier_lin" else 0
    x = rng.standard_normal((len(LENS), 1, 8)).astype(np.float32)
    return (J.Classifier(out_neurons=5, lin_blocks=lin_blocks, lin_neurons=8),
            P.Classifier(8, 5, lin_blocks=lin_blocks, lin_neurons=8), x, {})


_TO_SD = {"ECAPA_TDNN": bridge.ecapa_state_dict,
          "SERes2NetBlock": bridge.seres2net_state_dict,
          "Classifier": bridge.ecapa_classifier_state_dict,
          "Classifier_lin": bridge.ecapa_classifier_state_dict}


def _sub_state_dict(name, variables):
    """JAX variables of one inner class -> the port's state_dict, through
    the bridge's pieces (the classes of the model's insides)."""
    if name in _TO_SD:
        return _TO_SD[name](variables)
    p, st = variables["params"], variables.get("batch_stats", {})
    if name == "TDNNBlock":
        return bridge._tdnn_block(p, st)
    if name == "Res2NetBlock":
        return {f"blocks.{i - 1}.{k}": v for i in range(1, len(p) + 1)
                for k, v in bridge._tdnn_block(p[f"block_{i}"],
                                               st[f"block_{i}"]).items()}
    if name == "SEBlock":
        return {**{f"conv1.{k}": v for k, v in bridge.conv1d(
            p["Conv1d_0"]["Conv_0"]).items()},
            **{f"conv2.{k}": v for k, v in bridge.conv1d(
                p["Conv1d_1"]["Conv_0"]).items()}}
    return {**{f"tdnn.{k}": v for k, v in bridge._tdnn_block(
        p["TDNNBlock_0"], st["TDNNBlock_0"]).items()},
        **{f"conv.{k}": v for k, v in bridge.conv1d(
            p["Conv1d_0"]["Conv_0"]).items()}}


ECAPA_CLASSES = ["TDNNBlock", "Res2NetBlock", "SEBlock",
                 "AttentiveStatisticsPooling",
                 "AttentiveStatisticsPooling_local", "SERes2NetBlock",
                 "ECAPA_TDNN", "Classifier", "Classifier_lin"]
_TAKES_LENGTHS = {"SEBlock", "AttentiveStatisticsPooling",
                  "AttentiveStatisticsPooling_local", "SERes2NetBlock",
                  "ECAPA_TDNN"}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ECAPA_CLASSES)
def test_ecapa_classes_match_jax(name, train):
    """Outputs (within 1e-4 of their scale in training, where the
    BatchNorms' f32 statistics differ by rounding, 1e-5 in eval), the
    input's and every parameter's gradient (within 1e-3 of each tensor's
    scale, or of 5 % of the largest gradient: the attention's conv bias
    has an analytic gradient of 0, f32 noise in both; in training the
    BatchNorms' f32 batch statistics bound the agreement), and
    (training) the running statistics (1e-5), with
    lengths that leave one row 3 frames (the SE mean is over ``t < len *
    T`` frames, not rounded)."""
    rng = np.random.default_rng(ECAPA_CLASSES.index(name) + 10 * train)
    jm, pm, x, _ = _ecapa_case(name, rng)
    kw = ({"lengths": jnp.asarray(LENS)} if name in _TAKES_LENGTHS else {})
    # jitted: eager Flax compiles every operation on its own
    variables = _randomize(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    pm.load_state_dict(_sub_state_dict(name, variables))
    out_shape = jax.eval_shape(functools.partial(jm.apply, train=False, **kw),
                               variables, jnp.asarray(x)).shape
    R = rng.standard_normal(out_shape).astype(np.float32)
    stats = variables.get("batch_stats", {})

    def jf(params, x):
        out, new = jm.apply({"params": params, "batch_stats": stats}, x,
                            **kw, train=train, mutable=["batch_stats"])
        return (out * R).sum(), (out, new)

    (_, (jout, jnew)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    pm.train(train)
    xt = _t(x).requires_grad_()
    pkw = {"lengths": _t(LENS)} if name in _TAKES_LENGTHS else {}
    out = pm(xt, **pkw)
    scale = float(np.abs(_np(jout)).max())
    assert float(np.abs(out.detach().numpy() - _np(jout)).max()) <= (
        (1e-4 if train else 1e-5) * max(scale, 1.0))
    (out * _t(R)).sum().backward()
    want = _sub_state_dict(name, {"params": jax.device_get(jg),
                                  "batch_stats": jax.device_get(
                                      jnew.get("batch_stats", stats))})
    G = max(float(v.abs().max()) for k, v in want.items()
            if "running" not in k)

    def close(got, ref, what):
        s = max(float(np.abs(ref).max()), 0.05 * G)
        dev = float(np.abs(got - ref).max())
        assert dev <= 1e-3 * s, f"{what}: {dev} > 1e-3 x {s}"

    close(xt.grad.numpy(), _np(jgx), "input")
    for pname, p in pm.named_parameters():
        close(p.grad.numpy(), want[pname].numpy(), pname)
    sd = pm.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["ECAPA_TDNN", "SERes2NetBlock",
                                  "Classifier", "Classifier_lin"])
def test_ecapa_bridge_round_trip_is_exact(name):
    """JAX -> port -> JAX -> port: the same tensors bit for bit, and the
    JAX tree's structure back (the shortcut conv of a widening
    SE-Res2Net block included)."""
    rng = np.random.default_rng(20)
    jm, pm, x, _ = _ecapa_case(name, rng)
    variables = jax.device_get(_randomize(jax.jit(functools.partial(
        jm.init, train=False))(jax.random.PRNGKey(0), jnp.asarray(x)), rng))
    pm.load_state_dict(_sub_state_dict(name, variables))
    to_jax = {"ECAPA_TDNN": bridge.to_jax_ecapa,
              "SERes2NetBlock": bridge.to_jax_seres2net}.get(
        name, bridge.to_jax_ecapa_classifier)
    back = to_jax(pm.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)))
    sd = _sub_state_dict(name, back)
    assert sd.keys() == pm.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in pm.state_dict().items())
    if name == "SERes2NetBlock":
        assert "shortcut.weight" in sd


def test_random_init_takes_the_head_weight_as_in_out():
    """``asr._random_init`` draws the ECAPA head's (lin, out) weight with
    std 1/sqrt(lin), JAX's ``lecun_normal`` fan-in (at 192 x 7205 the
    other axis would give a std 6x smaller)."""
    head = P.Classifier(192, 7205, lin_neurons=192)
    _random_init(head, torch.Generator().manual_seed(0))
    std = float(head.weight.std())
    assert abs(std - 192 ** -0.5) < 0.01 * 192 ** -0.5


# ------------------------------------------------------------ metrics


@pytest.mark.parametrize("seed", range(6))
def test_eer_and_min_dcf_equal_jax(seed):
    """Scores rounded to 0.1 (many ties between and within the classes),
    a class of one score, and unrounded ones: EER, minDCF (two cost
    settings) and their thresholds equal JAX's exactly; tensors work."""
    rng = np.random.default_rng(seed)
    n_pos, n_neg = [(300, 500), (1, 40), (40, 1), (7, 9), (200, 200),
                    (50, 3000)][seed]
    pos = rng.normal(1.0, 1.0, n_pos)
    neg = rng.normal(0.0, 1.0, n_neg)
    if seed % 2 == 0:
        pos, neg = np.round(pos, 1), np.round(neg, 1)
    assert EER(pos, neg) == JEER(pos, neg)
    assert minDCF(pos, neg) == JminDCF(pos, neg)
    kw = dict(c_miss=10.0, c_fa=1.0, p_target=0.05)
    assert minDCF(pos, neg, **kw) == JminDCF(pos, neg, **kw)
    assert EER(_t(pos).float(), _t(neg).float()) == JEER(
        pos.astype(np.float32), neg.astype(np.float32))


def test_eer_at_20k_trials_needs_no_quadratic_memory():
    """20k trials (the real ``veri_test2.txt`` has ~37.6k): JAX's formula
    compares every score with every one of ~40k thresholds, two boolean
    matrices of 10k x 40k = 400 MB each.  The port's peak allocation,
    traced, stays under 16 MB, and it agrees with JAX's formula on the
    first 2k trials."""
    rng = np.random.default_rng(7)
    pos = rng.normal(1.0, 1.0, 10_000)
    neg = rng.normal(0.0, 1.0, 10_000)
    n_thresholds = 2 * len(np.unique(np.concatenate([pos, neg]))) - 1
    assert len(pos) * n_thresholds > 16 * 2 ** 20 * 20  # JAX: 20x the bound
    tracemalloc.start()
    try:
        eer, _ = EER(pos, neg)
        dcf, _ = minDCF(pos, neg)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 16 * 2 ** 20, peak
    assert 0.0 < eer < 1.0 and 0.0 < dcf <= 0.01
    assert EER(pos[:1000], neg[:1000]) == JEER(pos[:1000], neg[:1000])
    assert minDCF(pos[:1000], neg[:1000]) == JminDCF(pos[:1000], neg[:1000])


# ------------------------------------------------------------ PLDA


def _plda_data(rng, n_spk=7, per=6, dim=8):
    spk = np.repeat(np.arange(n_spk), per)
    x = rng.normal(size=(n_spk, dim))[spk] * 2 + rng.normal(size=(len(spk), dim))
    return np.array([f"s{i}" for i in spk]), x


def _stat(mod, models, segs, x):
    n = len(segs)
    return mod.StatObject_SB(modelset=np.asarray(models), segset=np.asarray(segs),
                             start=np.array([None] * n),
                             stop=np.array([None] * n),
                             stat0=np.ones((n, 1)), stat1=x.copy())


def test_stat_object_and_lda_match_jax():
    """The stat object's mean, total covariance, per-model sums and
    segment counts, model rows, centring, normalization, rotation and
    whitening within 1e-12; LDA's projection up to each column's sign."""
    rng = np.random.default_rng(30)
    models, x = _plda_data(rng)
    segs = [f"u{i}" for i in range(len(x))]
    j, p = _stat(JP, models, segs, x), _stat(PP, models, segs, x)

    def close(a, b):
        np.testing.assert_allclose(_np(a.cpu() if torch.is_tensor(a) else a),
                                   b, atol=1e-12, rtol=1e-12)

    close(p.get_mean_stat1(), j.get_mean_stat1())
    close(p.get_total_covariance_stat1(), j.get_total_covariance_stat1())
    close(p.get_model_stat1("s3"), j.get_model_stat1("s3"))
    close(p.get_model_stat0("s3"), j.get_model_stat0("s3"))
    (ps, pn), (js, jn) = p.sum_stat_per_model(), j.sum_stat_per_model()
    assert list(ps.modelset) == list(js.modelset)
    close(ps.stat1, js.stat1)
    close(ps.stat0, js.stat0)
    close(pn, jn)
    R = rng.normal(size=(8, 8))
    sigma = R @ R.T + np.eye(8)
    mu = rng.normal(size=8)
    for op, args in (("center_stat1", (mu,)), ("rotate_stat1", (R,)),
                     ("norm_stat1", ()), ("whiten_stat1", (mu, sigma))):
        getattr(p, op)(*args)
        getattr(j, op)(*args)
        if op == "whiten_stat1":  # eigenvectors: each column up to its sign
            sign = np.sign((p.stat1.numpy() * j.stat1).sum(0))
            close(p.stat1 * _t(sign), j.stat1)
        else:
            close(p.stat1, j.stat1)
    a = JP.LDA().do_lda(_stat(JP, models, segs, x), 3).stat1
    b = PP.LDA().do_lda(_stat(PP, models, segs, x), 3).stat1.numpy()
    np.testing.assert_allclose(b * np.sign((a * b).sum(0)), a, atol=1e-9)


@pytest.mark.parametrize("rank_f,scaling", [(5, 1.0), (3, 0.5), (100, 1.0)])
def test_plda_and_fast_scoring_match_jax(rank_f, scaling):
    """PLDA's EM (10 iterations; rank capped at the dimension) gives JAX's
    ``mean``, ``Sigma`` and ``F F^T`` within 1e-9, and
    ``fast_PLDA_scoring`` JAX's score matrix within 1e-6 (and its mask),
    on a trial list with repeated models and segments."""
    rng = np.random.default_rng(31 + rank_f)
    models, x = _plda_data(rng)
    segs = [f"u{i}" for i in range(len(x))]
    jp = JP.PLDA(rank_f=rank_f, scaling_factor=scaling).plda(
        _stat(JP, models, segs, x))
    pp = PP.PLDA(rank_f=rank_f, scaling_factor=scaling).plda(
        _stat(PP, models, segs, x))
    np.testing.assert_allclose(pp.mean.numpy(), jp.mean, atol=1e-12)
    np.testing.assert_allclose(pp.Sigma.numpy(), jp.Sigma, atol=1e-9)
    np.testing.assert_allclose((pp.F @ pp.F.T).numpy(), jp.F @ jp.F.T,
                               atol=1e-9)
    e, t = rng.normal(size=(5, 8)) * 2, rng.normal(size=(6, 8)) * 2
    eid, tid = [f"e{i}" for i in range(5)], [f"t{i}" for i in range(6)]
    trial_m = [eid[i % 5] for i in range(14)]
    trial_t = [tid[(3 * i) % 6] for i in range(14)]
    js = JP.fast_PLDA_scoring(_stat(JP, eid, eid, e), _stat(JP, tid, tid, t),
                              JP.Ndx(models=trial_m, testsegs=trial_t),
                              jp.mean, jp.F, jp.Sigma, scaling_factor=scaling)
    ps = PP.fast_PLDA_scoring(_stat(PP, eid, eid, e), _stat(PP, tid, tid, t),
                              PP.Ndx(models=trial_m, testsegs=trial_t),
                              pp.mean, pp.F, pp.Sigma, scaling_factor=scaling)
    assert list(ps.modelset) == list(js.modelset)
    assert list(ps.segset) == list(js.segset)
    assert np.array_equal(ps.scoremask, js.scoremask)
    np.testing.assert_allclose(ps.scoremat.numpy(), js.scoremat, atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("diag", [False, True])
def test_fa_model_loop_and_helpers_match_jax(diag):
    """``fa_model_loop`` with a full (shared posteriors by segment count)
    and a diagonal ``Sigma`` fills ``e_h``/``e_hh`` as JAX does (1e-12);
    ``diff`` and ``ismember`` as JAX's."""
    rng = np.random.default_rng(40)
    F = rng.normal(size=(6, 3))
    Sigma = np.abs(rng.normal(size=6)) + 0.5 if diag else np.eye(6)
    stat0 = rng.integers(1, 4, (5, 1)).astype(np.float64)
    stat1 = rng.normal(size=(5, 6))
    je_h, je_hh = np.zeros((3, 3)), np.zeros((3, 3, 3))
    JP.fa_model_loop(2, [0, 1, 2], SimpleNamespace(F=F, Sigma=Sigma), stat0,
                     stat1, je_h, je_hh)
    pe_h = torch.zeros(3, 3, dtype=torch.float64)
    pe_hh = torch.zeros(3, 3, 3, dtype=torch.float64)
    PP.fa_model_loop(2, [0, 1, 2], SimpleNamespace(F=F, Sigma=Sigma),
                     _t(stat0), _t(stat1), pe_h, pe_hh)
    np.testing.assert_allclose(pe_h.numpy(), je_h, atol=1e-12)
    np.testing.assert_allclose(pe_hh.numpy(), je_hh, atol=1e-12)
    a, b = ["d", "a", "c", "b"], ["c", "x"]
    assert PP.diff(a, b) == JP.diff(a, b)
    assert PP.ismember(a, b) == JP.ismember(a, b)


def test_save_for_pretrained_writes_each_module(tmp_path):
    """One ``torch.save`` state dict a module (buffers included, on the
    CPU) and the hparams as JSON; a module loads back bit for bit."""
    model = P.ECAPA_TDNN(10, **_WIDTHS)
    head = P.Classifier(8, 5, lin_neurons=8)
    brain = SimpleNamespace(modules=torch.nn.ModuleDict(
        {"embedding_model": model, "classifier": head}))
    paths = save_for_pretrained(brain, tmp_path / "out",
                                hparams={"lr": 0.1, "channels": (1, 2)})
    assert sorted(Path(p).name for p in paths) == [
        "classifier.ckpt", "embedding_model.ckpt", "hyperparams.json"]
    fresh = P.ECAPA_TDNN(10, **_WIDTHS)
    fresh.load_state_dict(torch.load(tmp_path / "out" / "embedding_model.ckpt",
                                     weights_only=True))
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), model.state_dict().values()))
    assert json.loads((tmp_path / "out/hyperparams.json").read_text())[
        "channels"] == [1, 2]


# ------------------------------------------------------------ decisions


def test_crop_is_keyed_by_epoch_and_utterance(tmp_path):
    """The crops of clips longer than 3 s: the same at an epoch whatever
    came before (a fresh pipeline at epoch 2, as after a resume, crops as
    the one that ran epoch 1 first) and whatever the loader's threads
    (0 or 3 workers); other crops at another epoch.  JAX's one shared
    generator fails the first two: its crops depend on how many were
    drawn before."""
    data = str(tmp_path / "vox")
    recipe.write_synthetic_voxceleb(data, speakers=2, clips=5,
                                    seconds=(3.2, 4.5), seed=1)
    hp = dict(recipe.HPARAMS_ECAPA, train_json=str(tmp_path / "train.json"),
              valid_json=str(tmp_path / "valid.json"))
    prep.prepare_voxceleb(data, str(tmp_path), seed=hp["seed"])

    def sigs(epoch, workers, warm=False):
        datasets, _, crop = recipe.dataio_prep(hp)
        if warm:
            crop.set_epoch(epoch - 1)
            list(SaveableDataLoader(datasets["train"], batch_size=3))
        crop.set_epoch(epoch)
        loader = SaveableDataLoader(datasets["train"], batch_size=3,
                                    shuffle=True, num_workers=workers)
        return {i: s for b in loader
                for i, s in zip(b.id, b.sig.data)}

    a = sigs(2, 0, warm=True)
    b = sigs(2, 0)
    c = sigs(2, 3)
    assert a.keys() == b.keys() == c.keys() and len(a) == 8
    for k in a:
        assert len(a[k]) == 48000
        assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k])
    d = sigs(3, 0)
    assert any(not np.array_equal(a[k], d[k]) for k in a)


def test_trial_paths_resolve_under_wav(tmp_path):
    """On VoxCeleb's layout (``wav/idXXXXX/...``, trials relative to
    ``wav/``) every trial path the port writes exists; the JAX scripts'
    call (the corpus folder as the root) gives paths that do not."""
    data = tmp_path / "vox"
    recipe.write_synthetic_voxceleb(str(data), speakers=2, clips=3,
                                    seconds=(0.2, 0.3))
    jprep = _load_path("vox_prepare", REPO / "recipes/VoxCeleb/voxceleb_prepare.py")
    pairs = str(data / "veri_test2.txt")
    prep.prepare_trials(pairs, prep.wav_root(str(data)), tmp_path / "p.json")
    jprep.prepare_trials(pairs, str(data), tmp_path / "j.json")
    port = json.loads((tmp_path / "p.json").read_text())
    jax_trials = json.loads((tmp_path / "j.json").read_text())
    assert len(port) == len(jax_trials) == 16
    assert all(Path(t[k]).exists() for t in port for k in ("enrol", "test"))
    assert not any(Path(t[k]).exists() for t in jax_trials
                   for k in ("enrol", "test"))
    assert prep.wav_root(str(tmp_path)) == str(tmp_path)  # no wav/: itself


def test_xvector_yaml_puts_aam_over_log_softmax(tmp_path):
    """A JAX fault the port copies, for parity: ``train_x_vectors.yaml``'s
    head is the x-vector ``Classifier`` with ``cosine`` False, so the
    AAM's "cosines" are log-probabilities (all <= 0, most < -1, where
    the sine is clipped to 0).  The port's x-vector SpeakerBrain does the
    same: its head's outputs are log-softmax, and its loss is the AAM
    wrapper over them, equal to JAX's on the same numbers.

    And one the port does not copy: there JAX's gradient is NaN
    everywhere (``sqrt``'s infinite slope at the clipped 0 times the
    clip's zero slope), so a JAX x-vector run's parameters are NaN after
    its first step; the port's clamp passes no gradient there, so its
    gradients are finite and equal JAX's formula with a NaN-free
    sine."""
    with open(SPEAKER_REC / "hparams/train_x_vectors.yaml") as f:
        jhp = load_hyperpyyaml(f, f"data_folder: {tmp_path}\n"
                               f"output_folder: {tmp_path}\n")
    assert jhp["classifier"].cosine is False
    hp = dict(recipe.HPARAMS_XVECTOR, tdnn_channels=(8,) * 5, lin_neurons=8,
              out_neurons=40, n_mels=8)
    brain = recipe.SpeakerBrain(hp, run_opts={"device": "cpu"})
    emb = torch.randn(6, 1, 8, generator=torch.Generator().manual_seed(0))
    out = brain.modules.classifier.eval()(emb)
    assert torch.allclose(out.exp().sum(-1), torch.ones(6, 1))
    assert bool((out <= 0).all()) and float((out < -1).float().mean()) > 0.5
    tgt = torch.tensor([0, 5, 9, 3, 39, 1])
    leaf = out.detach().requires_grad_()
    got = brain.aam_loss(leaf, tgt)
    got.backward()
    lp = jnp.asarray(out.detach().numpy())
    want, jg = jax.value_and_grad(
        lambda x: jhp["aam_loss"](x, jnp.asarray(tgt.numpy())))(lp)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert bool(jnp.isnan(jg).all())  # JAX's
    safe = jax.grad(lambda x: jl.LogSoftmaxWrapper(_aam_nan_free(0.2, 30))(
        x, jnp.asarray(tgt.numpy())))(lp)
    assert bool(torch.isfinite(leaf.grad).all())
    np.testing.assert_allclose(leaf.grad.numpy(), _np(safe), atol=1e-6)


def test_adam_behind_the_clip_matches_optax():
    """3 steps of the recipe's ``torch.optim.Adam(0.9, 0.999, 1e-8)``
    against ``optax.adam`` at the cyclic schedule's first rates, the
    clip to 5 acting on each."""
    brain = recipe.SpeakerBrain(dict(_ECAPA_TOY, out_neurons=3),
                                run_opts={"device": "cpu"})
    norms = _optimizer_parity(brain.opt_class,
                              lambda lr: optax.adam(learning_rate=lr),
                              [1e-3, 1.0001e-4, 1.0003e-4], grad_scale=4.0)
    assert min(norms) > 5.0


# ------------------------------------------------------------ the recipe

LR, LR_FINAL, STEP_SIZE = 1e-6, 1e-7, 3
TOY = dict(_WIDTHS, out_neurons=4, batch_size=10, number_of_epochs=2, lr=LR,
           lr_final=LR_FINAL, step_size=STEP_SIZE,
           augmentation={"sample_rate": 16000, "speeds": [100]})
YAML_OVERRIDES = f"""
lr: {LR:.1e}
lr_final: {LR_FINAL:.1e}
batch_size: 10
number_of_epochs: 2
out_neurons: 4
augmentation: !new:speechbrain_tpu.lobes.augment.TimeDomainSpecAugment
    sample_rate: 16000
    speeds: [100]
lr_annealing: !new:speechbrain_tpu.nnet.schedulers.CyclicLRScheduler
    base_lr: {LR_FINAL:.1e}
    max_lr: {LR:.1e}
    step_size: {STEP_SIZE}
"""
ECAPA_YAML = """
embedding_model: !new:speechbrain_tpu.lobes.models.ECAPA_TDNN.ECAPA_TDNN
    channels: !tuple [16, 16, 16, 16, 48]
    kernel_sizes: !tuple [5, 3, 3, 3, 1]
    dilations: !tuple [1, 2, 3, 4, 1]
    attention_channels: 8
    lin_neurons: 8
    res2net_scale: 4
    se_channels: 8
"""
CLASSIFIER_YAML = """
classifier: !new:speechbrain_tpu.lobes.models.ECAPA_TDNN.Classifier
    out_neurons: 4
    lin_neurons: 8
"""
XVECTOR_WIDTHS = dict(tdnn_channels=(8, 8, 8, 8, 8), lin_neurons=8)
XVECTOR_YAML = """
embedding_model: !new:speechbrain_tpu.lobes.models.Xvector.Xvector
    tdnn_channels: !tuple [8, 8, 8, 8, 8]
    lin_neurons: 8
"""
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
SAMPLES, ROWS = 48000, 10
# 4 speakers x 11 clips: 40 train (4 batches of 10), 4 valid
CLIPS = dict(speakers=4, clips=11, seconds=(2.0, 2.9), trials_per_speaker=2)


def _two_lengths(folder, samples=(31840, 40000)):
    """Cut every clip of a synthetic tree to the longest of ``samples``
    it holds: two lengths, so that the JAX scripts' eager per-file
    forwards compile their operations for two shapes, not one per file
    (minutes at 16 lengths); 31840 samples are the 200 frames of the
    scripts' initialising example.  The batches still pad rows of 0.66
    and 0.83 of 3 s."""
    import wave
    for path in Path(folder).rglob("*.wav"):
        with wave.open(str(path)) as w:
            frames = w.readframes(w.getnframes())
        keep = max(s for s in samples if s <= len(frames) // 2)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(frames[:2 * keep])


def _policy(cls):
    return cls(time_buckets=[SAMPLES], time_keys=("sig",))


def _port_collate(examples):
    return PaddedBatch(examples, shape_policy=_policy(BatchShapePolicy))


def _record(brain, out):
    fit_end, stage_end = brain.on_fit_batch_end, brain.on_stage_end

    def on_fit_batch_end(batch, outputs, loss, should_step):
        out["losses"].append(float(loss))
        out["lrs"].append(brain.lr)
        fit_end(batch, outputs, loss, should_step)

    def on_stage_end(stage, stage_loss, epoch=None):
        if stage.name == "VALID":
            out["VALID"].append(float(stage_loss))
        stage_end(stage, stage_loss, epoch)

    brain.on_fit_batch_end = on_fit_batch_end
    brain.on_stage_end = on_stage_end


def _to_jax(pb):
    sd = pb.modules.state_dict()
    emb = bridge.to_jax_ecapa(sd, "embedding_model.")
    head = bridge.to_jax_ecapa_classifier(sd, "classifier.")
    state = {"params": {"embedding_model": emb["params"],
                        "classifier": head["params"]},
             "model_state": {"embedding_model": {
                 "batch_stats": emb["batch_stats"]}},
             "extra": {}}
    return jax.tree_util.tree_map(jnp.asarray, state)


def _run_jax_script(script, yaml_name, overrides, cwd):
    """``main()`` of a JAX verification script taken by path, run in
    ``cwd``, its yaml read with ``overrides``; its ``EER``/``minDCF``
    calls are recorded (their score lists and results).  The data paths
    are given relative to ``cwd``: the PLDA script keeps ids as
    ``<U100`` strings, which would cut a long temporary path."""
    calls = {}

    def recording(name, fn):
        def wrapped(pos, neg, **kw):
            result = fn(pos, neg, **kw)
            calls[name] = (list(pos), list(neg), result)
            return result
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SPEAKER_REC))
        mp.chdir(cwd)
        module = _load_path(script, SPEAKER_REC / f"{script}.py")
        mp.setattr(jsb, "parse_arguments", lambda *a: (
            str(SPEAKER_REC / "hparams" / yaml_name), {}, overrides))
        mp.setattr(jsb, "create_experiment_directory",
                   lambda d, *a, **k: Path(d).mkdir(parents=True,
                                                    exist_ok=True))
        mp.setattr(module, "EER", recording("EER", JEER))
        mp.setattr(module, "minDCF", recording("minDCF", JminDCF))
        module.main()
        sys.modules.pop("speaker_verification_cosine", None)
    return calls


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("voxceleb_recipe")
    data = str(root / "VoxCeleb")
    recipe.write_synthetic_voxceleb(data, seed=3, **CLIPS)
    _two_lengths(data)
    train = _load_path("vox_train", SPEAKER_REC / "train_speaker_embeddings.py")
    jprep = _load_path("vox_prepare", REPO / "recipes/VoxCeleb/voxceleb_prepare.py")

    # ---- the port: recipes.voxceleb_speaker at toy widths
    parts = recipe.build(data, str(root / "port"), TOY, RUN_OPTS)
    pb = parts["brain"]
    for key in ("train_loader", "valid_loader"):
        parts[key].collate_fn = _port_collate

    # ---- JAX: the training script's __main__
    with open(SPEAKER_REC / "hparams" / "train_ecapa_tdnn.yaml") as f:
        hp = load_hyperpyyaml(f, YAML_OVERRIDES + ECAPA_YAML + CLASSIFIER_YAML
                              + f"data_folder: {data}\n"
                              f"output_folder: {root / 'jax'}\n")
    jprep.prepare_voxceleb(data_folder=data, save_folder=hp["save_folder"],
                           seed=hp["seed"],
                           verification_pairs_file=hp["verification_file"])
    manifests = {s: (json.load(open(hp[f"{s}_json"])),
                     json.load(open(parts["hparams"][f"{s}_json"])))
                 for s in ("train", "valid")}
    datasets, label_encoder = train.dataio_prep(hp)

    class JaxSpeaker(train.SpeakerBrain):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            from speechbrain_tpu.parallel.mesh import make_mesh
            self.mesh = make_mesh(jax.devices()[:1])
            self.augment_keys = []

        def fit_batch(self, batch):
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

    out = {name: {"losses": [], "lrs": [], "VALID": []}
           for name in ("jax", "port")}
    _record(jb, out["jax"])
    _record(pb, out["port"])
    jb.fit(hp["epoch_counter"], loader("train", True), loader("valid"))
    keys = list(jb.augment_keys)
    pb.augment = _JaxDraws(pb.augment, hp["augmentation"], keys)
    pb.fit(parts["epoch_counter"], parts["train_loader"],
           parts["valid_loader"])
    return dict(out, root=root, data=data, jb=jb, pb=pb, parts=parts,
                manifests=manifests, unused_keys=keys,
                labels=(label_encoder.lab2ind, parts["label_encoder"].lab2ind))


def test_recipe_manifests_and_labels_match_jax(fitted):
    """The same utterance ids, files, durations and speakers in the same
    splits (a tenth of each speaker's clips held out), and the same
    speaker indices."""
    for split, (j, p) in fitted["manifests"].items():
        assert j == p and len(p) == {"train": 40, "valid": 4}[split], split
        assert all(k.startswith(v["spk_id"] + "--" + v["spk_id"] + "--")
                   for k, v in p.items())
    j, p = fitted["labels"]
    assert j == p and len(p) == 4


def test_recipe_losses_and_lrs_match_jax(fitted):
    """The training losses within 5e-5 relative: the first, before any
    update, already differs by up to ~2e-5, from the training-mode
    BatchNorms' f32 batch statistics (E[x^2] - E[x]^2 summed in another
    order) behind the AAM's scale of 30 (the validation losses, in eval
    mode, agree within 1e-6); the rates exactly."""
    j, p = fitted["jax"], fitted["port"]
    assert len(p["losses"]) == len(j["losses"]) == 8  # 4 batches x 2 epochs
    for a, b in zip(p["losses"], j["losses"]):
        _rel_close(a, b, rtol=5e-5)
    assert p["lrs"] == j["lrs"]
    assert p["lrs"][0] == LR and min(p["lrs"][1:]) >= LR_FINAL
    assert len(set(p["lrs"])) >= 4  # the cycle turns within the run
    assert fitted["pb"].lr == fitted["jb"].lr
    assert fitted["unused_keys"] == []  # each step took JAX's draws


def test_recipe_validation_and_log_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["VALID"]) == len(j["VALID"]) == 2
    for a, b in zip(p["VALID"], j["VALID"]):
        _rel_close(a, b)
    pb = fitted["pb"]
    best = min(c.meta["loss"] for c in pb.checkpointer.list_checkpoints())
    assert best == min(p["VALID"])
    assert pb.checkpointer.recoverables["lr_annealing"] is pb.lr_annealing
    root = fitted["root"]

    def shape(path):
        import re
        return [re.sub(r"-?\d[\d.e+-]*", "#", line)
                for line in Path(path).read_text().splitlines()]

    got = shape(root / "port" / "train_log.txt")
    assert got == shape(root / "jax" / "train_log.txt") and len(got) == 2


def test_cosine_verification_matches_jax(fitted):
    """``verify_cosine`` with the port's best ECAPA (``save_for_pretrained``
    output) against ``speaker_verification_cosine.py``'s ``main`` with the
    same weights (msgpack through the bridge), on the same trials (the
    JAX script given ``wav/`` as its data folder, which it takes as the
    trial root): the same files in ``scores.txt``, the scores within 1e-5,
    EER and minDCF exactly, the same log line."""
    root, pb = fitted["root"], fitted["pb"]
    pb.checkpointer.recover_if_possible(min_key="loss")
    save_for_pretrained(pb, root / "port_pre",
                        module_names=["embedding_model", "classifier"])
    sd = torch.load(root / "port_pre" / "embedding_model.ckpt",
                    weights_only=True)
    (root / "jax_pre").mkdir()
    (root / "jax_pre" / "embedding_model.ckpt").write_bytes(
        serialization.to_bytes(bridge.to_jax_ecapa(sd)))
    got = recipe.verify_cosine(
        fitted["data"], str(root / "port_cos"),
        dict(_WIDTHS, pretrain_path=str(root / "port_pre")),
        {"device": "cpu"})
    calls = _run_jax_script(
        "speaker_verification_cosine", "verification_ecapa.yaml",
        ECAPA_YAML + "data_folder: VoxCeleb/wav\n"
        "verification_file: VoxCeleb/veri_test2.txt\n"
        f"output_folder: {root / 'jax_cos'}\n"
        f"pretrain_path: {root / 'jax_pre'}\n", root)
    jpos, jneg, jeer = calls["EER"]
    pos = [s for s, lab in zip(got["scores"], got["labels"]) if lab == 1]
    neg = [s for s, lab in zip(got["scores"], got["labels"]) if lab != 1]
    assert len(pos) == len(jpos) == 8 and len(neg) == len(jneg) == 8
    np.testing.assert_allclose(pos + neg, jpos + jneg, atol=1e-5)
    assert (got["eer"], got["min_dcf"]) == (jeer[0], calls["minDCF"][2][0])
    port_lines = (root / "port_cos" / "scores.txt").read_text().splitlines()
    jax_lines = (root / "jax_cos" / "scores.txt").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == 16
    for a, b in zip(port_lines, jax_lines):
        assert [str(Path(f).relative_to(root)) for f in a.split()[:2]] == (
            b.split()[:2])
    assert (root / "port_cos" / "train_log.txt").read_text() == (
        root / "jax_cos" / "train_log.txt").read_text()
    assert 0.0 <= got["eer"] <= 1.0 and 0.0 <= got["min_dcf"] <= 0.01


def test_plda_verification_matches_jax(fitted):
    """``verify_plda`` against ``speaker_verification_plda.py``'s ``main``
    with the same random x-vector (TDNN 8 x 5, lin 8), rank 4, the first
    18 training utterances: the trials' PLDA scores within 1e-4 relative
    (the embeddings differ by f32 rounding), EER and minDCF exactly, the
    same log line."""
    root = fitted["root"]
    hp = dict(recipe.HPARAMS_VERIFY_PLDA, **XVECTOR_WIDTHS)
    model = recipe.build_embedding_model(hp)
    _random_init(model, torch.Generator().manual_seed(5))
    save_for_pretrained(SimpleNamespace(modules=torch.nn.ModuleDict(
        {"embedding_model": model})), root / "port_xv")
    (root / "jax_xv").mkdir()
    (root / "jax_xv" / "embedding_model.ckpt").write_bytes(
        serialization.to_bytes(bridge.to_jax_xvector(model.state_dict())))
    got = recipe.verify_plda(
        fitted["data"], str(root / "port_plda"),
        dict(XVECTOR_WIDTHS, pretrain_path=str(root / "port_xv"), rank_f=4,
             plda_train_utts=18), {"device": "cpu"})
    calls = _run_jax_script(
        "speaker_verification_plda", "verification_plda_xvector.yaml",
        XVECTOR_YAML + "data_folder: VoxCeleb/wav\n"
        "verification_file: VoxCeleb/veri_test2.txt\n"
        f"output_folder: {root / 'jax_plda'}\n"
        f"pretrain_path: {root / 'jax_xv'}\n"
        "rank_f: 4\nplda_train_utts: 18\n", root)
    jpos, jneg, jeer = calls["EER"]
    pos = [s for s, lab in zip(got["scores"], got["labels"]) if lab == 1]
    neg = [s for s, lab in zip(got["scores"], got["labels"]) if lab != 1]
    want = np.array(jpos + jneg)
    np.testing.assert_allclose(pos + neg, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert (got["eer"], got["min_dcf"]) == (jeer[0], calls["minDCF"][2][0])
    assert (root / "port_plda" / "train_log.txt").read_text() == (
        root / "jax_plda" / "train_log.txt").read_text()
    assert tuple(got["plda"].F.shape) == (8, 4)


def test_recipe_resumed_epoch_equals_the_uninterrupted_one(tmp_path):
    """``run`` for 2 epochs (writing ``pretrained/`` from the checkpoint
    with the least validation loss), then a fresh Brain on a copy of its
    folder runs epoch 3 and ends where 3 uninterrupted epochs end, bit
    for bit: the modules, Adam's state, the cyclic schedule, the rate and
    the generator; with clips longer than 3 s (cropped, keyed by epoch)
    and the augmentation at the yaml's speeds 95/100/105."""
    data = str(tmp_path / "vox")
    recipe.write_synthetic_voxceleb(data, speakers=4, clips=6,
                                    seconds=(2.0, 4.0), seed=4)
    hp = dict(TOY, augmentation=recipe.HPARAMS_ECAPA["augmentation"])
    opts = dict(RUN_OPTS, loss_sync_interval=4)

    def fit(out, epochs):
        parts = recipe.build(data, out, dict(hp, number_of_epochs=epochs),
                             opts)
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    first = recipe.run(data, str(tmp_path / "first"),
                       dict(hp, number_of_epochs=2), opts)
    best = first.checkpointer.find_checkpoint(min_key="loss")
    saved = torch.load(tmp_path / "first/pretrained/embedding_model.ckpt",
                       weights_only=True)
    state = torch.load(best.path / "train_state.ckpt", weights_only=True)
    assert all(torch.equal(v, state["modules"][f"embedding_model.{k}"])
               for k, v in saved.items())
    shutil.copytree(tmp_path / "first", tmp_path / "resumed")
    resumed = fit(str(tmp_path / "resumed"), 3)
    whole = fit(str(tmp_path / "whole"), 3)
    a, b = resumed.modules.state_dict(), whole.modules.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = (resumed.optimizer.state_dict()["state"],
              whole.optimizer.state_dict()["state"])
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert resumed.lr == whole.lr
    assert (resumed.lr_annealing.clr_iterations
            == whole.lr_annealing.clr_iterations == 6)  # 3 x 2 batches
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert resumed.hparams.crop.epoch == 3



