"""The TIMIT CRDNN + CTC recipe (``BASELINE.json`` config 2) on the port,
against the JAX package: its new modules one by one, then the recipe
end to end.

Modules, on the same numpy inputs: ``Deltas`` and ``ContextWindow``
(3-d and 4-d), ``Fbank`` with deltas (and with a context window),
``InputNormalization`` at the recipe's 120 features over epochs, the
label encoders (the same indices from the same dataset; each package's
file loads in the other), ``NewBobScheduler`` (with patience, and its
checkpoint both ways), 3 Adadelta steps behind the clip against optax's
``adadelta`` behind ``clip_by_global_norm`` at NewBob's changing rates,
the shuffled ``SaveableDataLoader`` and ``prepare_timit``.

The recipe: the port's ``recipes/timit_ctc`` against the JAX recipe
(``recipes/TIMIT/ASR/CTC/train.py``, its ``CTCBrain`` and
``dataio_prep`` taken by path, hparams from ``hparams/train.yaml``
through JAX's ``load_hyperpyyaml``) on one synthetic TIMIT tree, at toy
widths (CNN 4/6 channels, a LiGRU of 1 x 8, DNN 2 x 8, dropout 0; 40
mels with deltas), f32.  Both read the port's manifests (folded by the
port's table: see ``test_fold39_gives_39_phones``), and both loaders
collate with one fixed-shape policy (the phones padded to one length,
so the JAX steps compile once).  Every utterance has the same number of
samples and every batch 4 of them: padded frames (and dummy rows, all
padding) give the CNN blocks' max pooling exact ties in the port and
near-ties in JAX, where the gradient goes to different bins, and
Adadelta at lr 1.0 (a step of ~4.5e-4 a parameter whatever the
gradient's size) carries that into the next losses at ~1e-4.  Ragged
lengths and dummy rows are held to JAX module by module (Fbank,
``InputNormalization``, the CRDNN, CTC).  The port's seeded initial
weights move to the JAX Brain through ``bridge.py``.  Both fit 2 epochs, then evaluate the test
set from the checkpoint with the lowest validation PER:

- the per-step losses agree within 1e-5 relative and the learning rates
  (NewBob on the PER) exactly;
- the validation losses within 1e-5 and PERs exactly;
- ``train_log.txt`` has the same lines up to the numbers;
- the test loss within 1e-5, and the greedy decode's phones per
  utterance (with their alignments) and the PER are equal;
- the port's label encoder has the JAX one's indices.

And the port alone: 2 epochs and a resumed third in a fresh Brain end
with the state of 3 uninterrupted epochs, bit for bit.
"""

import functools
import importlib.util
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

from speechbrain_tpu.core import Brain as JBrain
from speechbrain_tpu.core import _TrainStateRecoverable as JTrainStateRecoverable
from speechbrain_tpu.dataio.batch import BatchShapePolicy as JPolicy
from speechbrain_tpu.dataio.batch import PaddedBatch as JPaddedBatch
from speechbrain_tpu.dataio.dataloader import SaveableDataLoader as JLoader
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JDataset
from speechbrain_tpu.dataio.encoder import CategoricalEncoder as JCategorical
from speechbrain_tpu.dataio.encoder import CTCTextEncoder as JCTCEncoder
from speechbrain_tpu.dataio.encoder import TextEncoder as JTextEncoder
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.nnet.schedulers import NewBobScheduler as JNewBob
from speechbrain_tpu.parallel.mesh import make_mesh
from speechbrain_tpu.parallel.sharding import place_state as j_place_state
from speechbrain_tpu.processing.features import ContextWindow as JContext
from speechbrain_tpu.processing.features import Deltas as JDeltas
from speechbrain_tpu.processing.features import GlobalNormState as JNormState
from speechbrain_tpu.processing.features import InputNormalization as JNorm
from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Brain
from speechbrain_tpu_torch.dataio.batch import BatchShapePolicy, PaddedBatch
from speechbrain_tpu_torch.dataio.dataloader import SaveableDataLoader
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.dataio.encoder import (
    CategoricalEncoder,
    CTCTextEncoder,
    TextEncoder,
)
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.schedulers import NewBobScheduler
from speechbrain_tpu_torch.processing.features import (
    ContextWindow,
    Deltas,
    InputNormalization,
)
from speechbrain_tpu_torch.recipes import timit_ctc as recipe

from .test_torch_kernels import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "recipes/TIMIT/ASR/CTC"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _load_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ features


@pytest.mark.parametrize("shape", [(2, 13, 5), (2, 9, 4, 3), (1, 1, 3)])
@pytest.mark.parametrize("window", [5, 3, 9])
def test_deltas_match_jax(shape, window):
    """Edge-padded time, taps j / denom, no flip; 4-d channel by channel."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = _np(JDeltas(window_length=window)(jnp.asarray(x)))
    got = Deltas(window_length=window)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 7, 3), (2, 6, 4, 2)])
@pytest.mark.parametrize("left,right", [(0, 0), (2, 1), (5, 5), (0, 3)])
def test_context_window_matches_jax(shape, left, right):
    """Zero padding and the feature-major interleave, bit for bit."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = _np(JContext(left, right)(jnp.asarray(x)))
    got = ContextWindow(left, right)(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("context", [False, True])
def test_fbank_with_deltas_matches_jax(context):
    """40 mels with deltas: the recipe's 120 features (with a 2 + 1
    context window: 480); the dB of f32 power spectra summed in another
    order differ by ~1e-5 dB, and the deltas of the deltas by a little
    more."""
    wav = (0.1 * np.random.default_rng(2).standard_normal((2, 9000))
           ).astype(np.float32)
    kw = dict(n_mels=40, deltas=True, context=context, left_frames=2,
              right_frames=1)
    want = _np(JFbank(**kw)(jnp.asarray(wav)))
    got = Fbank(**kw)(_t(wav)).numpy()
    assert got.shape == want.shape == (2, 57, 480 if context else 120)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_input_normalization_at_120_features_matches_jax():
    """The recipe's global normalization at 120 features over epochs 1-4
    (``update_until_epoch`` 3: the fourth batch only counts), ragged
    lengths, then eval."""
    F_ = 120
    rng = np.random.default_rng(3)
    jnorm = JNorm(norm_type="global")
    state = JNormState.init(F_)
    norm = InputNormalization(F_).train()
    for epoch in (1, 2, 3, 4):
        x = (3.0 * rng.standard_normal((4, 23, F_)) + epoch).astype(np.float32)
        lens = rng.uniform(0.3, 1.0, 4).astype(np.float32)
        lens[0] = 1.0
        jy, state = jnorm(jnp.asarray(x), lens, state=state, epoch=epoch,
                          training=True)
        y = norm(_t(x), _t(lens), epoch=epoch)
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=2e-5, rtol=2e-5)
        for k, v in norm.state().items():
            np.testing.assert_allclose(v.numpy(), _np(state[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    x = rng.standard_normal((2, 5, F_)).astype(np.float32)
    jy, _ = jnorm(jnp.asarray(x), np.ones(2, np.float32), state=state,
                  training=False)
    y = norm.eval()(_t(x), torch.ones(2))
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ encoders


def _phone_sets(n=12, seed=4):
    rng = np.random.default_rng(seed)
    return {f"u{i}": {"phn": " ".join(rng.choice(
        recipe.TIMIT_PHONES, rng.integers(1, 8)))} for i in range(n)}


def _datasets(data):
    out = []
    for cls in (DynamicItemDataset, JDataset):
        ds = cls(data)
        ds.add_dynamic_item(lambda p: p.split(), takes="phn",
                            provides="phn_list")
        ds.set_output_keys(["id", "phn_list"])
        out.append(ds)
    return out


@pytest.mark.parametrize("which", ["categorical", "text", "ctc"])
def test_encoders_match_jax_both_ways(which, tmp_path):
    """From the same dataset, the same label for every index (the CTC
    blank inserted at 0, moving the first label to the end; BOS and EOS
    appended; an unk label); the same encodings, decodings and
    collapses; and each package's file loads in the other."""
    port_cls, jax_cls, special = {
        "categorical": (CategoricalEncoder, JCategorical,
                        {"unk_label": "<unk>"}),
        "text": (TextEncoder, JTextEncoder,
                 {"bos_label": "<bos>", "eos_label": "<eos>"}),
        "ctc": (CTCTextEncoder, JCTCEncoder, {"blank_label": "<blank>"}),
    }[which]
    data = _phone_sets()
    pds, jds = _datasets(data)
    port, ref = port_cls(), jax_cls()
    port.load_or_create(str(tmp_path / "port.txt"), from_didatasets=[pds],
                        output_key="phn_list", sequence_input=True,
                        special_labels=special)
    ref.load_or_create(str(tmp_path / "jax.txt"), from_didatasets=[jds],
                       output_key="phn_list", sequence_input=True,
                       special_labels=special)
    assert port.lab2ind == ref.lab2ind and port.ind2lab == ref.ind2lab
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    seq = data["u3"]["phn"].split()
    ids = port.encode_sequence(seq)
    assert ids == ref.encode_sequence(seq)
    assert port.decode_ndim([ids, [len(port) + 5]]) == ref.decode_ndim(
        [ids, [len(ref) + 5]])
    if which == "ctc":
        assert port.get_blank_index() == 0 == ref.get_blank_index()
        noisy = [0, ids[0], ids[0], 0, ids[-1]]
        assert port.collapse_indices_ndim([noisy]) == ref.collapse_indices_ndim([noisy])
        assert port.collapse_labels(["<blank>", "a", "a", "b"]) == ["a", "b"]
    if which == "text":
        # distinct labels: appended after the phones, as in JAX
        assert port.get_bos_index() == ref.get_bos_index() == len(port) - 2
        assert port.get_eos_index() == ref.get_eos_index() == len(port) - 1
        assert port.prepend_bos_index(ids) == ref.prepend_bos_index(ids)
    if which == "categorical":
        assert port.encode_label("not a phone") == ref.encode_label("not a phone")
    # each package's file, loaded by the other
    crossed_port, crossed_jax = port_cls(), jax_cls()
    crossed_port.load(str(tmp_path / "jax.txt"))
    crossed_jax.load(str(tmp_path / "port.txt"))
    for enc in (crossed_port, crossed_jax):
        assert enc.lab2ind == ref.lab2ind
        assert enc._get_extras() == ref._get_extras()


# ------------------------------------------------------------ NewBob


@pytest.mark.parametrize("patient", [0, 2])
def test_newbob_matches_jax_and_checkpoints_both_ways(patient, tmp_path):
    """The recipe's settings (factor 0.8, threshold 0.0025) over a PER
    curve that improves, stalls, worsens and hits 0; each half-way state
    saved by one package and loaded by the other goes on the same."""
    curve = [80.0, 60.0, 59.99, 59.0, 61.0, 50.0, 49.9, 0.0, 0.0, 10.0]
    ours = NewBobScheduler(1.0, annealing_factor=0.8,
                           improvement_threshold=0.0025, patient=patient)
    ref = JNewBob(1.0, annealing_factor=0.8, improvement_threshold=0.0025,
                  patient=patient)
    for m in curve[:5]:
        assert ours(m) == ref(m)
    ours._save(tmp_path / "port.ckpt")
    ref._save(tmp_path / "jax.ckpt")
    assert (json.loads((tmp_path / "port.ckpt").read_text())
            == json.loads((tmp_path / "jax.ckpt").read_text()))
    a = NewBobScheduler(1.0, 0.8, 0.0025, patient)
    b = JNewBob(1.0, 0.8, 0.0025, patient)
    a._load(tmp_path / "jax.ckpt")
    b._load(tmp_path / "port.ckpt")
    for m in curve[5:]:
        want = ref(m)
        assert ours(m) == want == a(m) == b(m)
    assert ours.hyperparam_value < 1.0


# ------------------------------------------------------------ optimizer


def _adadelta_factory():
    """The recipe's optimizer factory, from a toy ``CTCBrain``."""
    brain = recipe.CTCBrain(
        {"cnn_channels": (2, 2), "rnn_layers": 1, "rnn_neurons": 4,
         "dnn_neurons": 4}, run_opts={"device": "cpu"})
    return brain.opt_class


def _optimizer_parity(opt_class, optax_opt, lrs, grad_scale):
    """``len(lrs)`` steps of the port's ``Brain`` (clip to 5, then the
    optimizer at ``self.lr``) against the JAX ``Brain``'s chain
    (``clip_by_global_norm(5)`` + ``optax_opt`` with the injected rate),
    on the same parameters and gradients."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    lin = Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(_t(w0))
        lin.bias.copy_(_t(b0))
    brain = Brain({"lin": lin}, opt_class, {"lr": lrs[0]}, {"device": "cpu"})
    jb = JBrain(opt_class=optax_opt, run_opts={"max_grad_norm": 5.0})
    jb.init_optimizers()
    params = {"w": jnp.asarray(w0.T), "b": jnp.asarray(b0)}
    opt_state = jb.optimizer.init(params)
    norms = []
    for lr in lrs:
        gw = (grad_scale * rng.standard_normal((3, 4))).astype(np.float32)
        gb = (grad_scale * rng.standard_normal(3)).astype(np.float32)
        norms.append(float(np.sqrt((gw ** 2).sum() + (gb ** 2).sum())))
        lin.weight.grad, lin.bias.grad = _t(gw).clone(), _t(gb).clone()
        brain.lr = lr
        brain._apply(torch.tensor(True))
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, opt_state = jb.optimizer.update(
            {"w": jnp.asarray(gw.T), "b": jnp.asarray(gb)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   _np(params["w"]).T, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   _np(params["b"]), rtol=1e-5, atol=1e-6)
    return norms


def test_adadelta_behind_the_clip_matches_optax():
    """3 steps of the recipe's ``torch.optim.Adadelta(rho 0.95, eps 1e-8)``
    against ``optax.adadelta`` at NewBob's rates 1.0, 0.8, 0.64, the
    gradients large enough that the clip to 5 acts on each."""
    norms = _optimizer_parity(
        _adadelta_factory(),
        lambda lr: optax.adadelta(learning_rate=lr, rho=0.95, eps=1e-8),
        [1.0, 0.8, 0.64], grad_scale=4.0)
    assert min(norms) > 5.0


# ------------------------------------------------------------ data


def test_shuffled_loader_batches_match_jax():
    """``SaveableDataLoader(shuffle=True)``: the same ids in the same
    batches as JAX's, epoch after epoch (``set_epoch``)."""
    data = _phone_sets(n=11)
    pds, jds = _datasets(data)
    port, ref = (SaveableDataLoader(pds, batch_size=4, shuffle=True),
                 JLoader(jds, batch_size=4, shuffle=True))
    for epoch in (1, 2, 3):
        port.sampler.set_epoch(epoch)
        ref.sampler.set_epoch(epoch)
        got = [list(b.id) for b in port]
        assert got == [list(b.id) for b in ref]
        assert sorted(sum(got, [])) == sorted(data)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic TIMIT tree with every one of the 61 phones in train."""
    root = tmp_path_factory.mktemp("timit_tree")
    recipe.write_synthetic_timit(str(root), {"train": 12, "dev": 4, "test": 4},
                                 seconds=(1.5, 3.0), seed=1)
    return root


def test_fold39_gives_39_phones(tree, tmp_path):
    """The repaired 39-phone folding: 39 labels over the 61 phones
    (``ax-h`` -> ``ah``; the closures, ``epi``, ``pau`` and ``h#`` ->
    ``sil``; ``q`` dropped), so the synthetic tree's label encoder has 40
    labels with the blank, the yaml's ``output_neurons``.  The JAX table
    gives 40 phones (``ax-h`` -> ``ax``, which stays): this test fails if
    the port copies it (41 labels with the blank)."""
    folded = {recipe.FOLD39.get(p, p) for p in recipe.TIMIT_PHONES} - {""}
    assert len(folded) == 39
    assert recipe.FOLD39["ax-h"] == recipe.FOLD39["ax"] == "ah"
    assert recipe.FOLD39["q"] == ""
    assert {recipe.FOLD39[p] for p in ("qcl", "cl", "vcl", "epi")} == {"sil"}
    jprep = _load_path("timit_prepare_jax", REPO / "recipes/TIMIT/timit_prepare.py")
    jfold = jprep._folding_map(39)
    assert len({jfold.get(p, p) for p in recipe.TIMIT_PHONES} - {""}) == 40
    parts = recipe.build(str(tree), str(tmp_path / "out"),
                         {"cnn_channels": (2, 2), "rnn_layers": 1,
                          "rnn_neurons": 4, "dnn_neurons": 4},
                         {"device": "cpu"})
    train = json.load(open(parts["hparams"]["train_json"]))
    raw = set()
    for utt in train:
        spk, stem = utt.split("_")
        raw |= set(recipe._read_phn(
            str(tree / "TRAIN" / "DR1" / spk.upper() / f"{stem.upper()}.PHN"))[0])
    assert raw == set(recipe.TIMIT_PHONES)  # ax-h and q included
    assert len(parts["label_encoder"]) == 40 == recipe.HPARAMS["output_neurons"]


@pytest.mark.parametrize("phn_set", [60, 48, 39])
def test_prepare_timit_matches_jax(tree, tmp_path, phn_set):
    """The same utterances (the SA sentences skipped, the dev and core
    test speakers), durations, phone ends and phones as the JAX
    preparation, but for the 39-set's repair: where JAX folds ``ax-h`` to
    ``ax``, the port gives ``ah``."""
    jprep = _load_path("timit_prepare_jax", REPO / "recipes/TIMIT/timit_prepare.py")
    out = {}
    for name, fn in (("port", recipe.prepare_timit),
                     ("jax", jprep.prepare_timit)):
        paths = [str(tmp_path / f"{name}_{s}.json") for s in ("tr", "dev", "te")]
        fn(str(tree), *paths, phn_set=phn_set)
        out[name] = [json.load(open(p)) for p in paths]
    assert [len(m) for m in out["port"]] == [12, 4, 4]
    for port, ref in zip(out["port"], out["jax"]):
        assert port.keys() == ref.keys()
        assert not any(k.endswith("_sa1") for k in port)
        for k, entry in port.items():
            want = dict(ref[k])
            if phn_set == 39:
                want["phn"] = " ".join("ah" if p == "ax" else p
                                       for p in want["phn"].split())
            assert entry == want, k


# ------------------------------------------------------------ the recipe

# The recipe's Adadelta from zero accumulators steps each parameter by
# ~lr x 4.5e-4 x sign(gradient) (sqrt(eps) / sqrt(0.05 g^2)), so at the
# yaml's lr 1.0 a gradient near zero whose sign the two frameworks'
# rounding decides moves its parameter by +-4.5e-4, and the losses drift
# apart by 1e-4 within 5 steps.  At 1e-3 such a parameter moves 4.5e-7.
# The update itself is held to optax at lr 1.0 in
# test_adadelta_behind_the_clip_matches_optax.
LR = 1e-3

TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8, dnn_neurons=8,
           dropout=0.0, batch_size=4, number_of_epochs=2, lr=LR)
YAML_OVERRIDES = f"""
lr: {LR}
batch_size: 4
number_of_epochs: 2
model: !new:speechbrain_tpu.lobes.models.CRDNN.CRDNN
    cnn_blocks: 2
    cnn_channels: !tuple [4, 6]
    inter_layer_pooling_size: !tuple [2, 2]
    rnn_class: ligru
    rnn_layers: 1
    rnn_neurons: 8
    rnn_bidirectional: True
    dnn_blocks: 2
    dnn_neurons: 8
    dropout: 0.0
"""
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
# every batch of one shape: 1.3 s, 16 phones, 4 rows
SAMPLES, PHONES, ROWS = 20800, 16, 4


def _policy(cls):
    return cls(time_buckets=[SAMPLES], time_keys=("sig",),
               key_buckets={"phn_encoded": [PHONES]}, batch_buckets=[ROWS])


def _port_collate(examples):
    return PaddedBatch(examples, shape_policy=_policy(BatchShapePolicy))


def _record(brain, out):
    """Wrap the hooks: per-step losses and rates, each validation's loss
    and PER, the test stage's loss, PER and per-utterance details."""
    fit_end, stage_end = brain.on_fit_batch_end, brain.on_stage_end

    def on_fit_batch_end(batch, outputs, loss, should_step):
        out["losses"].append(float(loss))
        out["lrs"].append(brain.lr)
        fit_end(batch, outputs, loss, should_step)

    def on_stage_end(stage, stage_loss, epoch=None):
        if stage.name != "TRAIN":
            out[stage.name].append(
                (float(stage_loss),
                 brain.per_metrics.summarize("error_rate"),
                 [dict(s) for s in brain.per_metrics.scores]))
        stage_end(stage, stage_loss, epoch)
        if stage.name == "VALID":
            out["valid_lrs"].append(brain.lr)  # NewBob's, for the next epoch

    brain.on_fit_batch_end = on_fit_batch_end
    brain.on_stage_end = on_stage_end


def _to_jax(pb):
    sd = pb.modules.state_dict()
    enc = bridge.to_jax_crdnn(sd, "model.")
    state = {"params": {"model": enc["params"],
                        "output_lin": {"Dense_0": bridge._dense_to_jax(
                            bridge._Sub(sd, "output_lin."))}},
             "model_state": {"model": {"batch_stats": enc["batch_stats"]}},
             "extra": {"norm": {k: bridge._a(sd[f"normalize.{k}"])
                                for k in ("count", "mean", "std")}}}
    return jax.tree_util.tree_map(jnp.asarray, state)


def _jax_initialize(brain, state):
    """What the JAX Brain's lazy init does after applying every module
    (eagerly: ~20 s a model on the CPU), from given ``params``,
    ``model_state`` and ``extra``."""
    if brain.optimizer is None:
        brain.init_optimizers()
    state = dict(state, opt_state=brain.optimizer.init(state["params"]))
    brain.train_state = j_place_state(brain.mesh, state)
    brain._state_recoverable = JTrainStateRecoverable(brain)
    brain.checkpointer.add_recoverable("train_state", brain._state_recoverable)


def _jax_brain_class(train):
    class JaxCTC(train.CTCBrain):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            # one device, as the port trains (the suite's virtual CPU
            # devices would pad every batch with replica rows)
            self.mesh = make_mesh(jax.devices()[:1])

        @functools.cached_property
        def _forward(self):
            def forward(state, rngs, batch, stage):
                self._bind(state["params"], state["model_state"],
                           state["extra"], rngs, train=False)
                return self.compute_forward(batch, stage)
            return jax.jit(forward, static_argnums=3)

        def evaluate_batch_full(self, batch, stage):
            """The Brain's eager evaluation with the forward jitted (the
            parameters passed as arguments); the objectives (the loss and
            the host's greedy decode and PER) outside jit, as there."""
            device_batch = self.prepare_batch(batch)
            predictions = self._forward(
                self.train_state, self._make_step_rngs(self._next_rng()),
                device_batch, stage)
            return float(self.compute_objectives(predictions, device_batch,
                                                 stage))
    return JaxCTC


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("timit_recipe")
    data = str(root / "TIMIT")
    recipe.write_synthetic_timit(data, {"train": 12, "dev": 4, "test": 4},
                                 seconds=(1.3, 1.3), seed=2)
    train = _load_path("timit_ctc_train", RECIPE / "train.py")

    # ---- the port: recipes.timit_ctc at toy widths
    parts = recipe.build(data, str(root / "port"), TOY, RUN_OPTS)
    pb = parts["brain"]
    for key in ("train_loader", "valid_loader", "test_loader"):
        parts[key].collate_fn = _port_collate

    # ---- JAX: the recipe's __main__ on the port's manifests
    with open(RECIPE / "hparams" / "train.yaml") as f:
        hp = load_hyperpyyaml(f, YAML_OVERRIDES + f"data_folder: {data}\n"
                              f"output_folder: {root / 'jax'}\n")
    for key in ("train_json", "valid_json", "test_json"):
        hp[key] = parts["hparams"][key]
    Path(hp["save_folder"]).mkdir(parents=True)  # the experiment directory
    datasets, label_encoder = train.dataio_prep(hp)
    jb = _jax_brain_class(train)(
        modules=hp["modules"],
        opt_class=lambda lr: hp["opt_class"](learning_rate=lr), hparams=hp,
        run_opts={"loss_sync_interval": 1, "noprogressbar": True},
        checkpointer=JCheckpointer(hp["save_folder"]))
    jb.label_encoder = label_encoder
    _jax_initialize(jb, _to_jax(pb))

    def loader(split, shuffle=False):
        return JLoader(datasets[split], batch_size=4, shuffle=shuffle,
                       collate_fn=lambda ex: JPaddedBatch(
                           ex, shape_policy=_policy(JPolicy)))

    out = {name: {"losses": [], "lrs": [], "valid_lrs": [], "VALID": [],
                  "TEST": []}
           for name in ("jax", "port")}
    _record(jb, out["jax"])
    _record(pb, out["port"])
    def copy(params):
        return jax.tree_util.tree_map(lambda a: np.array(a, np.float64),
                                      params)

    initial = copy(_to_jax(pb)["params"])
    jb.fit(hp["epoch_counter"], loader("train", True), loader("valid"))
    fitted_params = {"jax": copy(jb.train_state["params"])}
    jb.evaluate(loader("test"), min_key="PER")
    pb.fit(parts["epoch_counter"], parts["train_loader"],
           parts["valid_loader"])
    fitted_params["port"] = copy(_to_jax(pb)["params"])
    pb.evaluate(parts["test_loader"], min_key="PER")
    return dict(out, root=root, data=data, jb=jb, pb=pb, parts=parts,
                jax_encoder=label_encoder, initial=initial,
                fitted_params=fitted_params)


def _rel_close(a, b, rtol=1e-5):
    assert abs(a - b) <= rtol * max(1.0, abs(b)), (a, b)


def test_recipe_losses_and_lrs_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["losses"]) == len(j["losses"]) == 6  # 3 batches x 2 epochs
    for a, b in zip(p["losses"], j["losses"]):
        _rel_close(a, b)
    assert p["lrs"] == j["lrs"]
    # the second validation's PER is worse than the first's: NewBob anneals
    assert p["valid_lrs"] == j["valid_lrs"] == [LR, 0.8 * LR]
    assert fitted["pb"].lr == fitted["jb"].lr  # both from the best checkpoint


def test_recipe_parameter_change_matches_jax(fitted):
    """What the 6 Adadelta steps of the fit moved, final minus initial
    parameters in JAX's layout, against the JAX recipe's change: within
    1e-2 of its norm over all leaves, and each leaf within 2e-2 of its
    own norm plus 1e-3 of the root mean square of the leaves' norms (the
    Dense biases before a BatchNorm have no gradient but roundoff, and
    move ~1e-10).  At lr 1e-3 a step moves a parameter by ~4.5e-7, too
    little to show in the losses; the float32 sums of two such updates
    differ in the last bit now and then (measured: 2.3e-3 over all
    leaves).  An update that is missing or not optax's (another rho or
    eps, the rate left out, a leaf outside the optimizer) moves the
    change by 30 % or more."""
    def delta(params):
        return jax.tree_util.tree_map(np.subtract, params, fitted["initial"])

    port, ref = (jax.tree_util.tree_leaves_with_path(
        delta(fitted["fitted_params"][k])) for k in ("port", "jax"))
    assert [k for k, _ in port] == [k for k, _ in ref] and len(ref) > 10
    norms = [float(np.linalg.norm(r)) for _, r in ref]
    errs = [float(np.linalg.norm(p - r)) for (_, p), (_, r) in zip(port, ref)]
    total = float(np.linalg.norm(norms))
    assert float(np.linalg.norm(errs)) <= 1e-2 * total, (errs, norms)
    floor = 1e-3 * total / len(norms) ** 0.5
    for (path, _), err, norm in zip(ref, errs, norms):
        assert err <= 2e-2 * norm + floor, (jax.tree_util.keystr(path), err,
                                            norm)


def test_recipe_validation_matches_jax(fitted):
    """The validation losses within 1e-5 and the PERs, with each
    utterance's phones and alignment, equal."""
    j, p = fitted["jax"]["VALID"], fitted["port"]["VALID"]
    assert len(p) == len(j) == 2
    for (pl, pper, ps), (jl, jper, js) in zip(p, j):
        _rel_close(pl, jl)
        assert pper == jper and ps == js


def test_recipe_test_stage_matches_jax(fitted):
    """The test loss and the greedy decode's phones and PER, from the
    checkpoint with the lowest validation PER in both."""
    (pl, pper, ps), = fitted["port"]["TEST"]
    (jl, jper, js), = fitted["jax"]["TEST"]
    _rel_close(pl, jl)
    assert ps == js and pper == jper
    assert len(ps) == 4 and all(s["num_ref_tokens"] > 0 for s in ps)
    assert fitted["pb"].stage_stats["TEST"]["PER"] == pper
    pb = fitted["pb"]
    best = min(c.meta["PER"] for c in pb.checkpointer.list_checkpoints())
    assert pb._recovered_ckpt.meta["PER"] == best
    assert {"brain.ckpt", "train_state.ckpt", "lr_annealing.ckpt",
            "train_loader.ckpt", "epoch_counter.ckpt"} <= {
        f.name for f in pb._recovered_ckpt.path.iterdir()}


def test_recipe_label_encoder_and_log_match_jax(fitted):
    def shape(path):
        return [re.sub(r"-?\d[\d.e+-]*", "#", line)
                for line in Path(path).read_text().splitlines()]

    root = fitted["root"]
    assert fitted["parts"]["label_encoder"].lab2ind == fitted["jax_encoder"].lab2ind
    got = shape(root / "port" / "train_log.txt")
    assert got == shape(root / "jax" / "train_log.txt")
    assert len(got) == 2 and got[0].startswith("epoch: #, lr: #")


def _final_state(brain):
    return ({k: v.clone() for k, v in brain.modules.state_dict().items()},
            brain.optimizer.state_dict()["state"], brain.lr,
            brain.lr_annealing.metric_values)


def test_recipe_resumed_epoch_equals_the_uninterrupted_one(fitted, tmp_path):
    """A fresh Brain on a copy of the fitted folder runs epoch 3 from the
    latest checkpoint (modules, Adadelta's accumulators, NewBob, lr,
    epoch, loader, generator) and ends where 3 uninterrupted epochs end,
    bit for bit."""
    def build(out, epochs):
        parts = recipe.build(fitted["data"], out,
                             dict(TOY, number_of_epochs=epochs), RUN_OPTS)
        for key in ("train_loader", "valid_loader"):
            parts[key].collate_fn = _port_collate
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    shutil.copytree(fitted["root"] / "port", tmp_path / "resumed")
    resumed = build(str(tmp_path / "resumed"), 3)
    whole = build(str(tmp_path / "whole"), 3)
    (ma, oa, lra, nba), (mb, ob, lrb, nbb) = (_final_state(resumed),
                                             _final_state(whole))
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert lra == lrb and nba == nbb and len(nba) == 3
