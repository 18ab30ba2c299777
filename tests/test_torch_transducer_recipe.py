"""The LibriSpeech transducer recipe end to end with both of its hparams
files: the port's ``recipes/librispeech_transducer`` against the JAX
recipe (``recipes/LibriSpeech/ASR/transducer/train.py``, its
``Transducer`` Brain and ``dataio_prepare`` taken by path, with hparams
from ``hparams/conformer_transducer.yaml`` or ``hparams/train.yaml``
through JAX's ``load_hyperpyyaml``).

A tiny synthetic LibriSpeech tree (11 train, 3 dev and 2 test WAVs)
goes through both with the same overrides to toy dims (vocab 40, 40
mels, f32; the conformer at d_model 32 with 1 layer, the CRDNN at 4 and
6 channels with a 2-layer LiGRU of 8), dropout 0 and no SpecAugment; the
yamls' BPE tokenizer, ``tokens_blank``, token buckets and dynamic
batching stay.  The port Brain's seeded initial weights (the blank
logit's bias +4, so that the toy model's searches end) move to the JAX
Brain through ``bridge.py``.  Both fit 2 epochs on the same batches, then evaluate
the test set from the checkpoint with the lowest validation loss:

- the per-step losses agree within 1e-5 relative and the learning
  rates exactly;
- the validation losses agree within 1e-5 relative (no search runs in
  validation);
- ``train_log.txt`` has the same lines up to the numbers;
- the port keeps the best checkpoint by loss and
  ``evaluate(min_key="loss")`` recovers it;
- the test loss agrees within 1e-5 relative, and the beam-4 search's
  hypotheses (words, per utterance) and the WER are equal.

Also, without JAX: the transducer Brains' input normalization sees the
epoch counter's epoch (frozen from ``update_until_epoch`` on, as the
recipe passes ``epoch_counter.current``).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

import speechbrain_tpu.ops.pallas.transducer as jpt
import torch

from recipes.LibriSpeech.librispeech_prepare import (
    prepare_librispeech as j_prepare,
)
from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.core import _TrainStateRecoverable as JTrainStateRecoverable
from speechbrain_tpu.parallel.mesh import make_mesh
from speechbrain_tpu.parallel.sharding import place_state as j_place_state
from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JSentencePiece,
)
from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import (
    CONFORMER_TRANSDUCER,
    CRDNN_TRANSDUCER,
    ConformerTransducerBrain,
    CRDNNTransducerBrain,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes import librispeech_transducer as recipe

from .test_torch_kernels import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "recipes/LibriSpeech/ASR/transducer"

COMMON = """
lr: 3.2e-8
vocab_size: 48
n_mels: 40
number_of_epochs: 2
max_batch_length: 4.8
num_buckets: 2
num_workers: 0
precision: fp32
dec_emb_dim: 8
dec_neurons: 12
joint_dim: 10
"""
# conformer_transducer.yaml fixes the front end's channels and the
# encoder's input size, so both are restated
YAML_OVERRIDES = {
    "conformer": COMMON + """
d_model: 32
nhead: 2
num_encoder_layers: 1
d_ffn: 64
kernel_size: 7
transformer_dropout: 0.0
frontend: !new:speechbrain_tpu.lobes.models.convolution.ConvolutionFrontEnd
    num_blocks: 2
    num_layers_per_block: 1
    out_channels: !tuple [8, 8]
    kernel_sizes: !tuple [[3, 3], [3, 3]]
    strides: !tuple [2, 2]
transformer: !new:speechbrain_tpu.lobes.models.transformer.TransformerASR.TransformerASR
    input_size: 80
    tgt_vocab: !ref <output_neurons>
    d_model: !ref <d_model>
    nhead: !ref <nhead>
    num_encoder_layers: !ref <num_encoder_layers>
    num_decoder_layers: 0
    d_ffn: !ref <d_ffn>
    dropout: !ref <transformer_dropout>
    encoder_module: conformer
    attention_type: RelPosMHAXL
    kernel_size: !ref <kernel_size>
""",
    "crdnn": COMMON + """
cnn_channels: [4, 6]
rnn_layers: 2
rnn_neurons: 8
dnn_neurons: 8
dropout: 0.0
""",
}
_PORT_COMMON = dict(
    lr=3.2e-8, vocab_size=48, n_mels=40, number_of_epochs=2,
    max_batch_length=4.8, num_buckets=2, num_workers=0, precision="fp32",
    dec_emb_dim=8, dec_neurons=12, joint_dim=10, augmentation=None)
PORT = {
    "conformer": (recipe.HPARAMS, dict(
        _PORT_COMMON, frontend_channels=(8, 8), input_size=80, d_model=32,
        nhead=2, num_encoder_layers=1, d_ffn=64, kernel_size=7,
        transformer_dropout=0.0)),
    "crdnn": (recipe.HPARAMS_CRDNN, dict(
        _PORT_COMMON, cnn_channels=(4, 6), rnn_layers=2, rnn_neurons=8,
        dnn_neurons=8, dropout=0.0)),
}
YAML = {"conformer": "conformer_transducer.yaml", "crdnn": "train.yaml"}
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
_HEADS = ("enc_lin", "emb", "dec", "dec_lin", "out_lin")
# added to the blank logit's bias of the initial weights, so that the
# untrained toy model emits blanks and the test searches end in a few
# rounds a frame (bench.py and chip_smoke.py bias it the same way)
BLANK_BIAS = 4.0


def _jax_recipe_module():
    spec = importlib.util.spec_from_file_location(
        "librispeech_transducer_train", RECIPE / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.partial(jax.jit,
                   static_argnames=("blank_index", "reduction", "use_pallas"))
def _tpu_transducer_loss(logits, targets, input_lens, target_lens,
                         blank_index, reduction="mean", use_pallas=True):
    """``speechbrain_tpu.nnet.losses.transducer_loss`` as the recipe runs
    it on a TPU: its ``TransducerLoss`` takes the Pallas logits entry
    there (off the TPU it takes the scan, whose row with no frame, a
    dummy row of a padded batch, costs -log blank(frame 0) instead of
    the kernels' 0, which the port follows)."""
    assert use_pallas and reduction == "mean"
    T, U = logits.shape[1], targets.shape[1]
    abs_t = jnp.round(jnp.asarray(input_lens) * T).astype(jnp.int32)
    abs_u = jnp.round(jnp.asarray(target_lens) * U).astype(jnp.int32)
    return jpt.transducer_loss_pallas_logits(
        jnp.asarray(logits, jnp.float32), targets, abs_t, abs_u,
        blank_index).mean()


def _record(brain, out):
    """Wrap the hooks: per-step losses and learning rates, each
    validation's loss, and the test stage's per-utterance WER details."""
    fit_end, stage_end = brain.on_fit_batch_end, brain.on_stage_end

    def on_fit_batch_end(batch, outputs, loss, should_step):
        out["losses"].append(float(loss))
        fit_end(batch, outputs, loss, should_step)
        out["lrs"].append(brain.lr)

    def on_stage_end(stage, stage_loss, epoch=None):
        if stage.name == "VALID":
            out["valid"].append(float(stage_loss))
        if stage.name == "TEST":
            out["test"] = float(stage_loss)
            out["scores"] = [dict(s) for s in brain.wer_metric.scores]
            out["wer"] = brain.wer_metric.summarize("error_rate")
        stage_end(stage, stage_loss, epoch)

    brain.on_fit_batch_end = on_fit_batch_end
    brain.on_stage_end = on_stage_end


def _to_port(which, brain):
    """The port's state_dict from the JAX Brain's train state."""
    state = jax.device_get(brain.train_state)
    p, ms = state["params"], state["model_state"]
    heads = [p[n] for n in _HEADS]
    norm = state["extra"]["norm"]
    if which == "conformer":
        frontend = {"params": p["frontend"],
                    "batch_stats": ms["frontend"]["batch_stats"]}
        return bridge.conformer_transducer_state_dict(
            frontend, p["transformer"], *heads, norm)
    enc = {"params": p["enc"], "batch_stats": ms["enc"]["batch_stats"]}
    return bridge.crdnn_transducer_state_dict(enc, *heads, norm)


def _to_jax(which, brain, like=None):
    """The port Brain's state as the JAX Brain's ``params``,
    ``model_state`` and ``extra`` (``bridge.to_jax_*``), with the tree
    structures of ``like``'s when given."""
    sd = brain.modules.state_dict()
    if which == "conformer":
        pieces = bridge.to_jax_conformer_transducer(sd)
        enc_name, enc = "frontend", pieces["frontend"]
        params = {"transformer": pieces["transformer"]}
    else:
        pieces = bridge.to_jax_crdnn_transducer(sd)
        enc_name, enc = "enc", pieces["enc"]
        params = {}
    params.update({enc_name: enc["params"],
                   **{n: pieces[n] for n in _HEADS}})
    state = {"params": params,
             "model_state": {enc_name: {"batch_stats": enc["batch_stats"]}},
             "extra": {"norm": pieces["norm"]}}
    for key, tree in state.items():
        assert like is None or (jax.tree_util.tree_structure(tree)
                                == jax.tree_util.tree_structure(like[key])), key
    return jax.tree_util.tree_map(jnp.asarray, state)


def _jax_initialize(brain, state):
    """What the JAX Brain's ``_ensure_initialized`` does after its lazy
    init (which applies every Flax module eagerly, ~20 s a model on the
    CPU), from given ``params``/``model_state``/``extra``: the optimizer
    state, the train state on the Brain's mesh, and the train state's
    checkpoint recoverable."""
    if brain.optimizer is None:
        brain.init_optimizers()
    state = dict(state, opt_state=brain.optimizer.init(state["params"]))
    brain.train_state = j_place_state(brain.mesh, state)
    brain._state_recoverable = JTrainStateRecoverable(brain)
    brain.checkpointer.add_recoverable("train_state",
                                       brain._state_recoverable)


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("transducer_recipe")
    data = root / "LibriSpeech"
    recipe.write_synthetic_librispeech(
        str(data), {"train-clean-100": 11, "dev-clean": 3},
        seconds=(1.0, 1.3), n_words=(2, 3), lexicon_size=12, seed=3)
    # short test utterances: JAX's host beam search applies its modules
    # eagerly, a few rounds a frame
    recipe.write_synthetic_librispeech(
        str(data), {"test-clean": 2}, seconds=(0.4, 0.5), n_words=(2, 3),
        lexicon_size=12, seed=4)
    return root, str(data)


@pytest.fixture(scope="module", params=["conformer", "crdnn"])
def fitted(request, corpus):
    """Both recipes fitted for 2 epochs from the same weights, then
    evaluated on the test set from their best checkpoints; the JAX
    recipe's RNN-T loss runs its Pallas kernels in interpret mode (as the
    JAX package's own tests run them on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpt.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        return _fit_both(request.param, *corpus)


def _fit_both(which, root, data):
    root = root / which
    train = _jax_recipe_module()
    train.transducer_loss = _tpu_transducer_loss

    # ---- JAX: the recipe's __main__
    with open(RECIPE / "hparams" / YAML[which]) as f:
        hp = load_hyperpyyaml(f, YAML_OVERRIDES[which]
                              + f"data_folder: {data}\n"
                              f"output_folder: {root / 'jax'}\n")
    del hp["augmentation"]  # the recipe applies it whenever it is set
    j_prepare(data_folder=data, save_folder=hp["save_folder"],
              tr_splits=["train-clean-100"], dev_splits=["dev-clean"],
              te_splits=["test-clean"])
    j_tok = JSentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="words",
        model_type=hp["token_type"], annotation_format="json")
    j_train, j_valid, j_test = train.dataio_prepare(hp, j_tok)

    class JaxTransducer(train.Transducer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            # one device, as the port trains (the suite's 8 virtual CPU
            # devices would pad every batch with replica rows)
            self.mesh = make_mesh(jax.devices()[:1])

        def evaluate_batch_full(self, batch, stage):
            """The Brain's ``evaluate_batch_full`` with the forward jitted
            (eager, it applies the Flax modules op by op, ~20 s a batch):
            validation batches through the jitted ``evaluate_batch`` (the
            recipe's validation computes the loss only), and in the test
            stage ``compute_objectives`` (the loss and the host search)
            outside jit, as the eager path runs it."""
            if stage == JStage.VALID:
                return self.evaluate_batch(batch, stage)
            device_batch = self.prepare_batch(batch)
            st = self.train_state
            self._bind(st["params"], st["model_state"], st["extra"],
                       self._make_step_rngs(self._next_rng()), train=False)
            predictions = jax.jit(
                lambda b: self.compute_forward(b, stage))(device_batch)
            return float(self.compute_objectives(predictions, device_batch,
                                                 stage))

        def transducer_searcher(self):
            """The recipe's searcher with its two model calls jitted (the
            same arithmetic; eager, each of its rounds applies the Flax
            modules op by op)."""
            searcher = super().transducer_searcher()
            searcher.pred_step_fn = jax.jit(searcher.pred_step_fn,
                                            static_argnums=2)
            searcher.joint_fn = jax.jit(searcher.joint_fn)
            return searcher

    jb = JaxTransducer(
        modules=hp["modules"],
        opt_class=lambda lr: hp["opt_class"](learning_rate=lr), hparams=hp,
        run_opts={"loss_sync_interval": 1, "noprogressbar": True},
        checkpointer=JCheckpointer(hp["save_folder"]))
    jb.tokenizer = j_tok

    # ---- the port: recipes.librispeech_transducer with the same values;
    # its seeded initial weights (the blank logit biased) go to both
    hparams, overrides = PORT[which]
    parts = recipe.build(data, str(root / "port"), overrides, RUN_OPTS,
                         hparams=hparams)
    pb = parts["brain"]
    with torch.no_grad():
        pb.modules.out_lin.bias[hp["blank_index"]] += BLANK_BIAS
    _jax_initialize(jb, _to_jax(which, pb))
    assert _same(_to_port(which, jb), pb.modules.state_dict())

    out = {name: {"losses": [], "lrs": [], "valid": []}
           for name in ("jax", "port")}
    _record(jb, out["jax"])
    _record(pb, out["port"])
    jb.fit(hp["epoch_counter"], j_train, j_valid)
    jb.evaluate(j_test, min_key="loss")
    pb.fit(parts["epoch_counter"], parts["train_loader"],
           parts["valid_loader"])
    pb.evaluate(parts["test_loader"], min_key="loss")

    # the port's evaluated state carried into the JAX Brain: both
    # validation losses on the validation batch
    jb.train_state = {**jb.train_state, **_to_jax(which, pb, jb.train_state)}
    carried = (pb.evaluate_batch(next(iter(parts["valid_loader"])),
                                 Stage.VALID),
               jb.evaluate_batch(next(iter(j_valid)), JStage.VALID))
    return dict(out, which=which, root=root, jb=jb, pb=pb, parts=parts,
                carried=carried)


def _rel_close(a, b, rtol=1e-5):
    assert abs(a - b) <= rtol * max(1.0, abs(b)), (a, b)


def test_recipe_losses_and_lrs_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["losses"]) == len(j["losses"]) >= 6
    for a, b in zip(p["losses"], j["losses"]):
        _rel_close(a, b)
    assert p["lrs"] == pytest.approx(j["lrs"], rel=1e-12)
    assert fitted["pb"].optimizer_step == fitted["jb"].optimizer_step


def test_recipe_validation_losses_match_jax(fitted):
    j, p = fitted["jax"]["valid"], fitted["port"]["valid"]
    assert len(p) == len(j) == 2
    for a, b in zip(p, j):
        _rel_close(a, b)


def test_recipe_train_log_matches_jax(fitted):
    def shape(path):
        return [re.sub(r"-?\d[\d.e+-]*", "#", line)
                for line in Path(path).read_text().splitlines()]

    root = fitted["root"]
    got = shape(root / "port" / "train_log.txt")
    assert got == shape(root / "jax" / "train_log.txt")
    assert len(got) == 3 and got[0].startswith("epoch: #, lr: #")
    assert got[-1].startswith("Epoch loaded: #")


def test_recipe_keeps_best_by_loss_and_evaluates_it(fitted):
    pb = fitted["pb"]
    ckpts = pb.checkpointer.list_checkpoints()
    best = min(c.meta["loss"] for c in ckpts)
    assert best == pytest.approx(min(fitted["port"]["valid"]))
    assert pb._recovered_ckpt.meta["loss"] == best
    assert {"brain.ckpt", "train_state.ckpt", "noam_annealing.ckpt",
            "train_loader.ckpt", "epoch_counter.ckpt"} <= {
        f.name for f in ckpts[0].path.iterdir()}
    assert set(pb.stage_stats) == {"VALID", "TEST"}
    assert set(pb.stage_stats["VALID"]) == {"loss"}


def test_recipe_test_search_matches_jax(fitted):
    """The test loss, and the beam-4 search's words per utterance (with
    their alignments) and WER."""
    j, p = fitted["jax"], fitted["port"]
    _rel_close(p["test"], j["test"])
    assert p["scores"] == j["scores"]
    assert len(p["scores"]) == 2 and all(s["num_ref_tokens"] > 0
                                         for s in p["scores"])
    assert p["wer"] == j["wer"] == fitted["pb"].stage_stats["TEST"]["WER"]


@pytest.mark.parametrize("brain_class,config", [
    (ConformerTransducerBrain, dict(
        CONFORMER_TRANSDUCER, frontend_channels=(4, 4), input_size=40,
        d_model=16, nhead=2, num_encoder_layers=1, d_ffn=32, kernel_size=5)),
    (CRDNNTransducerBrain, dict(
        CRDNN_TRANSDUCER, cnn_channels=(4, 4), rnn_layers=1, rnn_neurons=8,
        dnn_neurons=8)),
], ids=["conformer", "crdnn"])
def test_normalization_sees_the_epoch_counter(brain_class, config):
    """``fit`` passes the epoch counter's epoch to ``on_stage_start``; the
    input normalization updates its global mean and std in training
    before ``update_until_epoch`` (4) and freezes them from it on (its
    count goes on), as the JAX recipe's ``normalize(...,
    epoch=epoch_counter.current)`` does.  (The transducer Brain kept
    epoch 0, so the statistics never froze.)"""
    cfg = dict(config, n_mels=40, vocab_size=12, dec_emb_dim=8,
               dec_neurons=8, joint_dim=8, augmentation=None)
    brain = brain_class(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"sig": rng.standard_normal((2, 4000)).astype(np.float32),
             "sig_lens": np.ones(2, np.float32),
             "tokens": np.array([[3, 4], [5, 0]]),
             "tokens_lens": np.array([1.0, 0.5], np.float32),
             "tokens_blank": np.array([[0, 3, 4], [0, 5, 0]])}
    norm = brain.modules.normalize
    for i, (epoch, updates) in enumerate(((3, True), (3, True), (4, False),
                                          (5, False))):
        batch["sig"] = rng.standard_normal((2, 4000)).astype(np.float32)
        brain.on_stage_start(Stage.TRAIN, epoch)
        before = norm.mean.clone(), norm.std.clone(), float(norm.count)
        brain.step += 1
        brain.fit_batch(batch)
        moved = not (torch.equal(norm.mean, before[0])
                     and torch.equal(norm.std, before[1]))
        assert moved == updates, epoch
        assert float(norm.count) == before[2] + 1  # counts every batch
