"""The LibriSpeech CRDNN seq2seq recipe on the port
(``recipes/librispeech_seq2seq``), against the JAX recipe
(``recipes/LibriSpeech/ASR/seq2seq/train.py``, its ``ASR`` Brain taken by
path, hparams from ``hparams/train_BPE_1000.yaml`` through JAX's
``load_hyperpyyaml``) at toy widths (CNN 4/6 channels, an LSTM of 1 x 8,
DNN 1 x 8, embeddings 8, decoder 16, attention 12, 40 BPE tokens,
dropout 0), f32.

- One batch of the synthetic tree through ``compute_forward`` and
  ``compute_objectives`` in training mode (the global normalization
  updating, the CRDNN's BatchNorms on batch statistics; SpecAugment off,
  whose draws the two packages make differently): the loss within 1e-5
  relative and every gradient within 1e-4 of its tensor's largest
  magnitude (plus 1e-6 of the largest over all, for gradients that are
  roundoff), in a CTC epoch (0.5 CTC + 0.5 NLL) and after the CTC
  epochs (NLL alone).
- The port alone through ``run`` on a synthetic tree: one epoch, the
  validation's and the test's WER and CER from the beam search with the
  yaml's decode options, once with an RNNLM checkpoint (written from
  random weights) and once without; and 2 epochs resumed after the first
  in a fresh Brain equal 2 uninterrupted ones bit for bit (modules,
  Adadelta's accumulators, NewBob, the rate).
- The bridge's round trip over the recipe's modules, and the recipe's
  normalizations on float64 inputs in float64 (numpy's float64
  arithmetic within 1e-12), as Flax's and JAX's are: the card-vs-CPU
  float64 check of the smoke run relies on it.
"""

import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes import librispeech_seq2seq as recipe
from speechbrain_tpu_torch.recipes.librispeech_asr import (
    write_synthetic_librispeech,
)

from .test_torch_kernels import jax_value_and_grad, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "recipes/LibriSpeech/ASR/seq2seq"
TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8, dnn_blocks=1,
           dnn_neurons=8, emb_size=8, dec_neurons=16, attn_dim=12,
           vocab_size=40, dropout=0.0, batch_size=4, number_of_epochs=1,
           number_of_ctc_epochs=1, precision="fp32",
           train_splits=["train-clean-100"], valid_beam_size=3,
           test_beam_size=4, max_attn_shift=20, lm_emb_dim=8,
           lm_rnn_neurons=16, lm_dnn_neurons=12)
YAML_OVERRIDES = """
vocab_size: 40
dropout: 0.0
enc: !new:speechbrain_tpu.lobes.models.CRDNN.CRDNN
    cnn_blocks: 2
    cnn_channels: !tuple [4, 6]
    inter_layer_pooling_size: !tuple [2, 2]
    rnn_class: lstm
    rnn_layers: 1
    rnn_neurons: 8
    rnn_bidirectional: true
    dnn_blocks: 1
    dnn_neurons: 8
    dropout: 0.0
emb: !new:speechbrain_tpu.nnet.embedding.Embedding
    num_embeddings: 40
    embedding_dim: 8
dec: !new:speechbrain_tpu.nnet.RNN.AttentionalRNNDecoder
    rnn_type: gru
    attn_type: location
    hidden_size: 16
    attn_dim: 12
    num_layers: 1
    dropout: 0.0
"""
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
LOSS_RTOL, GRAD_SHARE = 1e-5, 1e-4


def _load_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2s_recipe")
    data = str(root / "LibriSpeech")
    write_synthetic_librispeech(
        data, {"train-clean-100": 8, "dev-clean": 4, "test-clean": 4},
        seconds=(1.0, 1.6), n_words=(3, 6), lexicon_size=40, seed=3)
    return root, data


@pytest.fixture(scope="module")
def brains(tree):
    """The port's recipe at toy widths and the JAX recipe's ``ASR`` on the
    port's manifests, tokenizer and initial weights; one training batch
    of 4 ragged utterances."""
    root, data = tree
    parts = recipe.build(data, str(root / "port"),
                         dict(TOY, augmentation=None), RUN_OPTS)
    pb = parts["brain"]
    train = _load_path("seq2seq_train_jax", RECIPE / "train.py")
    with open(RECIPE / "hparams" / "train_BPE_1000.yaml") as f:
        hp = load_hyperpyyaml(f, YAML_OVERRIDES + f"data_folder: {data}\n"
                              f"output_folder: {root / 'jax'}\n")
    del hp["augmentation"]  # the JAX recipe checks hasattr
    jb = train.ASR(modules=hp["modules"],
                   opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                   hparams=hp, run_opts={"noprogressbar": True})
    sd = pb.modules.state_dict()
    jparts = bridge.to_jax_crdnn_seq2seq(sd)
    state = {
        "params": {"enc": jparts["enc"]["params"], "emb": jparts["emb"],
                   "dec": jparts["dec"], "ctc_lin": jparts["ctc_lin"],
                   "seq_lin": jparts["seq_lin"]},
        "model_state": {"enc": {"batch_stats": jparts["enc"]["batch_stats"]}},
        "extra": {"norm": jparts["norm"]},
    }
    batch = next(iter(parts["train_loader"]))
    return {"pb": pb, "jb": jb, "hp": hp, "batch": batch,
            "state": jax.tree_util.tree_map(jnp.asarray, state)}


@pytest.mark.parametrize("norm", ["layer", "batch", "input"])
def test_normalizations_keep_float64(norm):
    """``LayerNorm`` (over (F, C)), ``BatchNorm1d`` in training mode and
    the global ``InputNormalization`` at its first training batch (ragged
    lengths), all in float64 with float64 weights that float32 cannot
    hold, against the same arithmetic in numpy float64: within 1e-12 of
    the output's scale.  Statistics or weights rounded to float32 miss
    by ~1e-7."""
    from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d, LayerNorm
    from speechbrain_tpu_torch.processing.features import InputNormalization

    rng = np.random.default_rng(7)
    x = 2.0 + 3.0 * rng.standard_normal((3, 5, 6, 4))
    if norm == "layer":
        w, b = rng.standard_normal((2, 6, 4))
        mod = LayerNorm((6, 4)).double()
        mean = x.mean((2, 3), keepdims=True)
        var = (x * x).mean((2, 3), keepdims=True) - mean ** 2
        want = (x - mean) / np.sqrt(var + 1e-5) * w + b
    elif norm == "batch":
        x = x.reshape(3, 5, 24)
        w, b = rng.standard_normal((2, 24))
        mod = BatchNorm1d(24).double().train()
        mean = x.mean((0, 1))
        var = (x * x).mean((0, 1)) - mean ** 2
        want = (x - mean) / np.sqrt(var + 1e-5) * w + b
    else:
        x = x.reshape(3, 5, 24)
        lens = np.array([1.0, 0.8, 0.6])
        mod = InputNormalization(24).double().train()
        n = np.round(lens * 5).astype(int)
        rows = [x[i, :n[i]] for i in range(3)]
        mean = np.mean([r.mean(0) for r in rows], 0)
        std = np.mean([r.std(0, ddof=1) for r in rows], 0)
        want = (x - mean) / std
    with torch.no_grad():
        if norm != "input":
            mod.weight.copy_(torch.from_numpy(w))
            mod.bias.copy_(torch.from_numpy(b))
            got = mod(torch.from_numpy(x))
        else:
            got = mod(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.dtype == torch.float64
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-12, err


def test_bridge_round_trips_the_recipe_modules(brains):
    """The port's modules -> the JAX recipe's pieces -> the port: every
    tensor of the state_dict comes back equal, under its own name."""
    modules = brains["pb"].modules
    sd = modules.state_dict()
    j = bridge.to_jax_crdnn_seq2seq(sd)
    back = bridge.crdnn_seq2seq_state_dict(
        j["enc"], j["emb"], j["dec"], j["ctc_lin"], j["seq_lin"], j["norm"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        got = torch.as_tensor(np.asarray(back[k]))
        assert got.shape == v.shape, k
        assert torch.equal(got.to(v.dtype), v), k


@pytest.mark.parametrize("epoch", [1, 2])
def test_step_loss_and_gradients_match_jax(brains, epoch):
    """Epoch 1 is a CTC epoch, epoch 2 (``number_of_ctc_epochs`` 1) is
    not; see the module docstring for the tolerances."""
    pb, jb, state = brains["pb"], brains["jb"], brains["state"]
    host = brains["batch"].numeric_dict()
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jbatch["batch_mask"] = jnp.ones(host["sig"].shape[0], jnp.float32)
    jb.hparams.epoch_counter.current = epoch
    jb.hparams.number_of_ctc_epochs = 1
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

    def loss_fn(params):
        loss, (_, _, extra) = jb._loss_fn(params, state["model_state"],
                                          state["extra"], jbatch, rngs,
                                          JStage.TRAIN)
        return loss, extra

    (jloss, _), jgrads = jax_value_and_grad(loss_fn)(state["params"])

    saved = {k: v.clone() for k, v in pb.modules.state_dict().items()}
    pb.epoch = epoch
    pb.modules.train()
    pb.modules.zero_grad(set_to_none=True)
    batch = pb.prepare_batch(brains["batch"])
    loss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                 batch, Stage.TRAIN)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))

    grads = dict(pb.modules.state_dict())
    grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in pb.modules.named_parameters()})
    got = bridge.to_jax_crdnn_seq2seq(grads)
    got = {"enc": got["enc"]["params"], **{k: got[k] for k in (
        "emb", "dec", "ctc_lin", "seq_lin")}}
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    paths_g = jax.tree_util.tree_leaves_with_path(got)
    paths_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in paths_g] == [k for k, _ in paths_w]
    top = max(float(np.abs(w).max()) for _, w in paths_w)
    for (path, g), (_, w) in zip(paths_g, paths_w):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_SHARE * scale + 1e-6 * top,
            err_msg=jax.tree_util.keystr(path))
    ctc_grad = float(np.abs(want["ctc_lin"]["Dense_0"]["kernel"]).max())
    assert (ctc_grad > 0) == (epoch == 1)
    pb.modules.load_state_dict(saved)


@pytest.mark.parametrize("with_lm", [False, True])
def test_run_one_epoch_with_validation_and_test(tree, tmp_path, with_lm):
    """``run``: one epoch, the validation's and the test's WER and CER
    from the beam search (with the RNNLM fused at 0.5 when its checkpoint
    is given), NewBob on the validation WER, the log and the WER file."""
    _, data = tree
    run_opts = dict(RUN_OPTS)
    if with_lm:
        lm = recipe.build_lm(TOY, seed=1)
        torch.save(lm.state_dict(), tmp_path / "lm.ckpt")
        run_opts["lm_ckpt"] = str(tmp_path / "lm.ckpt")
    out = tmp_path / "out"
    brain = recipe.run(data, str(out), TOY, run_opts)
    assert (brain.lm is not None) == with_lm
    searcher = brain.make_searcher(2)
    assert type(searcher).__name__ == (
        "S2SRNNBeamSearchLM" if with_lm else "S2SRNNBeamSearcher")
    for stage in ("VALID", "TEST"):
        stats = brain.stage_stats[stage]
        assert set(stats) == {"loss", "WER", "CER"}
        assert all(np.isfinite(v) for v in stats.values())
    log = (out / "train_log.txt").read_text().splitlines()
    assert log[0].startswith("epoch: 1, lr: 1.00e+00 - train loss")
    assert "valid WER" in log[0] and "valid CER" in log[0]
    assert log[1].startswith("Epoch loaded: 1 - test loss")
    assert "%WER" in (out / "wer.txt").read_text()
    ckpt = brain._recovered_ckpt
    assert {"brain.ckpt", "train_state.ckpt", "lr_annealing.ckpt",
            "train_loader.ckpt", "epoch_counter.ckpt"} <= {
        f.name for f in ckpt.path.iterdir()}
    assert ckpt.meta["WER"] == brain.stage_stats["VALID"]["WER"]


def test_bpe_5000_yaml_is_the_1000_one_at_5000_tokens():
    assert recipe.HPARAMS_BPE_5000 == dict(recipe.HPARAMS, vocab_size=5000)
    modules = recipe.build_modules(dict(TOY, vocab_size=5000))
    assert modules["seq_lin"].weight.shape == (5000, 16)
    assert modules["ctc_lin"].weight.shape == (5000, 8)
    assert modules["emb"].weight.shape == (5000, 8)


def _final_state(brain):
    return ({k: v.clone() for k, v in brain.modules.state_dict().items()},
            brain.optimizer.state_dict()["state"], brain.lr,
            brain.lr_annealing.metric_values)


def test_resumed_epoch_equals_the_uninterrupted_one(tree, tmp_path):
    """A fresh Brain resumes epoch 2 (after the CTC epoch) from the
    checkpoint of epoch 1, with SpecAugment on, and ends where 2
    uninterrupted epochs end, bit for bit; NewBob's history is restored."""
    _, data = tree

    def fit(out, epochs):
        parts = recipe.build(data, out, dict(TOY, number_of_epochs=epochs),
                             RUN_OPTS)
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    fit(str(tmp_path / "resumed"), 1)
    resumed = fit(str(tmp_path / "resumed"), 2)
    whole = fit(str(tmp_path / "whole"), 2)
    (ma, oa, lra, nba), (mb, ob, lrb, nbb) = (_final_state(resumed),
                                             _final_state(whole))
    assert ma.keys() == mb.keys()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert lra == lrb and nba == nbb and len(nba) == 2
    shutil.rmtree(tmp_path / "whole")
