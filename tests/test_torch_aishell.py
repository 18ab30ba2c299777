"""The AISHELL-1 recipes on the port against the JAX recipes:
``recipes/aishell_prepare.py`` and ``recipes/aishell_asr.py`` with the
three Fbank yamls (``ASR/seq2seq/hparams/train.yaml``,
``ASR/transformer/hparams/conformer_small.yaml`` and
``train_ASR_transformer.yaml``), the JAX scripts taken by path, on a
synthetic corpus (``write_synthetic_aishell``, with untranscribed WAVs).

Tolerances:

- the manifests: byte for byte; the character inventory: the same
  labels (with ``<bos>`` and ``<eos>`` at 1 and 2 in the port, see the
  test);
- the training steps (the recipes' first training batch at toy widths,
  f32, through the JAX scripts' ``ASR._loss_fn`` at the port's weights):
  the loss within 1e-5 relative, each gradient within 1e-4 of its
  tensor's largest plus 1e-6 of the largest overall (the conv front
  end's first kernel within 5e-4: its gradient sums the features, which
  differ by up to 2e-3 dB between the frameworks' Fbanks; the biases that
  feed a training-mode BatchNorm (the CRDNN's DNN, the conv front end),
  whose gradient is rounding noise, within 1e-5 of the largest overall);
- the greedy CTC CER: equal to JAX's;
- a resumed run: bit for bit.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders.ctc import ctc_greedy_decode as j_greedy
from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRate
from speechbrain_tpu_torch.recipes import aishell_asr as recipe
from speechbrain_tpu_torch.recipes import aishell_prepare as prep

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_transformer_encoder_asr import (
    CONFORMER_TOY,
    RESUME,
    assert_same_files,
    assert_resume_matches,
    assert_step_matches,
    assert_transformer_yaml,
    assert_yaml_values,
    conformer_jax_state,
    conformer_yaml_toy,
    crdnn_jax_state,
    jax_recipe_brain,
    load_path,
    load_yaml,
)

REPO = Path(__file__).resolve().parents[1]
AISHELL = REPO / "recipes/AISHELL-1"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
COUNTS = {"train": 8, "dev": 2, "test": 2}
S2S_TOY = dict(cnn_channels=(4, 4, 6), rnn_layers=1, rnn_neurons=8,
               dnn_blocks=1, dnn_neurons=8, emb_size=8, dec_neurons=16,
               attn_dim=12, vocab_size=50, n_mels=20, dropout=0.0,
               batch_size=4, number_of_epochs=2)
S2S_YAML_TOY = """
output_neurons: 50
n_mels: 20
dropout: 0.0
enc: !new:speechbrain_tpu.lobes.models.CRDNN.CRDNN
    cnn_blocks: 3
    cnn_channels: !tuple [4, 4, 6]
    inter_layer_pooling_size: !tuple [2, 2, 2]
    rnn_class: lstm
    rnn_layers: 1
    rnn_neurons: 8
    rnn_bidirectional: true
    dnn_blocks: 1
    dnn_neurons: 8
    dropout: 0.0
emb: !new:speechbrain_tpu.nnet.embedding.Embedding
    num_embeddings: !ref <output_neurons>
    embedding_dim: 8
dec: !new:speechbrain_tpu.nnet.RNN.AttentionalRNNDecoder
    rnn_type: gru
    attn_type: location
    hidden_size: 16
    attn_dim: 12
    num_layers: 1
    dropout: 0.0
"""
FAMILIES = {
    "seq2seq": (recipe.HPARAMS_SEQ2SEQ, "seq2seq/hparams/train.yaml"),
    "conformer": (recipe.HPARAMS_CONFORMER,
                  "transformer/hparams/conformer_small.yaml"),
    "transformer": (recipe.HPARAMS_TRANSFORMER,
                    "transformer/hparams/train_ASR_transformer.yaml"),
}

BUILD = {"seq2seq": recipe.build_seq2seq,
         "conformer": recipe.build_transformer,
         "transformer": recipe.build_transformer}


def _toy(name):
    return dict(S2S_TOY) if name == "seq2seq" else dict(CONFORMER_TOY)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("aishell") / "aishell"
    prep.write_synthetic_aishell(str(data), COUNTS, seconds=(1.0, 1.3),
                                 n_words=(2, 3), n_chars=15, seed=3,
                                 untranscribed=1)
    return data


def test_prepare_writes_the_jax_manifests(corpus, tmp_path):
    """Both preparations on one corpus: the same three manifests, byte
    for byte; the untranscribed WAVs left out."""
    jprep = load_path("aishell_prepare_jax", AISHELL / "aishell_prepare.py")
    prep.prepare_aishell(str(corpus), str(tmp_path / "port"))
    jprep.prepare_aishell(str(corpus), str(tmp_path / "jax"))
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    for split, n in COUNTS.items():
        rows = json.loads((tmp_path / f"port/{split}.json").read_text())
        assert len(rows) == n


@pytest.mark.parametrize("name", list(FAMILIES))
def test_yamls_match_the_dicts(name, tmp_path):
    hp, rel = FAMILIES[name]
    y = load_yaml(AISHELL / "ASR" / rel, "", tmp_path)
    if name == "seq2seq":
        assert_yaml_values(y, hp, 20, skip=("vocab_size",))
        assert y["output_neurons"] == hp["vocab_size"] == 5000
        assert (y["dec"].attn_dim, y["enc"].rnn_class,
                y["lr_annealing"].hyperparam_value) == (
            hp["attn_dim"], "lstm", hp["lr"])
        assert "augmentation" not in y and "label_smoothing" not in y
    else:
        assert_yaml_values(y, hp, 25)
        assert_transformer_yaml(y, hp)
        assert y["output_neurons"] == hp["vocab_size"] == 4300


def test_label_encoder_spans_all_splits_with_bos_and_eos_at_1_and_2(
        tmp_path):
    """The character inventory spans all three splits, as JAX's
    ``dataio_prepare`` builds it (the seq2seq script's; the transformer
    script's is the same code): a character that only the test split
    holds is in both.  JAX appends ``<bos>`` and ``<eos>`` after the
    characters, so its bos 1 and eos 2 are characters
    (``train.py:161-173``); the port holds them at 1 and 2, the two
    characters there moved to the end."""
    corpus = tmp_path / "aishell"
    prep.write_synthetic_aishell(str(corpus), {"train": 3, "dev": 2,
                                               "test": 3},
                                 seconds=(0.5, 0.6), n_chars=30, seed=1)
    parts = recipe.build_seq2seq(str(corpus), str(tmp_path / "port"),
                                 S2S_TOY, RUN_OPTS)
    script = load_path("aishell_s2s_jax", AISHELL / "ASR/seq2seq/train.py")
    hp = load_yaml(AISHELL / "ASR/seq2seq/hparams/train.yaml", S2S_YAML_TOY,
                   tmp_path)
    shutil.copytree(tmp_path / "port/save", hp["save_folder"],
                    ignore=shutil.ignore_patterns("label_encoder.txt", "CKPT*"))
    _, jenc = script.dataio_prepare(hp)
    enc = parts["label_encoder"]
    assert set(enc.lab2ind) == set(jenc.lab2ind)
    assert (enc.lab2ind["<blank>"], enc.lab2ind["<bos>"],
            enc.lab2ind["<eos>"]) == (0, 1, 2)
    assert jenc.lab2ind["<blank>"] == 0
    assert jenc.lab2ind["<bos>"] > 2 and jenc.lab2ind["<eos>"] > 2
    assert jenc.ind2lab[1] not in ("<bos>", "<eos>")
    chars = {split: {c for r in json.loads((tmp_path / f"port/save/{split}"
                                            ".json").read_text()).values()
                     for c in r["transcript"].replace(" ", "")}
             for split in ("train", "dev", "test")}
    only_test = chars["test"] - chars["train"] - chars["dev"]
    assert only_test and all(c in enc.lab2ind for c in only_test)
    # the port's datasets carry its bos and eos
    ex = parts["train_loader"].dataset[0]
    assert ex["tokens_bos"][0] == 1 and ex["tokens_eos"][-1] == 2
    assert 1 not in ex["tokens"] and 2 not in ex["tokens"]


def test_seq2seq_step_matches_jax(corpus, tmp_path):
    """``CharSeq2SeqBrain`` against the JAX seq2seq script's ``ASR``:
    0.3 CTC + 0.7 NLL with no label smoothing."""
    parts = recipe.build_seq2seq(str(corpus), str(tmp_path / "port"),
                                 S2S_TOY, RUN_OPTS)
    script = load_path("aishell_s2s_jax", AISHELL / "ASR/seq2seq/train.py")
    jb = jax_recipe_brain(script, load_yaml(
        AISHELL / "ASR/seq2seq/hparams/train.yaml", S2S_YAML_TOY, tmp_path))
    params, model_state, extra, grads = crdnn_jax_state(parts["brain"])
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


@pytest.mark.parametrize("name,encoder,attention", [
    ("conformer", "conformer", "RelPosMHAXL"),
    ("transformer", "transformer", "regularMHA")])
def test_transformer_step_matches_jax(corpus, tmp_path, name, encoder,
                                      attention):
    """``CharCTCBrain`` with ``conformer_small.yaml`` and with
    ``train_ASR_transformer.yaml`` against the JAX transformer script's
    ``ASR``."""
    hp, rel = FAMILIES[name]
    parts = recipe.build_transformer(str(corpus), str(tmp_path / "port"),
                                     CONFORMER_TOY, RUN_OPTS, hp)
    assert parts["brain"].model.transformer.encoder_module == encoder
    script = load_path("aishell_tr_jax", AISHELL / "ASR/transformer/train.py")
    jb = jax_recipe_brain(script, load_yaml(
        AISHELL / "ASR" / rel, conformer_yaml_toy(encoder, attention),
        tmp_path))
    params, model_state, extra, grads = conformer_jax_state(parts["brain"])
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


def test_greedy_cer_matches_jax_beyond_the_inventory(corpus, tmp_path):
    """The CER of a greedy CTC decode whose argmaxes fall on outputs the
    inventory does not map (the yamls' output layers keep 5000 and 4300
    units, ``train.yaml:38``; the JAX script never resizes them): they
    score as ``<id=N>`` in both, with the same error rate."""
    parts = recipe.build_seq2seq(str(corpus), str(tmp_path / "port"),
                                 S2S_TOY, RUN_OPTS)
    brain, enc = parts["brain"], parts["label_encoder"]
    assert brain.modules.ctc_lin.weight.shape[0] == S2S_TOY["vocab_size"]
    assert len(enc.lab2ind) < S2S_TOY["vocab_size"]
    text = (AISHELL / "ASR/seq2seq/train.py").read_text()
    assert "output_neurons" not in text
    rng = np.random.default_rng(0)
    logp = rng.standard_normal((3, 12, S2S_TOY["vocab_size"])).astype(
        np.float32)
    logp[:, ::3, S2S_TOY["vocab_size"] - 1] = 9.0  # an unmapped output
    tokens = np.array([[3, 4, 5], [6, 7, 0], [8, 0, 0]])
    lens = np.array([1.0, 2 / 3, 1 / 3], np.float32)
    batch = {"tokens": torch.from_numpy(tokens),
             "tokens_lens": torch.from_numpy(lens),
             "sig_lens": torch.tensor([1.0, 0.9, 0.5]),
             "batch_mask": torch.ones(3)}
    from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

    brain.cer_metric = ErrorRateStats()
    brain._score_ctc(torch.from_numpy(logp), batch)
    hyps = j_greedy(logp, np.array([1.0, 0.9, 0.5]), blank_id=0)
    targets = [t[:int(round(float(l) * 3))] for t, l in zip(tokens.tolist(),
                                                            lens)]
    jcer = JErrorRate()
    jcer.append(["0", "1", "2"], hyps, targets, ind2lab=enc.decode_ndim)
    assert any(S2S_TOY["vocab_size"] - 1 in h for h in hyps)
    assert brain.cer_metric.summarize("error_rate") == jcer.summarize(
        "error_rate")


@pytest.mark.parametrize("name", ["seq2seq", "conformer"])
def test_run_resumes_bit_for_bit(corpus, tmp_path, name):
    """2 epochs (the validation CER, the best by CER kept) equal 1 epoch
    plus a resumed one in a fresh Brain, bit for bit; then the test from
    the best checkpoint."""
    hp = FAMILIES[name][0]
    toy = _toy(name)

    def build(folder, epochs):
        return BUILD[name](str(corpus), str(tmp_path / folder),
                            dict(toy, **RESUME, number_of_epochs=epochs),
                            RUN_OPTS, hp)

    full = assert_resume_matches(build)
    full["brain"].evaluate(full["test_loader"], min_key="CER")
    for stage in ("VALID", "TEST"):
        assert set(full["brain"].stage_stats[stage]) == {"loss", "CER"}
    log = (tmp_path / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 3 and "valid CER" in log[0] and "test CER" in log[2]


def test_noam_is_checkpointed_where_the_jax_script_does_not(corpus,
                                                            tmp_path):
    """The JAX transformer script registers no schedule with its
    checkpointer (a resumed run restarts the Noam warmup); the port's
    Brain registers it, so the resumed epoch continues the warmup."""
    text = (AISHELL / "ASR/transformer/train.py").read_text()
    assert "add_recoverable" not in text and "noam_annealing()" in text
    out = tmp_path / "out"
    recipe.run_transformer(str(corpus), str(out),
                           dict(CONFORMER_TOY, number_of_epochs=1), RUN_OPTS,
                           recipe.HPARAMS_CONFORMER)
    ckpt = next((out / "save").glob("CKPT*"))
    assert (ckpt / "noam_annealing.ckpt").exists()
    brain = recipe.build_transformer(str(corpus), str(out), CONFORMER_TOY,
                                     RUN_OPTS, recipe.HPARAMS_CONFORMER)[
        "brain"]
    brain.checkpointer.recover_if_possible()
    assert brain.noam.n_steps > 0
