"""The CommonVoice ASR recipes on the port against the JAX recipes:
``recipes/common_voice_prepare.py`` and ``recipes/commonvoice_asr.py``
with the six Fbank seq2seq yamls (``ASR/seq2seq/hparams/train*.yaml``),
``ASR/transformer/hparams/train_fr.yaml`` and
``ASR/transducer/hparams/train_fr.yaml``, the JAX scripts taken by path,
on synthetic language folders (``write_synthetic_common_voice``).

Tolerances:

- the manifests: byte for byte, with ``accented_letters`` true and false;
- the training steps (the recipes' first training batch at toy widths,
  f32, through the JAX scripts' ``_loss_fn`` at the port's weights): as
  ``tests/test_torch_aishell.py`` holds AISHELL-1's (``assert_step_matches``:
  the loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
  largest plus 1e-6 of the largest overall; the first convolution of each
  CNN block within 5e-4, the biases before a training-mode BatchNorm within
  1e-5 of the largest overall); the transducer's RNN-T loss through JAX's
  scan (no batch here has a row without frames, where it differs from the
  kernels), its gradients within ``TRANSDUCER_GRAD_SHARE`` (1e-3) of each
  tensor's largest, on clips of one length: the CRDNN's CNN blocks end in a
  max pool over frequency, whose argmax flips on near ties.  Padded frames
  are constant, so a ragged batch puts such ties in every pooling window
  there, and the gradients of the LayerNorms before the pools move by up to
  45 % of their scale between the port's own float32 and float64 runs of
  the step (and by up to 29 % between the port and JAX); without padding
  the CNN blocks' float32 gradients lie within 1.4e-2 of their float64
  ones and within 3e-4 of JAX's;
- the transducer's greedy validation search: the same hypotheses and PER
  as JAX's ``TransducerBeamSearcher`` at beam 1 on the same encoder states;
- a resumed run: bit for bit.
"""

import json
import os
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.recipes import aishell_asr
from speechbrain_tpu_torch.recipes import common_voice_prepare as prep
from speechbrain_tpu_torch.recipes import commonvoice_asr as cv

from .test_torch_aishell import S2S_TOY, S2S_YAML_TOY
from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_transformer_encoder_asr import (
    CONFORMER_TOY,
    RESUME,
    assert_resume_matches,
    assert_same_files,
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
CV = REPO / "recipes/CommonVoice"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
COUNTS = {"train": 8, "dev": 2, "test": 2}
S2S_CV_TOY = dict(S2S_TOY, vocab_size=40)
T_TOY = dict(n_mels=16, cnn_channels=(4, 4), rnn_layers=1, rnn_neurons=8,
             dnn_blocks=1, dnn_neurons=8, joint_dim=8, dec_emb_dim=8,
             dec_neurons=8, dropout=0.0, precision="fp32",
             number_of_epochs=2)
T_YAML_TOY = """
n_mels: 16
cnn_channels: !tuple [4, 4]
rnn_layers: 1
rnn_neurons: 8
dnn_blocks: 1
dnn_neurons: 8
joint_dim: 8
dropout: 0.0
precision: fp32
"""
TRANSDUCER_GRAD_SHARE = 1e-3
# added to the blank logit's bias, so that the toy transducer's greedy search
# emit blanks and end in a few rounds a frame
BLANK_BIAS = 1.0


def _corpus(root, language, counts=COUNTS, seconds=(0.6, 0.9), seed=3):
    data = root / language
    prep.write_synthetic_common_voice(str(data), counts, language=language,
                                      seconds=seconds, seed=seed)
    return data


@pytest.fixture(scope="module")
def fr(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("cv"), "fr")


def _jax_prepare():
    return load_path("common_voice_prepare_jax",
                     CV / "common_voice_prepare.py")


@pytest.mark.parametrize("language,accented", [
    ("fr", True), ("fr", False), ("de", True), ("it", True), ("rw", True),
    ("en", False)])
def test_prepare_writes_the_jax_manifests(tmp_path, language, accented):
    """Both preparations on one language folder (each tsv names an
    ``.mp3`` clip with a ``.wav`` beside it): the same three manifests,
    byte for byte; accented letters kept or folded."""
    data = _corpus(tmp_path, language, {"train": 4, "dev": 2, "test": 2},
                   seconds=(0.2, 0.3))
    kw = dict(accented_letters=accented, language=language)
    prep.prepare_common_voice(str(data), str(tmp_path / "port"), **kw)
    _jax_prepare().prepare_common_voice(str(data), str(tmp_path / "jax"),
                                        **kw)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    words = [r["words"] for r in json.loads(
        (tmp_path / "port/train.json").read_text()).values()]
    assert len(words) == 4 and all(w == w.upper() for w in words)
    assert all(c.isalpha() or c in " '" for w in words for c in w)
    if language == "fr":
        assert any(not c.isascii() for w in words for c in w) == accented


def test_accented_letters_change_the_manifests(tmp_path):
    """``accented_letters`` true and false give other words, and
    ``clean_transcript`` ignores its ``language`` in both packages
    (``common_voice_prepare.py:21-38``)."""
    jprep = _jax_prepare()
    text = "L'été, où ça? Straße: città!"
    for fn in (prep.clean_transcript, jprep.clean_transcript):
        for accented in (True, False):
            outs = {fn(text, lang, accented)
                    for lang in ("en", "fr", "de", "it", "rw")}
            assert len(outs) == 1
        assert fn(text, "fr", True) == "L'ÉTÉ OÙ ÇA STRASSE CITTÀ"
        assert fn(text, "fr", False) == "L'ETE OU CA STRASSE CITTA"


def _write_wav(path, seconds, rate):
    pcm = (np.random.default_rng(0).standard_normal(int(seconds * rate))
           * 3000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_durations_follow_the_file_rate(tmp_path):
    """A 48 kHz clip of 4 s: JAX divides its samples by 16000 whatever the
    rate (``common_voice_prepare.py:84-90``), reads 12 s and drops it by
    the 10 s train filter; the port reads 4 s and keeps it.  A clip
    neither can decode (an ``.mp3`` alone, no ffmpeg) keeps the JAX
    estimate, its bytes over 16000, in both."""
    data = _corpus(tmp_path, "en", {"train": 1, "dev": 1, "test": 1},
                   seconds=(0.2, 0.3))
    _write_wav(data / "clips/loud.wav", 4.0, 48000)
    (data / "clips/packed.mp3").write_bytes(bytes(range(256)) * 10)
    with open(data / "train.tsv", "a", encoding="utf-8") as f:
        f.write("c\tloud.mp3\tLoud clip.\t2\t0\t\t\t\n"
                "c\tpacked.mp3\tPacked clip.\t2\t0\t\t\t\n")
    prep.prepare_common_voice(str(data), str(tmp_path / "port"))
    _jax_prepare().prepare_common_voice(str(data), str(tmp_path / "jax"))
    port = json.loads((tmp_path / "port/train.json").read_text())
    jax_rows = json.loads((tmp_path / "jax/train.json").read_text())
    assert port["loud"]["duration"] == 4.0 and "loud" not in jax_rows
    assert port["packed"] == jax_rows["packed"]
    assert port["packed"]["duration"] == 0.16


SEQ2SEQ_YAMLS = sorted(cv.SEQ2SEQ_YAMLS)


@pytest.mark.parametrize("name", SEQ2SEQ_YAMLS + ["transformer/train_fr.yaml",
                                                  "transducer/train_fr.yaml"])
def test_yamls_match_the_dicts(name, tmp_path):
    """Each yaml through JAX's ``load_hyperpyyaml`` against its dict; the
    six seq2seq yamls differ from each other in ``language``,
    ``accented_letters`` and the output folder alone, and from AISHELL-1's
    in the corpus and 500 outputs; the conformer's yaml is AISHELL-1's
    ``conformer_small.yaml`` with its comments naming AISHELL-1's corpus."""
    if name in cv.SEQ2SEQ_YAMLS:
        hp = cv.SEQ2SEQ_YAMLS[name]
        y = load_yaml(CV / "ASR/seq2seq/hparams" / name, "", tmp_path)
        assert_yaml_values(y, hp, 22, skip=("vocab_size",))
        assert y["output_neurons"] == hp["vocab_size"] == 500
        assert (y["dec"].attn_dim, y["dec"].attn_type, y["enc"].rnn_class,
                y["lr_annealing"].hyperparam_value) == (
            hp["attn_dim"], "location", "lstm", hp["lr"])
        differ = {k for k in hp if hp[k] != cv.HPARAMS_SEQ2SEQ[k]}
        assert differ <= {"language", "accented_letters"}
        assert {k for k in hp if hp[k] != aishell_asr.HPARAMS_SEQ2SEQ.get(
            k)} == {"vocab_size", "language", "accented_letters",
                    "duration_threshold"}
        return
    family = name.split("/")[0]
    y = load_yaml(CV / "ASR" / family / "hparams/train_fr.yaml", "", tmp_path)
    if family == "transformer":
        hp = cv.HPARAMS_TRANSFORMER_FR
        assert_yaml_values(y, hp, 25)
        assert_transformer_yaml(y, hp)
        assert y["output_neurons"] == hp["vocab_size"] == 4300
        text = (CV / "ASR/transformer/hparams/train_fr.yaml").read_text()
        assert "Mandarin" in text
        differ = {k for k in hp
                  if hp[k] != aishell_asr.HPARAMS_CONFORMER.get(k)}
        assert differ == {"language", "accented_letters",
                          "duration_threshold"}
        return
    hp = cv.HPARAMS_TRANSDUCER_FR
    assert_yaml_values(y, hp, 22, skip=("vocab_size",))
    assert y["output_neurons"] == hp["vocab_size"] == 40
    assert (y["test_beam_size"], y["valid_beam_size"]) == (hp["beam_size"], 1)
    enc = y["enc"]
    assert (enc.rnn_class, tuple(enc.cnn_channels), enc.rnn_layers,
            enc.rnn_neurons, enc.dnn_neurons) == (
        "ligru", hp["cnn_channels"], hp["rnn_layers"], hp["rnn_neurons"],
        hp["dnn_neurons"])
    assert y["emb"].embedding_dim == hp["dec_emb_dim"] == hp["joint_dim"]
    assert y["dec"].hidden_size == hp["dec_neurons"] == hp["joint_dim"]
    assert y["compute_features"].deltas and hp["deltas"]
    assert y["normalize"].update_until_epoch == hp["update_until_epoch"]
    assert (y["lr_annealing"].annealing_factor,
            y["lr_annealing"].improvement_threshold) == (
        hp["annealing_factor"], hp["improvement_threshold"])


def test_seq2seq_step_matches_jax(fr, tmp_path):
    """``CharSeq2SeqBrain`` on ``train_fr.yaml`` against the JAX seq2seq
    script's ``ASR``: 0.3 CTC + 0.7 NLL over the characters, spaces
    included."""
    parts = cv.build_seq2seq(str(fr), str(tmp_path / "port"), S2S_CV_TOY,
                             RUN_OPTS, cv.HPARAMS_SEQ2SEQ_FR)
    enc = parts["label_encoder"]
    assert " " in enc.lab2ind and (enc.lab2ind["<bos>"],
                                   enc.lab2ind["<eos>"]) == (1, 2)
    script = load_path("cv_s2s_jax", CV / "ASR/seq2seq/train.py")
    jb = jax_recipe_brain(script, load_yaml(
        CV / "ASR/seq2seq/hparams/train_fr.yaml",
        S2S_YAML_TOY.replace("output_neurons: 50", "output_neurons: 40"),
        tmp_path))
    params, model_state, extra, grads = crdnn_jax_state(parts["brain"])
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


def test_conformer_step_matches_jax(fr, tmp_path):
    """``CharCTCBrain`` on ``transformer/train_fr.yaml`` against the JAX
    transformer script's ``ASR``, over the characters without spaces."""
    parts = cv.build_transformer(str(fr), str(tmp_path / "port"),
                                 CONFORMER_TOY, RUN_OPTS)
    assert " " not in parts["label_encoder"].lab2ind
    script = load_path("cv_tr_jax", CV / "ASR/transformer/train.py")
    jb = jax_recipe_brain(script, load_yaml(
        CV / "ASR/transformer/hparams/train_fr.yaml", conformer_yaml_toy(),
        tmp_path))
    params, model_state, extra, grads = conformer_jax_state(parts["brain"])
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


_KEYS = {"tokens": "phn_encoded", "tokens_blank": "phn_encoded_blank",
         "tokens_lens": "phn_encoded_lens",
         "tokens_blank_lens": "phn_encoded_blank_lens"}


def _jax_transducer(tmp_path, script=None):
    """The JAX transducer script's ``Transducer`` on the yaml at toy
    widths, reading the port's batch keys."""
    script = script or load_path("cv_transducer_jax",
                                 CV / "ASR/transducer/train.py")

    def rename(batch):
        return {_KEYS.get(k, k): v for k, v in batch.items()}

    class Transducer(script.Transducer):
        def compute_forward(self, batch, stage):
            return super().compute_forward(rename(batch), stage)

        def compute_objectives(self, predictions, batch, stage):
            return super().compute_objectives(predictions, rename(batch),
                                              stage)

    hp = load_yaml(CV / "ASR/transducer/hparams/train_fr.yaml", T_YAML_TOY,
                   tmp_path)
    return Transducer(modules=hp["modules"],
                      opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                      hparams=hp, run_opts={"noprogressbar": True})


def transducer_jax_state(pb):
    """The port's transducer Brain's weights as the JAX script's
    ``(params, model_state, extra)``, and the map of its gradients."""
    p = bridge.to_jax_crdnn_transducer(pb.modules.state_dict())

    def grads(sd):
        g = bridge.to_jax_crdnn_transducer(sd)
        return {"enc": g["enc"]["params"],
                **{k: g[k] for k in ("enc_lin", "emb", "dec", "dec_lin",
                                     "out_lin")}}

    return (grads(pb.modules.state_dict()),
            {"enc": {"batch_stats": p["enc"]["batch_stats"]}},
            {"norm": p["norm"]}, grads)


def test_transducer_step_matches_jax(tmp_path):
    """``CharTransducerBrain`` on ``transducer/train_fr.yaml`` against the
    JAX script's ``Transducer``: Fbank with deltas, the CRDNN-LiGRU, the
    GRU prediction network, the tanh joint and the RNN-T loss; Adadelta.
    The clips have one length (see the module's tolerances)."""
    data = _corpus(tmp_path, "fr", seconds=(0.8, 0.8))
    parts = cv.build_transducer(str(data), str(tmp_path / "port"), T_TOY,
                                RUN_OPTS)
    brain = parts["brain"]
    assert type(brain.optimizer).__name__ == "Adadelta"
    assert brain.modules.normalize.mean.shape[-1] == 3 * T_TOY["n_mels"]
    jb = _jax_transducer(tmp_path)
    params, model_state, extra, grads = transducer_jax_state(brain)
    batch = next(iter(parts["train_loader"]))
    assert float(batch.numeric_dict()["sig_lens"].min()) == 1.0
    assert_step_matches(brain, jb, batch, params, model_state, extra, grads,
                        grad_share=TRANSDUCER_GRAD_SHARE)


def test_transducer_greedy_validation_matches_jax(fr, tmp_path):
    """The validation stage's greedy search (``valid_beam_size`` 1) on one
    batch's encoder states: the port's hypotheses and PER equal those of
    the JAX script's searcher at beam 1 (its ``state_beam`` and
    ``expand_beam``), the blank logit biased +1."""
    from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JER
    from speechbrain_tpu_torch.core import Stage

    parts = cv.build_transducer(str(fr), str(tmp_path / "port"), T_TOY,
                                RUN_OPTS)
    brain = parts["brain"]
    with torch.no_grad():
        brain.modules.out_lin.bias[0] += BLANK_BIAS
    batch = brain.prepare_batch(next(iter(parts["valid_loader"])))
    brain.modules.eval()
    brain.on_stage_start(Stage.VALID, 1)
    with torch.no_grad():
        _, enc = brain.compute_forward(batch, Stage.VALID)
        hyps, _ = brain.searcher(enc, batch["sig_lens"])
    brain._score_hyps(hyps, batch)
    jb = _jax_transducer(tmp_path)
    params, _, _, _ = transducer_jax_state(brain)
    searcher = _jax_searcher(jb, params)
    j_hyps, _ = searcher(jnp.asarray(enc.numpy()),
                         jnp.asarray(batch["sig_lens"].numpy()))
    assert [list(map(int, h)) for h in j_hyps] == hyps
    assert any(hyps)
    jer = JER()
    real = int(batch["batch_mask"].sum())
    jer.append([str(i) for i in range(real)], j_hyps[:real],
               batch["tokens"][:real].numpy().tolist(),
               target_len=batch["tokens_lens"][:real].numpy(),
               ind2lab=parts["label_encoder"].decode_ndim)
    assert brain.wer_metric.summarize("error_rate") == jer.summarize(
        "error_rate")


def _jax_searcher(jb, params):
    """The JAX script's ``_make_searcher(1)`` with its prediction and
    joint networks applied at ``params`` (jitted)."""
    from speechbrain_tpu.decoders.transducer import TransducerBeamSearcher

    m = jb.hparams.modules

    @jax.jit
    def pred(tokens, state):
        emb = m["emb"].apply({"params": params["emb"]}, tokens[:, None])
        out, hx = m["dec"].apply({"params": params["dec"]}, emb,
                                 hx=jnp.swapaxes(state, 0, 1))
        return (m["dec_lin"].apply({"params": params["dec_lin"]}, out[:, 0]),
                jnp.swapaxes(hx, 0, 1))

    @jax.jit
    def start(n_rows):
        emb = m["emb"].apply({"params": params["emb"]}, n_rows)
        out, hx = m["dec"].apply({"params": params["dec"]}, emb)
        return (m["dec_lin"].apply({"params": params["dec_lin"]}, out[:, 0]),
                jnp.swapaxes(hx, 0, 1))

    def pred_step(tokens, state, n):
        if tokens is None:
            return start(jnp.zeros((n, 1), jnp.int32))
        return pred(tokens, state)

    joint = jax.jit(lambda enc, p: m["out_lin"].apply(
        {"params": params["out_lin"]}, jnp.tanh(enc + p)))
    hp = jb.hparams
    return TransducerBeamSearcher(
        decode_fn=pred_step, joint_fn=joint, blank_id=hp.blank_index,
        beam_size=hp.valid_beam_size, state_beam=hp.state_beam,
        expand_beam=hp.expand_beam)


def test_transducer_label_encoder_reads_every_split(tmp_path):
    """A character only the test split holds: the JAX script's encoder,
    read from the train split alone (``transducer/train.py:189-195``),
    raises on it; the port reads train, then dev and test, so the train
    characters keep JAX's indices and the test one follows."""
    data = _corpus(tmp_path, "fr", {"train": 3, "dev": 1, "test": 1},
                   seconds=(0.2, 0.3), seed=5)
    rows = (data / "test.tsv").read_text().splitlines()
    cols = rows[1].split("\t")
    cols[2] = "Zoo quiz kayak!"
    (data / "test.tsv").write_text("\n".join([rows[0], "\t".join(cols)])
                                   + "\n", encoding="utf-8")
    parts = cv.build_transducer(str(data), str(tmp_path / "port"), T_TOY,
                                RUN_OPTS)
    enc = parts["label_encoder"]
    script = load_path("cv_transducer_jax", CV / "ASR/transducer/train.py")
    hp = load_yaml(CV / "ASR/transducer/hparams/train_fr.yaml", T_YAML_TOY,
                   tmp_path)
    os.makedirs(hp["save_folder"], exist_ok=True)
    for split in ("train", "dev", "test"):
        (Path(hp["save_folder"]) / f"{split}.json").write_text(
            (tmp_path / f"port/save/{split}.json").read_text())
    datasets, jenc = script.dataio_prep(hp)
    only_test = set("ZQK") - set(jenc.lab2ind)
    assert only_test and only_test <= set(enc.lab2ind)
    assert all(enc.lab2ind[c] == i for c, i in jenc.lab2ind.items())
    with pytest.raises(KeyError):
        datasets["test"][0]
    assert parts["test_loader"].dataset[0]["tokens"].max() >= len(jenc)


def test_transducer_inventory_past_output_neurons(tmp_path):
    """``output_neurons`` 40 against an inventory of more labels: Flax's
    ``Embed`` gives NaN rows for the ids past its table, which the JAX
    recipe would train on without a word; the port's build raises."""
    from speechbrain_tpu.nnet.embedding import Embedding as JEmbedding

    emb = JEmbedding(num_embeddings=4, embedding_dim=2)
    v = emb.init(jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32))
    rows = np.asarray(emb.apply(v, jnp.array([[1, 5]])))
    assert np.isfinite(rows[0, 0]).all() and np.isnan(rows[0, 1]).all()
    data = _corpus(tmp_path, "fr", {"train": 6, "dev": 1, "test": 1},
                   seconds=(0.2, 0.3))
    with pytest.raises(ValueError, match="past the 12 outputs"):
        cv.build_transducer(str(data), str(tmp_path / "port"),
                            dict(T_TOY, vocab_size=12), RUN_OPTS)


RESUMED = [("seq2seq", name) for name in SEQ2SEQ_YAMLS] + [
    ("transformer", "train_fr.yaml"), ("transducer", "train_fr.yaml")]


@pytest.mark.parametrize("family,name", RESUMED)
def test_run_resumes_bit_for_bit(tmp_path_factory, family, name):
    """Each yaml's dict through its ``build`` on its language's folder: 2
    epochs equal 1 epoch plus a resumed one in a fresh Brain, bit for bit
    (modules, the optimizer's state, the rate); then the test from the
    best checkpoint, its loss and metric finite."""
    if family == "seq2seq":
        hp, toy, build = (cv.SEQ2SEQ_YAMLS[name], S2S_CV_TOY,
                          cv.build_seq2seq)
    elif family == "transformer":
        hp, toy, build = (cv.HPARAMS_TRANSFORMER_FR, CONFORMER_TOY,
                          cv.build_transformer)
    else:
        hp, toy, build = (cv.HPARAMS_TRANSDUCER_FR, T_TOY,
                          cv.build_transducer)
    root = tmp_path_factory.mktemp(f"cv_{family}")
    data = _corpus(root, hp["language"], {"train": 6, "dev": 2, "test": 2},
                   seconds=(0.4, 0.6))

    def make(folder, epochs):
        return build(str(data), str(root / folder),
                     dict(toy, **RESUME, number_of_epochs=epochs), RUN_OPTS,
                     hp)

    full = assert_resume_matches(make)
    metric = "PER" if family == "transducer" else "CER"
    full["brain"].evaluate(full["test_loader"], min_key=metric)
    stats = full["brain"].stage_stats["TEST"]
    assert set(stats) == {"loss", metric} and np.isfinite(stats["loss"])
    log = (root / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 3 and f"valid {metric}" in log[0]
    if family == "transducer":
        assert (root / "full/per.txt").read_text().startswith("%WER")
        ckpt = next((root / "full/save").glob("CKPT*"))
        assert (ckpt / "lr_annealing.ckpt").exists()
        assert not (ckpt / "noam_annealing.ckpt").exists()
