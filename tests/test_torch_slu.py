"""The spoken language understanding recipes on the port against the JAX
recipes: ``recipes/fsc_prepare.py``, ``recipes/slurp_prepare.py``,
``recipes/slu_direct.py`` (the ``direct`` scripts of Fluent Speech
Commands, SLURP and Timers and Such, and the three ``Tokenizer``
scripts) and ``recipes/slu_nlu.py`` (``SLURP/NLU`` and Timers and Such's
``decoupled`` and ``multistage``), the JAX scripts taken by path, on
synthetic corpora in each one's layout.

Tolerances:

- the manifests and the tokenizers' model files: byte for byte;
- the training steps (each recipe's first training batch at toy widths,
  f32, through the JAX scripts' ``_loss_fn`` at the port's weights): the
  loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
  largest plus 1e-6 of the largest overall (the first convolution of each
  CNN block within 5e-4; the biases before a training-mode BatchNorm within
  1e-5 of the largest overall), as ``tests/test_torch_aishell.py`` holds
  the CRDNN seq2seq steps (``assert_step_matches``);
- the validation stage's greedy search: the same hypotheses and the same
  exact matches as the JAX Brain's ``S2SRNNGreedySearcher``;
- a resumed run: bit for bit.
"""

import json
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes import fsc_prepare, slurp_prepare
from speechbrain_tpu_torch.recipes import slu_direct as direct
from speechbrain_tpu_torch.recipes import slu_nlu as nlu
from speechbrain_tpu_torch.recipes import timers_and_such_prepare as tas

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_transformer_encoder_asr import (
    RESUME,
    _jax_batch,
    assert_resume_matches,
    assert_same_files,
    assert_step_matches,
    assert_yaml_values,
    load_path,
    load_yaml,
)

REPO = Path(__file__).resolve().parents[1]
RECIPES = REPO / "recipes"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
DIRECT_TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8,
                  dnn_neurons=8, emb_size=8, dec_neurons=16, attn_dim=12,
                  n_mels=20, dropout=0.0, batch_size=4, number_of_epochs=2)
DIRECT_YAML_TOY = """
n_mels: 20
dec_neurons: 16
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
    num_embeddings: !ref <output_neurons>
    embedding_dim: 8
dec: !new:speechbrain_tpu.nnet.RNN.AttentionalRNNDecoder
    rnn_type: gru
    attn_type: content
    hidden_size: 16
    attn_dim: 12
    num_layers: 1
    dropout: 0.0
"""
NLU_TOY = dict(emb_size=8, enc_neurons=8, dec_neurons=16, attn_dim=12,
               dropout=0.0, precision="fp32", batch_size=4,
               number_of_epochs=2)
NLU_YAML_TOY = """
precision: fp32
emb_size: 8
enc_neurons: 8
dec_neurons: 16
dec: !new:speechbrain_tpu.nnet.RNN.AttentionalRNNDecoder
    rnn_type: gru
    attn_type: keyvalue
    hidden_size: !ref <dec_neurons>
    attn_dim: 12
    num_layers: 1
    dropout: 0.0
"""
# each recipe: its dict, the JAX script and yaml under recipes/, the JAX
# Brain's class
DIRECT = {
    "fsc": (direct.HPARAMS_FSC, "fluent-speech-commands/direct"),
    "slurp": (direct.HPARAMS_SLURP, "SLURP/direct"),
    "tas": (direct.HPARAMS_TAS, "timers-and-such/direct"),
}
NLU = {
    "slurp": (nlu.HPARAMS_SLURP_NLU, "SLURP/NLU", "NLU"),
    "decoupled": (nlu.HPARAMS_TAS_DECOUPLED, "timers-and-such/decoupled",
                  "SLU"),
    "multistage": (nlu.HPARAMS_TAS_MULTISTAGE, "timers-and-such/multistage",
                   "SLU"),
}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("slu")
    fsc_prepare.write_synthetic_fsc(str(root / "fsc"),
                                    {"train": 8, "valid": 4, "test": 4},
                                    seconds=(0.6, 0.9), seed=1)
    slurp_prepare.write_synthetic_slurp(
        str(root / "slurp"), {"train": 6, "devel": 2, "test": 2,
                              "train_synthetic": 2},
        seconds=(0.6, 0.9), seed=2)
    tas.write_synthetic_tas(str(root / "tas"),
                            {"train-synth": 4, "train-real": 4,
                             "dev-real": 4, "test-real": 4},
                            seconds=(0.6, 0.9), seed=3)
    return root


def _jax_prepare(corpus):
    return load_path(f"{corpus}_prepare_jax", RECIPES / {
        "fsc": "fluent-speech-commands", "slurp": "SLURP",
        "tas": "timers-and-such"}[corpus] / "prepare.py")


def test_fsc_prepare_writes_the_jax_manifests(corpora, tmp_path):
    """``prepare_FSC`` against the JAX script: the three manifests byte for
    byte, the semantics string with the colon inside its first quote
    (``prepare.py:38-41``) kept."""
    fsc_prepare.prepare_FSC(str(corpora / "fsc"), str(tmp_path / "port"))
    _jax_prepare("fsc").prepare_FSC(str(corpora / "fsc"),
                                    str(tmp_path / "jax"))
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    rows = json.loads((tmp_path / "port/train.json").read_text())
    assert len(rows) == 8 and all(r["semantics"].startswith("{'action:' '")
                                  for r in rows.values())


@pytest.mark.parametrize("splits", [("train",), ("train", "train_synthetic")])
def test_slurp_prepare_writes_the_jax_manifests(corpora, tmp_path, splits):
    """``prepare_SLURP`` against the JAX script with its default
    ``train_splits`` and with the synthetic split merged: the three
    manifests byte for byte (16 kHz recordings)."""
    prep = _jax_prepare("slurp")
    slurp_prepare.prepare_SLURP(str(corpora / "slurp"),
                                str(tmp_path / "port"), train_splits=splits)
    prep.prepare_SLURP(str(corpora / "slurp"), str(tmp_path / "jax"),
                       train_splits=splits)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    rows = json.loads((tmp_path / "port/train.json").read_text())
    synth = [r for r in rows.values() if "slurp_synth" in r["wav"]]
    assert bool(synth) == ("train_synthetic" in splits)


def test_slurp_default_splits_leave_the_synthetic_out():
    """``prepare_SLURP``'s default ``train_splits`` is ``("train",)`` in
    both packages, and neither SLURP script passes any, so their training
    reads no ``train_synthetic``; the tokenizer yaml does merge it."""
    import inspect

    for fn in (slurp_prepare.prepare_SLURP,
               _jax_prepare("slurp").prepare_SLURP):
        assert inspect.signature(fn).parameters[
            "train_splits"].default == ("train",)
    for script in ("direct/train.py", "NLU/train.py"):
        text = (RECIPES / "SLURP" / script).read_text()
        assert "prepare_SLURP," in text and "train_splits" not in text
    assert "train_synthetic" in (
        RECIPES / "SLURP/Tokenizer/hparams/tokenizer_bpe58.yaml").read_text()


def test_parse_entities_matches_jax():
    jprep = _jax_prepare("slurp")
    for text in ("wake me at [time : five am] [date : today]",
                 "no entity here", "[broken no colon] and [a : b : c]",
                 "[ place_name :  new  york ]"):
        assert slurp_prepare.parse_entities(text) == jprep.parse_entities(
            text)


def test_slurp_durations_follow_the_file_rate(tmp_path):
    """A 48 kHz recording of 1 s: JAX divides its samples by 16000
    (``prepare.py:80-82``) and writes 3.0 s; the port writes 1.0."""
    data = tmp_path / "slurp"
    slurp_prepare.write_synthetic_slurp(str(data), {"train": 1, "devel": 1,
                                                    "test": 1},
                                        seconds=(0.2, 0.3), recordings=(1, 1))
    line = json.loads((data / "train.jsonl").read_text())
    name = line["recordings"][0]["file"]
    pcm = np.zeros(48000, "<i2")
    with wave.open(str(data / "slurp_real" / name), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(48000)
        w.writeframes(pcm.tobytes())
    slurp_prepare.prepare_SLURP(str(data), str(tmp_path / "port"))
    _jax_prepare("slurp").prepare_SLURP(str(data), str(tmp_path / "jax"))
    key = name[:-4]
    port = json.loads((tmp_path / "port/train.json").read_text())[key]
    jrow = json.loads((tmp_path / "jax/train.json").read_text())[key]
    assert (port["duration"], jrow["duration"]) == (1.0, 3.0)


@pytest.mark.parametrize("name", list(DIRECT))
def test_direct_yamls_match_the_dicts(name, tmp_path):
    hp, folder = DIRECT[name]
    y = load_yaml(RECIPES / folder / "hparams/train.yaml", "", tmp_path)
    assert_yaml_values(y, hp, 20)
    assert y["output_neurons"] == hp["vocab_size"] == 58
    dec = y["dec"]
    assert (dec.attn_type, dec.attn_dim, dec.hidden_size, dec.dropout) == (
        hp["attn_type"], hp["attn_dim"], hp["dec_neurons"], hp["dropout"])
    assert y["enc"].rnn_class == "lstm" and "lr_annealing" not in y
    assert ("max_decode_ratio" in y) == hp["search"]
    differ = {k for k in set(hp) | set(direct.HPARAMS_FSC)
              if hp.get(k) != direct.HPARAMS_FSC.get(k)}
    assert differ == {"fsc": set(), "slurp": {"corpus", "search",
                                              "max_decode_ratio"},
                      "tas": {"corpus", "train_splits"}}[name]


@pytest.mark.parametrize("path", sorted(nlu.YAMLS))
def test_nlu_yamls_match_the_dicts(path, tmp_path):
    """The seven NLU yamls against their dicts; the six Timers and Such
    yamls differ in their comments and output folders alone."""
    hp = nlu.YAMLS[path]
    y = load_yaml(RECIPES / path, "", tmp_path)
    assert_yaml_values(y, hp, 12)
    assert y["output_neurons"] == hp["vocab_size"]
    dec, enc = y["dec"], y["slu_enc"]
    assert (dec.attn_type, dec.attn_dim, dec.dropout) == (
        "keyvalue", hp["attn_dim"], hp["dropout"])
    assert (enc.hidden_size, enc.num_layers, enc.bidirectional) == (
        hp["enc_neurons"], hp["enc_layers"], True)
    assert ("lr_annealing" in y) == hp["newbob"]
    assert y.get("asr_source") is None
    if path.startswith("timers"):
        base = (RECIPES / "timers-and-such/decoupled/hparams/train.yaml")
        lines = [line for line in (RECIPES / path).read_text().splitlines()
                 if not line.startswith("#") and "output_folder" not in line]
        want = [line for line in base.read_text().splitlines()
                if not line.startswith("#") and "output_folder" not in line]
        assert lines == want


@pytest.mark.parametrize("corpus", ["fsc", "slurp", "tas"])
def test_tokenizer_recipes_write_the_jax_model(corpora, tmp_path, corpus):
    """``train_tokenizer`` against each ``Tokenizer/train.py`` with its
    yaml (the script's ``__main__``: the preparation, then the yaml's
    ``tokenizer``): the same model file, byte for byte."""
    hp = {"fsc": direct.TOKENIZER_FSC, "slurp": direct.TOKENIZER_SLURP,
          "tas": direct.TOKENIZER_TAS}[corpus]
    folder = {"fsc": "fluent-speech-commands", "slurp": "SLURP",
              "tas": "timers-and-such"}[corpus]
    yaml = next((RECIPES / folder / "Tokenizer/hparams").glob("*.yaml"))
    data = corpora / corpus
    tok = direct.train_tokenizer(str(data), str(tmp_path / "port"), hp)
    with open(yaml) as f:
        from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml

        y = load_hyperpyyaml(f, f"data_folder: {data}\n"
                             f"output_folder: {tmp_path / 'jax'}\n")
    assert (y["token_output"], y["token_type"], y.get("train_splits")) == (
        hp["token_output"], hp["token_type"], hp.get("train_splits"))
    kwargs = {"data_folder": y["data_folder"], "save_folder": y["save_folder"]}
    if "train_splits" in y:
        kwargs["train_splits"] = y["train_splits"]
    _jax_prepare(corpus).__dict__[
        {"fsc": "prepare_FSC", "slurp": "prepare_SLURP",
         "tas": "prepare_TAS"}[corpus]](**kwargs)
    y["tokenizer"]()
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert_same_files(tmp_path / "port/manifests", tmp_path / "jax/manifests")
    assert tok.sp.get_piece_size() == hp["token_output"]


def test_bos_and_eos_are_semantics_pieces(corpora, tmp_path):
    """The yamls' ``bos_index`` 1 and ``eos_index`` 2 index the semantics
    tokenizer's pieces: with the BPE of the direct recipes, the two lowest
    characters of the semantics strings (``'`` and ``:`` for FSC and
    SLURP, ``'`` and a digit for Timers and Such), so a target holds
    "eos" wherever its BPE leaves a lone piece there; with the unigram of
    the NLU recipes, two word pieces.  The port copies this."""
    pieces = {}
    for name, (hp, _) in DIRECT.items():
        parts = direct.build(str(corpora / name), str(tmp_path / name),
                             DIRECT_TOY, RUN_OPTS, hp)
        sp = parts["tokenizer"].sp
        pieces[name] = (sp.id_to_piece(1), sp.id_to_piece(2))
        assert (parts["hparams"]["bos_index"],
                parts["hparams"]["eos_index"]) == (1, 2)
    assert pieces == {"fsc": ("'", ":"), "slurp": ("'", ":"),
                      "tas": ("'", "1")}
    parts = nlu.build(str(corpora / "slurp"), str(tmp_path / "nlu"), NLU_TOY,
                      RUN_OPTS)
    sp = parts["tokenizers"][1].sp
    assert (sp.id_to_piece(1), sp.id_to_piece(2)) == ("▁'", "'|")


def _direct_jax_state(pb):
    """The port's direct Brain's weights as the JAX script's ``(params,
    model_state, extra)``, and the map of its gradients."""
    def pieces(sd):
        s = bridge._Sub(sd)
        return {"enc": bridge.to_jax_crdnn(sd, "enc."),
                "emb": {"Embed_0": {"embedding": bridge._a(s["emb.weight"])}},
                "dec": bridge.to_jax_attentional_rnn_decoder(sd, "dec."),
                "seq_lin": {"Dense_0": bridge._dense_to_jax(s.sub("seq_lin"))},
                "norm": {k: bridge._a(s[f"normalize.{k}"])
                         for k in ("count", "mean", "std")}}

    def grads(sd):
        g = pieces(sd)
        return {"enc": g["enc"]["params"],
                **{k: g[k] for k in ("emb", "dec", "seq_lin")}}

    p = pieces(pb.modules.state_dict())
    return (grads(pb.modules.state_dict()),
            {"enc": {"batch_stats": p["enc"]["batch_stats"]}},
            {"norm": p["norm"]}, grads)


def _nlu_jax_state(pb):
    def grads(sd):
        s = bridge._Sub(sd)
        return {"input_emb": {"Embed_0": {"embedding": bridge._a(
                    s["input_emb.weight"])}},
                "slu_enc": bridge.to_jax_gru(sd, "slu_enc."),
                "output_emb": {"Embed_0": {"embedding": bridge._a(
                    s["output_emb.weight"])}},
                "dec": bridge.to_jax_attentional_rnn_decoder(sd, "dec."),
                "seq_lin": {"Dense_0": bridge._dense_to_jax(
                    s.sub("seq_lin"))}}

    return grads(pb.modules.state_dict()), {}, {}, grads


def _jax_brain(folder, cls, overrides, tmp_path):
    script = load_path(f"slu_{cls}_{folder.replace('/', '_')}",
                       RECIPES / folder / "train.py")
    hp = load_yaml(RECIPES / folder / "hparams/train.yaml", overrides,
                   tmp_path)
    return getattr(script, cls)(
        modules=hp["modules"],
        opt_class=lambda lr: hp["opt_class"](learning_rate=lr), hparams=hp,
        run_opts={"noprogressbar": True})


def _parts(kind, name, corpora, tmp_path, overrides=None):
    if kind == "direct":
        hp, folder = DIRECT[name]
        parts = direct.build(str(corpora / name), str(tmp_path / "port"),
                             dict(DIRECT_TOY, **(overrides or {})), RUN_OPTS,
                             hp)
        jb = _jax_brain(folder, "SLU", DIRECT_YAML_TOY, tmp_path)
        return parts, jb, _direct_jax_state(parts["brain"])
    hp, folder, cls = NLU[name]
    corpus = "slurp" if name == "slurp" else "tas"
    parts = nlu.build(str(corpora / corpus), str(tmp_path / "port"),
                      dict(NLU_TOY, **(overrides or {})), RUN_OPTS, hp)
    jb = _jax_brain(folder, cls, NLU_YAML_TOY, tmp_path)
    return parts, jb, _nlu_jax_state(parts["brain"])


STEPS = [("direct", "fsc"), ("direct", "slurp"), ("nlu", "slurp"),
         ("nlu", "decoupled")]


@pytest.mark.parametrize("kind,name", STEPS)
def test_step_matches_jax(corpora, tmp_path, kind, name):
    """Each distinct JAX script's training step (FSC's and Timers and
    Such's direct scripts are one code; so are decoupled's and
    multistage's without an ASR): the NLL of the semantics' pieces."""
    parts, jb, (params, model_state, extra, grads) = _parts(
        kind, name, corpora, tmp_path)
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


@pytest.mark.parametrize("kind,name", [("direct", "fsc"), ("nlu", "slurp")])
def test_greedy_search_matches_jax(corpora, tmp_path, kind, name):
    """The validation stage on one batch at the same weights: the greedy
    search's hypotheses and the exact matches of the port equal the JAX
    Brain's (its ``compute_objectives`` at VALID, which runs its
    ``S2SRNNGreedySearcher``)."""
    parts, jb, (params, model_state, extra, _) = _parts(
        kind, name, corpora, tmp_path)
    pb = parts["brain"]
    batch = next(iter(parts["valid_loader"]))
    tb = pb.prepare_batch(batch)
    pb.modules.eval()
    pb.on_stage_start(Stage.VALID, 1)
    with torch.no_grad():
        preds = pb.compute_forward(tb, Stage.VALID)
        pb.compute_objectives(preds, tb, Stage.VALID)
        hyps, _ = pb.searcher(preds[1], preds[2])
    jbatch = _jax_batch(batch.numeric_dict())
    state = jax.tree_util.tree_map(np.asarray, (params, model_state, extra))
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

    def forward(state, jbatch):
        jb._bind(*state, rngs, train=False)
        return jb.compute_forward(jbatch, JStage.VALID)

    jb.on_stage_start(JStage.VALID)
    j_preds = jax.jit(forward)(state, jbatch)
    jb._bind(*state, rngs, train=False)
    jb.compute_objectives(j_preds, jbatch, JStage.VALID)
    lens = (jbatch["sig_lens"] if kind == "direct"
            else jbatch["transcript_tokens_lens"])
    j_hyps, _ = jb._searcher(j_preds[1], lens)
    assert hyps == [list(map(int, h)) for h in j_hyps]
    assert all(hyps) and pb.exact == jb.exact and len(pb.exact) == len(hyps)


@pytest.mark.parametrize("kind,name", [(k, n) for k in ("direct",)
                                       for n in DIRECT] +
                         [("nlu", n) for n in NLU])
def test_run_resumes_bit_for_bit(corpora, tmp_path, kind, name):
    """Each dict through its ``build``: 2 epochs equal 1 epoch plus a
    resumed one in a fresh Brain, bit for bit (modules, Adam's state, the
    rate: the SLURP NLU's NewBob too); then the test from the best
    checkpoint, its loss (and accuracy) finite."""
    if kind == "direct":
        hp, build, corpus, toy = (DIRECT[name][0], direct.build, name,
                                  DIRECT_TOY)
    else:
        hp, build, toy = NLU[name][0], nlu.build, NLU_TOY
        corpus = "slurp" if name == "slurp" else "tas"

    def make(folder, epochs):
        return build(str(corpora / corpus), str(tmp_path / folder),
                     dict(toy, **RESUME, number_of_epochs=epochs), RUN_OPTS,
                     hp)

    full = assert_resume_matches(make)
    brain = direct.fit_and_test(full)
    stats = brain.stage_stats["TEST"]
    assert set(stats) == ({"loss", "acc"} if hp["search"] else {"loss"})
    assert all(np.isfinite(v) for v in stats.values())
    log = (tmp_path / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 3 and "test loss" in log[2]
    if hp.get("newbob"):
        ckpt = next((tmp_path / "full/save").glob("CKPT*"))
        assert (ckpt / "lr_annealing.ckpt").exists()


def test_asr_source_raises(corpora, tmp_path):
    """``asr_source`` names an ASR whose transcripts would feed the NLU:
    the port has no ``EncoderDecoderASR`` yet, so ``build`` refuses it
    rather than reading the gold transcripts."""
    with pytest.raises(NotImplementedError, match="EncoderDecoderASR"):
        nlu.build(str(corpora / "tas"), str(tmp_path / "out"),
                  dict(NLU_TOY, asr_source="asr_bundle"), RUN_OPTS,
                  nlu.HPARAMS_TAS_MULTISTAGE)
    assert not (tmp_path / "out").exists()
