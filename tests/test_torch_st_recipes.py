"""The speech translation recipes on the port against the JAX recipes:
``recipes/taigi_prepare.py``, ``recipes/taigi_st.py`` (``Taigi/ST/
transformer/hparams/transformer.yaml`` and the tokenizer recipe's
``tokenizer_char5k.yaml``) and ``recipes/fisher_st.py`` (``Fisher-
Callhome-Spanish/ST/transformer/hparams/{transformer,conformer}.yaml`` and
``Tokenizer/hparams/train_bpe_1k.yaml``), the JAX scripts taken by path.

Synthetic corpora (``write_synthetic_taigi``: Mandarin translations, a
third of them with spaces; ``write_synthetic_fisher``: Spanish
transcripts with accented letters and English translations) go through
both.  Tolerances:

- the manifests and the tokenizers' model files: byte for byte;
- each yaml against its dict: equal values;
- the training steps (the recipe's first training batch at toy widths,
  f32, through the JAX script's ``ST._loss_fn`` at the port's weights):
  the loss within 1e-5 relative, each gradient within 1e-4 of its
  tensor's largest plus 1e-6 of the largest overall, the conv front end's
  first kernel within 5e-4 of its largest (the frameworks' Fbank features
  differ by up to 2e-3 dB), the front end's biases, which a
  training-mode BatchNorm removes, within 1e-5 of the largest overall
  (``test_torch_transformer_encoder_asr.assert_step_matches``);
- Taigi's search: the hypotheses and the scoring strings equal JAX's;
- the resumed runs: bit for bit.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JSentencePiece,
)
from speechbrain_tpu.utils.bleu import BLEUStats as JBLEUStats
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRate
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes import fisher_st
from speechbrain_tpu_torch.recipes import taigi_prepare as prep
from speechbrain_tpu_torch.recipes import taigi_st

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
TAIGI = REPO / "recipes/Taigi"
FISHER = REPO / "recipes/Fisher-Callhome-Spanish"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
TOY = dict(n_mels=40, frontend_channels=(8, 8), input_size=80, d_model=32,
           nhead=2, num_encoder_layers=1, num_decoder_layers=1, d_ffn=64,
           kernel_size=7, transformer_dropout=0.0, n_warmup_steps=4,
           number_of_epochs=2, batch_size=4, precision="fp32", vocab_size=48,
           valid_search_interval=1, valid_beam_size=3, test_beam_size=2)
FISHER_COUNTS = {"train": 8, "dev": 4, "test": 4}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("st")
    prep.write_synthetic_taigi(str(root / "taigi"), 20, seconds=(1.0, 1.4),
                               n_chars=(3, 8), n_distinct=24, seed=3)
    fisher_st.write_synthetic_fisher(str(root / "fisher"), FISHER_COUNTS,
                                     seconds=(2.0, 2.4), n_words=(2, 4),
                                     seed=4)
    return root


def _yaml_toy(vocab, encoder="transformer", attention="regularMHA",
              branches=""):
    """Overrides that bring an ST yaml to ``TOY``'s widths (the yamls fix
    the front end's channels and the model's input size, so both modules
    are restated)."""
    return f"""
vocab_size: {vocab}
n_mels: 40
precision: fp32
d_model: 32
nhead: 2
num_encoder_layers: 1
num_decoder_layers: 1
d_ffn: 64
transformer_dropout: 0.0
n_warmup_steps: 4
frontend: !new:speechbrain_tpu.lobes.models.convolution.ConvolutionFrontEnd
    num_blocks: 2
    num_layers_per_block: 1
    out_channels: !tuple [8, 8]
    kernel_sizes: !tuple [[3, 3], [3, 3]]
    strides: !tuple [2, 2]
transformer: !new:speechbrain_tpu.lobes.models.transformer.TransformerST.TransformerST
    tgt_vocab: !ref <vocab_size>
    input_size: 80
    d_model: !ref <d_model>
    nhead: !ref <nhead>
    num_encoder_layers: !ref <num_encoder_layers>
    num_decoder_layers: !ref <num_decoder_layers>
    d_ffn: !ref <d_ffn>
    dropout: !ref <transformer_dropout>
    normalize_before: True
    encoder_module: {encoder}
    attention_type: {attention}
    kernel_size: 7
{branches}"""


FISHER_BRANCHES = """    asr_weight: !ref <asr_weight>
    ctc_weight: !ref <ctc_weight>
    asr_tgt_vocab: !ref <vocab_size>
"""
FISHER_YAMLS = {"transformer": (fisher_st.HPARAMS_TRANSFORMER, "transformer",
                                "regularMHA"),
                "conformer": (fisher_st.HPARAMS_CONFORMER, "conformer",
                              "RelPosMHAXL")}


def _st_jax_state(pb):
    """The port's ST Brain's weights as the JAX script's ``(params,
    model_state, extra)``, and the map of its gradients."""
    def grads(sd):
        g = bridge.to_jax_speech_translator(sd)
        return {"frontend": g["frontend"]["params"], **{
            k: v for k, v in g.items() if k not in ("frontend", "norm")}}

    sd = pb.modules.state_dict()
    p = bridge.to_jax_speech_translator(sd)
    return (grads(sd), {"frontend": {"batch_stats":
                                     p["frontend"]["batch_stats"]}},
            {"norm": p["norm"]}, grads)


def _jax_st(script_path, yaml_path, overrides, tmp_path):
    script = load_path(f"st_jax_{script_path.parent.parent.parent.name}",
                       script_path)
    hp = load_yaml(yaml_path, overrides, tmp_path)
    return script.ST(modules=hp["modules"],
                     opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                     hparams=hp, run_opts={"noprogressbar": True})


def _taigi(corpora, tmp_path, overrides=None):
    parts = taigi_st.build(str(corpora / "taigi"), str(tmp_path / "port"),
                           dict(TOY, **(overrides or {})), RUN_OPTS)
    jb = _jax_st(TAIGI / "ST/transformer/train.py",
                 TAIGI / "ST/transformer/hparams/transformer.yaml",
                 _yaml_toy(TOY["vocab_size"]) + "valid_beam_size: 3\n"
                 "test_beam_size: 2\n", tmp_path)
    return parts, jb


def _fisher(name, corpora, tmp_path):
    hp, encoder, attention = FISHER_YAMLS[name]
    parts = fisher_st.build(str(corpora / "fisher"), str(tmp_path / "port"),
                            TOY, RUN_OPTS, hp)
    jb = _jax_st(FISHER / "ST/transformer/train.py",
                 FISHER / f"ST/transformer/hparams/{name}.yaml",
                 _yaml_toy(TOY["vocab_size"], encoder, attention,
                           FISHER_BRANCHES), tmp_path)
    return parts, jb


# ------------------------------------------------------------- prepare


def test_prepare_writes_the_jax_manifests(corpora, tmp_path):
    """``prepare_taigi`` (the yaml's seed, and the tokenizer yaml's)
    writes JAX's manifests byte for byte: the 80/10/10 fallback, the
    untranslated line and the missing WAV left out, the spaces of a
    translation single."""
    jprep = load_path("taigi_prepare_jax", TAIGI / "taigi_prepare.py")
    for seed in (8886, 1234):
        port, jx = tmp_path / f"port{seed}", tmp_path / f"jax{seed}"
        prep.prepare_taigi(str(corpora / "taigi"), str(port), seed=seed)
        jprep.prepare_taigi(str(corpora / "taigi"), str(jx), seed=seed)
        assert_same_files(port, jx)
    rows = {}
    for split in ("train", "dev", "test"):
        rows[split] = json.loads((tmp_path / f"port8886/{split}.json")
                                 .read_text("utf-8"))
    assert [len(r) for r in rows.values()] == [16, 2, 2]
    texts = [r["translation"] for s in rows.values() for r in s.values()]
    assert any(" " in t for t in texts) and not any("  " in t for t in texts)
    assert (prep.TRAIN_SPLIT, prep.DEV_SPLIT, prep.TEST_SPLIT) == (
        jprep.TRAIN_SPLIT, jprep.DEV_SPLIT, jprep.TEST_SPLIT)


def test_prepare_keeps_existing_manifests_and_skips(corpora, tmp_path):
    """Manifests that all exist are kept; ``skip_prep`` writes nothing."""
    prep.prepare_taigi(str(corpora / "taigi"), str(tmp_path / "skip"),
                       skip_prep=True)
    assert not (tmp_path / "skip").exists()
    out = tmp_path / "kept"
    prep.prepare_taigi(str(corpora / "taigi"), str(out))
    (out / "train.json").write_text("{}")
    prep.prepare_taigi(str(corpora / "taigi"), str(out), seed=1)
    assert (out / "train.json").read_text() == "{}"


# --------------------------------------------------------------- yamls


@pytest.mark.parametrize("name", ["taigi", "taigi_tokenizer",
                                  "fisher_transformer", "fisher_conformer",
                                  "fisher_tokenizer"])
def test_yaml_matches_the_dict(name, tmp_path):
    """Each of the five yamls, loaded by JAX's ``load_hyperpyyaml``,
    against its dict: the shared plain values, and the model's fields."""
    paths = {
        "taigi": (TAIGI / "ST/transformer/hparams/transformer.yaml",
                  taigi_st.HPARAMS),
        "taigi_tokenizer": (TAIGI / "Tokenizer/hparams/tokenizer_char5k.yaml",
                            taigi_st.TOKENIZER_CHAR5K),
        "fisher_transformer": (
            FISHER / "ST/transformer/hparams/transformer.yaml",
            fisher_st.HPARAMS_TRANSFORMER),
        "fisher_conformer": (FISHER / "ST/transformer/hparams/conformer.yaml",
                             fisher_st.HPARAMS_CONFORMER),
        "fisher_tokenizer": (
            FISHER / "Tokenizer/hparams/train_bpe_1k.yaml",
            fisher_st.TOKENIZER_BPE_1K),
    }
    path, hp = paths[name]
    y = load_yaml(path, "", tmp_path)
    if name.endswith("tokenizer"):
        assert_yaml_values(y, hp, 4)
        tok = y["tokenizer"].keywords
        for key in ("bos_id", "eos_id"):
            assert tok.get(key, -1) == hp.get(key, -1), key
        return
    assert_yaml_values(y, hp, 18)
    t = y["transformer"]
    assert (t.tgt_vocab, t.input_size, t.d_model, t.nhead,
            t.num_encoder_layers, t.num_decoder_layers, t.d_ffn, t.dropout,
            t.activation, t.normalize_before, t.encoder_module,
            t.attention_type, t.kernel_size, t.ctc_weight, t.asr_weight,
            t.mt_weight) == (
        hp["vocab_size"], hp["input_size"], hp["d_model"], hp["nhead"],
        hp["num_encoder_layers"], hp["num_decoder_layers"], hp["d_ffn"],
        hp["transformer_dropout"], hp["activation"], hp["normalize_before"],
        hp["encoder_module"], hp["attention_type"], hp["kernel_size"],
        hp["ctc_weight"], hp["asr_weight"], hp["mt_weight"])
    stft, fbanks = y["compute_features"].compute_STFT, y[
        "compute_features"].compute_fbanks
    ms = hp["sample_rate"] // 1000  # samples a millisecond
    assert (fbanks.n_mels, stft.hop_length, stft.win_length, stft.n_fft) == (
        hp["n_mels"], ms * hp["hop_length"], ms * hp["win_length"],
        hp["n_fft"])
    fe = y["frontend"]
    assert (fe.num_blocks, tuple(fe.out_channels), tuple(fe.strides)) == (
        hp["frontend_blocks"], hp["frontend_channels"],
        hp["frontend_strides"])
    assert y["normalize"].update_until_epoch == hp["update_until_epoch"]
    assert (y["noam_annealing"].lr_initial,
            y["noam_annealing"].n_warmup_steps) == (hp["lr_adam"],
                                                    hp["n_warmup_steps"])
    heads = {k for k in ("ctc_lin", "asr_lin") if k in y["modules"]}
    assert heads == ({"ctc_lin", "asr_lin"} if name.startswith("fisher")
                     else set())
    assert y.get("grad_accumulation_factor", 1) == hp[
        "grad_accumulation_factor"]
    assert y.get("max_grad_norm", 5.0) == hp["max_grad_norm"]


# ----------------------------------------------------------- tokenizers


def test_taigi_tokenizer_recipe_writes_the_jax_model(corpora, tmp_path):
    """``taigi_st.train_tokenizer`` against ``Taigi/Tokenizer/train.py``
    with its yaml (the preparation at seed 1234, then the yaml's
    ``tokenizer``), at the yaml's 5000 pieces: the manifests and the model
    file byte for byte (the small corpus holds fewer pieces; both
    tokenizers stop at the same ones)."""
    data = corpora / "taigi"
    tok = taigi_st.train_tokenizer(str(data), str(tmp_path / "port"))
    y = load_yaml(TAIGI / "Tokenizer/hparams/tokenizer_char5k.yaml", "",
                  tmp_path)
    jprep = load_path("taigi_prepare_jax", TAIGI / "taigi_prepare.py")
    jprep.prepare_taigi(str(data), y["save_folder"], seed=y["seed"])
    y["tokenizer"]()
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert_same_files(tmp_path / "port/manifests",
                      tmp_path / "jax/manifests")
    assert 24 < tok.sp.get_piece_size() <= 5000


def test_fisher_tokenizer_recipe_writes_the_jax_model(corpora, tmp_path):
    """``fisher_st.train_tokenizer`` against ``Tokenizer/train.py``'s yaml
    on the same manifests: the BPE model file byte for byte."""
    data = corpora / "fisher"
    fisher_st.train_tokenizer(str(data), str(tmp_path / "port"),
                              overrides={"token_output": 120})
    with open(FISHER / "Tokenizer/hparams/train_bpe_1k.yaml") as f:
        y = load_hyperpyyaml(f, f"token_output: 120\ndata_folder: {data}\n"
                             f"output_folder: {tmp_path / 'jax'}\n")
    y["tokenizer"]()
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_taigi_two_tokenizers(corpora, tmp_path):
    """JAX property: the ST script trains its own unigram tokenizer (on
    the seed-8886 split, coverage 0.995, no bos or eos) beside the
    tokenizer recipe's (seed 1234, coverage 1.0, bos_id 1, eos_id 2, which
    the repo's tokenizer takes and does not use): the ST yaml's bos 1 and
    eos 2 are ordinary unigram pieces.  The port copies both, and the ST
    model equals the one JAX's tokenizer trains on the same manifest."""
    parts = taigi_st.build(str(corpora / "taigi"), str(tmp_path / "st"), TOY,
                           RUN_OPTS)
    sp = parts["tokenizer"].sp
    pieces = [sp.id_to_piece(i) for i in (0, 1, 2)]
    assert pieces[0] == "<unk>" and not any(
        p in ("<s>", "</s>") for p in pieces[1:])
    hp = parts["hparams"]
    JSentencePiece(model_dir=str(tmp_path / "jax"), vocab_size=TOY[
        "vocab_size"], annotation_train=hp["train_json"],
        annotation_read="translation", model_type="unigram",
        annotation_format="json", character_coverage=0.995)
    assert (tmp_path / "jax/48_unigram.model.json").read_bytes() == (
        tmp_path / "st/save/48_unigram.model.json").read_bytes()
    tok = taigi_st.train_tokenizer(str(corpora / "taigi"),
                                   str(tmp_path / "tok"),
                                   overrides={"token_output": 48})
    assert (tmp_path / "tok/48_unigram.model.json").read_bytes() != (
        tmp_path / "st/save/48_unigram.model.json").read_bytes()
    assert tok.sp.id_to_piece(1) not in ("<s>", "</s>")


def test_fisher_one_tokenizer_for_two_languages(corpora, tmp_path):
    """JAX property: the tokenizer is trained on the English
    ``translation_0`` only (``train.py:224``) and encodes the Spanish
    transcripts too (l.185): a Spanish letter that no English word has
    (an accented one) becomes ``<unk>``, id 0, which is also the blank
    and the pad.  The port copies this."""
    parts = fisher_st.build(str(corpora / "fisher"), str(tmp_path / "port"),
                            TOY, RUN_OPTS)
    tok = parts["tokenizer"]
    rows = json.loads((corpora / "fisher/train.json").read_text("utf-8"))
    src = next(r["transcription"] for r in rows.values()
               if any(c in r["transcription"] for c in "áéíóúñ"))
    ids = tok.sp.encode_as_ids(src)
    assert 0 in ids
    item = next(iter(parts["train_loader"])).numeric_dict()
    assert item["src_tokens"].shape[0] == TOY["batch_size"]
    jtok = JSentencePiece(model_dir=str(tmp_path / "port/save"),
                          vocab_size=TOY["vocab_size"], model_type="bpe")
    assert jtok.sp.encode_as_ids(src) == ids


# ---------------------------------------------------------------- steps


def test_taigi_step_matches_jax(corpora, tmp_path):
    """The Taigi step (the translation's KL only) against the JAX
    script's ``ST``."""
    parts, jb = _taigi(corpora, tmp_path)
    params, model_state, extra, grads = _st_jax_state(parts["brain"])
    assert set(params) == {"frontend", "transformer", "seq_lin"}
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


@pytest.mark.parametrize("name", list(FISHER_YAMLS))
def test_fisher_step_matches_jax(corpora, tmp_path, name):
    """The Fisher step (0.7 KL of the translation, 0.09 CTC and 0.21 KL of
    the transcript over the ASR decoder) against the JAX script's ``ST``,
    with either encoder; under RelPosMHAXL the CTC head and the ASR
    decoder read the encoder states with the decoder's PE added, as
    ``forward`` returns them."""
    parts, jb = _fisher(name, corpora, tmp_path)
    params, model_state, extra, grads = _st_jax_state(parts["brain"])
    assert set(params) == {"frontend", "transformer", "seq_lin", "ctc_lin",
                           "asr_lin"}
    assert set(params["transformer"]) == {"st", "asr_decoder",
                                          "custom_asr_tgt_module"}
    batch = next(iter(parts["train_loader"]))
    loss = assert_step_matches(parts["brain"], jb, batch, params,
                               model_state, extra, grads)
    assert np.isfinite(loss) and loss < 1e3  # every CTC path feasible


# -------------------------------------------------------------- scoring


def _jax_valid(jb, parts, params, model_state, extra, batch):
    """The JAX script's VALID ``compute_forward`` and
    ``compute_objectives`` on ``batch`` at the port's weights, its
    tokenizer the port's model file."""
    from speechbrain_tpu.core import Stage as JStage

    jbatch = _jax_batch(batch.numeric_dict())
    state = jax.tree_util.tree_map(np.asarray, (params, model_state, extra))
    jb.train_state = {"params": state[0], "model_state": state[1],
                      "extra": state[2]}
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))
    jb.tokenizer = JSentencePiece(
        model_dir=parts["hparams"]["save_folder"],
        vocab_size=parts["hparams"]["vocab_size"],
        model_type=parts["hparams"]["token_type"])
    def forward(state, jbatch):
        jb._bind(*state, rngs, train=False)
        return jb.compute_forward(jbatch, JStage.VALID)

    jb.on_stage_start(JStage.VALID)
    preds = jax.jit(forward)(state, jbatch)
    jb._bind(*state, rngs, train=False)
    jb.compute_objectives(preds, jbatch, JStage.VALID)
    return jbatch


def test_taigi_search_and_strings_match_jax(corpora, tmp_path):
    """The validation search on one batch at the same weights: the
    port's hypotheses (the KV-cached decoder) equal those of the JAX
    script's jitted ``search_device`` (the prefix-buffer decoder, run to
    its last step), and the strings the port scores equal the JAX
    script's, spaces and all, on a batch whose references hold spaces."""
    parts, jb = _taigi(corpora, tmp_path)
    pb = parts["brain"]
    params, model_state, extra, _ = _st_jax_state(pb)
    hp = parts["hparams"]
    batch = next(b for b in parts["valid_loader"]
                 if any(" " in r["translation"] for r in json.loads(
                     Path(hp["valid_json"]).read_text("utf-8")).values()))
    tb = pb.prepare_batch(batch)
    pb.modules.eval()
    pb.on_stage_start(Stage.VALID, 1)
    hyps = pb.search(tb, Stage.VALID)
    predicted, targets = pb.scoring_strings(hyps, tb)
    jbatch = _jax_valid(jb, parts, params, model_state, extra, batch)
    j_hyps, _ = jb._beam_search(jbatch)
    assert hyps == [list(map(int, h)) for h in j_hyps][:len(hyps)]
    assert any(len(h) > 1 for h in hyps)
    assert predicted == jb.bleu_metric.predicts
    assert [targets] == jb.bleu_metric.targets
    assert any(t.count(" ") >= 2 for t in targets)
    # the port's search stops once every item holds its beam's finished
    # hypotheses; run to its last step, as JAX's, it stores the same
    real = len(hyps)
    lens = tb["sig_lens"][:real]
    enc = pb.model.encode(tb["sig"][:real], lens, torch.float32)
    searcher = pb.model.make_searcher(TOY["valid_beam_size"])
    early = searcher.search_device(enc, lens)
    full = searcher.search_device(enc, lens, early_exit=False)
    assert all(torch.equal(a, b) for a, b in zip(early, full))


def test_taigi_scores_characters_without_spaces():
    """The port scores the JAX script's strings over their characters
    without the spaces, each hypothesis against its own reference; JAX's
    metrics count the spaces as tokens and its BLEU holds the batch's
    first hypothesis to all references and the others to none (the JAX
    differences of ROADMAP Queue 3)."""
    predicted = taigi_st.char_strings([["我們", "走"], ["你好"], ["好"]])
    targets = taigi_st.char_strings([["我們", "走", "吧"], ["你", "好"],
                                     ["不"]])
    assert predicted == ["我 們 走", "你 好", "好"]
    brain = taigi_st.ST.__new__(taigi_st.ST)
    brain.on_stage_start(Stage.VALID, 1)
    ids = ["0", "1", "2"]
    pred_chars = [p.split() for p in predicted]
    ref_chars = [t.split() for t in targets]
    brain.bleu_metric.append(ids, pred_chars, [[r] for r in ref_chars])
    brain.cer_metric.append(ids, pred_chars, ref_chars)
    jbleu, jcer = JBLEUStats(), JErrorRate()
    jbleu.append(ids, predicted, [targets])  # train.py:101-102
    jcer.append(ids, predicted, targets)
    # 1 deletion in 4 characters, 0 in 2, 1 substitution in 1: CER 2/7
    assert brain.cer_metric.summarize("error_rate") == pytest.approx(
        100 * 2 / 7)
    # JAX's strings: 7 + 3 + 1 tokens, the spaces counted (the first
    # hypothesis misses a space and a character)
    assert jcer.summarize("error_rate") == pytest.approx(100 * 3 / 11)
    assert len(jbleu.targets) == 1
    assert brain.bleu_metric.summarize("hyp_len") == 6
    assert jbleu.summarize("hyp_len") == len(predicted[0])


def test_fisher_bleu_reads_past_the_end(corpora, tmp_path):
    """JAX property: the BLEU hypotheses are the argmax of the
    teacher-forced translation head over the whole padded row, past the
    eos and past the reference's length (``train.py:110-123``).  The port
    copies the hypotheses (equal to JAX's on one validation batch) and
    holds each to its own reference."""
    parts, jb = _fisher("transformer", corpora, tmp_path)
    pb = parts["brain"]
    params, model_state, extra, _ = _st_jax_state(pb)
    batch = next(iter(parts["valid_loader"]))
    tb = pb.prepare_batch(batch)
    pb.modules.eval()
    pb.on_stage_start(Stage.VALID, 1)
    with torch.no_grad():
        st_logp = pb.compute_forward(tb, Stage.VALID)[0]
        hyps, refs = pb.argmax_words(st_logp, tb)
    _jax_valid(jb, parts, params, model_state, extra, batch)
    assert hyps == jb.bleu_metric.predicts
    assert [refs] == jb.bleu_metric.targets
    width = st_logp.shape[1]
    ids = st_logp.argmax(-1)[0].tolist()
    assert len(ids) == width > int(round(float(tb["trans_tokens_lens"][-1])
                                         * (width - 1)))


def test_taigi_test_search_uses_the_test_beam(corpora, tmp_path,
                                              monkeypatch):
    """JAX property: the script sets ``valid_beam_size = test_beam_size``
    after ``fit`` (l.302), but its searcher, built on first use, keeps the
    beam it was built with.  The port searches TEST at
    ``test_beam_size`` and VALID at ``valid_beam_size``."""
    parts, jb = _taigi(corpora, tmp_path)
    jb._searcher = jb._make_searcher()
    jb.hparams.valid_beam_size = jb.hparams.test_beam_size
    assert (jb._searcher.beam_size, jb.hparams.test_beam_size) == (3, 2)
    pb = parts["brain"]
    beams = []
    translate = pb.model.translate

    def spy(*args, beam_size, **kw):
        beams.append(beam_size)
        return translate(*args, beam_size=beam_size, **kw)

    monkeypatch.setattr(pb.model, "translate", spy)
    tb = pb.prepare_batch(next(iter(parts["test_loader"])))
    pb.search(tb, Stage.VALID)
    pb.search(tb, Stage.TEST)
    assert beams == [3, 2]


# -------------------------------------------------------------- resumes


@pytest.mark.parametrize("name", ["taigi", "fisher_transformer",
                                  "fisher_conformer"])
def test_run_resumes_bit_for_bit(corpora, tmp_path, name):
    """2 epochs (validation BLEU each epoch, the best kept) equal 1 epoch
    plus a resumed one in a fresh Brain, bit for bit; then the test from
    the best checkpoint (Taigi: its BLEU and CER files)."""
    if name == "taigi":
        recipe, data, hp = taigi_st, corpora / "taigi", taigi_st.HPARAMS
    else:
        recipe, data = fisher_st, corpora / "fisher"
        hp = FISHER_YAMLS[name.split("_")[1]][0]

    def build(folder, epochs):
        return recipe.build(str(data), str(tmp_path / folder),
                            dict(TOY, **RESUME, number_of_epochs=epochs),
                            RUN_OPTS, hp)

    full = assert_resume_matches(build)
    brain = full["brain"]
    brain.evaluate(full["test_loader"], max_key="BLEU")
    stats = brain.stage_stats["TEST"]
    want = {"loss", "BLEU", "CER"} if name == "taigi" else {"loss", "BLEU"}
    assert set(stats) == want and all(np.isfinite(list(stats.values())))
    log = (tmp_path / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 3 and "valid BLEU" in log[0]
    if name == "taigi":
        assert (tmp_path / "full/bleu.txt").read_text().startswith("BLEU: ")
        assert "%WER" in (tmp_path / "full/cer.txt").read_text()
