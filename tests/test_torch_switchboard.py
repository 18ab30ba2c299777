"""The Switchboard recipes on the port against the JAX recipes:
``recipes/switchboard_prepare.py`` (``prepare_switchboard``,
``filter_text`` and ``normalize_util``'s functions),
``recipes/switchboard_asr.py`` (``train_BPE_2000.yaml``,
``transformer.yaml``, ``transformer_finetuned_LM.yaml``) and the LMs
(``lm_training.HPARAMS_SWITCHBOARD``/``_FINETUNE``), the JAX scripts
taken by path, on a synthetic corpus (``write_synthetic_switchboard``:
stereo 8 kHz SPHERE conversations, ms98 transcripts, an eval2000 stm).

Tolerances:

- the manifests: byte for byte; ``filter_text`` and the scoring
  normalization: equal, case by case;
- the training steps (the recipes' first training batch at toy widths,
  f32, through the JAX scripts' ``ASR._loss_fn`` at the port's weights;
  the seq2seq script on the port's one-channel batch, since it cannot
  read its own): the loss within 1e-5 relative, each gradient within
  1e-4 of its tensor's largest plus 1e-6 of the largest overall (the
  conv front end's first kernel within 5e-4: its gradient sums the
  features, which differ by up to 2e-3 dB between the frameworks'
  Fbanks; the biases that feed a training-mode BatchNorm (the
  CRDNN's DNN, the conv front end), within 1e-5 of the largest overall); the LM step the same
  against the JAX LM script;
- the normalized WER: equal to JAX's;
- a resumed run: bit for bit.

Each difference from the JAX recipes has a test here: the seq2seq
script's stereo reads, its ``test.json``, its ``sample_rate`` (copied),
and the "finetune" yamls that load no LibriSpeech LM (copied).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from speechbrain_tpu.dataio.dataio import read_audio as j_read_audio
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.processing.features import GlobalNormState
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRate
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.recipes import lm_training
from speechbrain_tpu_torch.recipes import switchboard_asr as recipe
from speechbrain_tpu_torch.recipes import switchboard_prepare as prep
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_kspon import LM_TOY, lm_step_matches
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
SWBD = REPO / "recipes/Switchboard"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
S2S_TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8,
               dnn_blocks=1, dnn_neurons=8, emb_size=8, dec_neurons=16,
               attn_dim=12, vocab_size=40, dropout=0.0, batch_size=4,
               number_of_epochs=2, number_of_ctc_epochs=1, precision="fp32",
               valid_beam_size=2, test_beam_size=2, max_attn_shift=20,
               augmentation=None, dev_conversations=1)
S2S_YAML_TOY = """
vocab_size: 40
dropout: 0.0
precision: fp32
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
TR_TOY = dict(CONFORMER_TOY, dev_conversations=1)
YAMLS = {
    "seq2seq": (recipe.HPARAMS_SEQ2SEQ,
                SWBD / "ASR/seq2seq/hparams/train_BPE_2000.yaml"),
    "transformer": (recipe.HPARAMS_TRANSFORMER,
                    SWBD / "ASR/transformer/hparams/transformer.yaml"),
    "transformer_finetuned_LM": (
        recipe.HPARAMS_TRANSFORMER_FINETUNED_LM,
        SWBD / "ASR/transformer/hparams/transformer_finetuned_LM.yaml"),
    "lm": (lm_training.HPARAMS_SWITCHBOARD,
           SWBD / "LM/hparams/transformer.yaml"),
    "lm_finetune": (lm_training.HPARAMS_SWITCHBOARD_FINETUNE,
                    SWBD / "LM/hparams/transformer_finetune.yaml"),
}


def _jax_prepare():
    return load_path("swbd_prepare_jax", SWBD / "switchboard_prepare.py")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("swbd") / "Switchboard"
    prep.write_synthetic_switchboard(str(data), conversations=4, turns=3,
                                     eval_segments=3, seconds=(1.0, 1.4),
                                     n_words=(2, 4), lexicon_size=12, seed=3)
    return data


@pytest.mark.parametrize("text,dataset,want", [
    ("[laughter-yes] them_1 [silence] th[e]- {breath} okay", "train",
     "YES THEM TH- OKAY"),
    ("[vocalized-noise] uh-huh -[a]bout it", "train",
     "[NOISE] UH-HUH -BOUT IT"),
    ("[noise]", "train", ""),
    ("[laughter]", "train", ""),
    ("<b_aside> we're here [noise]", "train", "WE'RE HERE [NOISE]"),
    ("(%hesitation) well (( )) yes", "eval2000", "WELL (( )) YES"),
    ("(%HESITATION) oh (um) right", "eval2000", "OH RIGHT"),
    ("IGNORE_TIME_SEGMENT_IN_SCORING", "eval2000", ""),
])
def test_filter_text_matches_jax(text, dataset, want):
    """Kaldi's swbd1/eval2000 conventions, case by case."""
    jprep = _jax_prepare()
    assert prep.filter_text(text, dataset) == jprep.filter_text(
        text, dataset) == want


@pytest.mark.parametrize("words", [
    ["UH", "I'M", "GONNA", "GO"],
    ["WE'RE", "NOT", "SURE", "THEY'LL", "COME", "[LAUGHTER]"],
    ["Y'ALL", "CAN'T", "WON'T", "UM-", "HUH", "THAT'S", "IT"],
    ["SHE'D", "HAVE", "[NOISE]", "'CAUSE", "O'CLOCK", "WANNA"],
    [],
])
def test_normalize_util_matches_jax(words, tmp_path):
    """``expand_contractions`` (strings and word lists),
    ``remove_hesitations``, ``normalize_words`` and ``read_glm`` against
    ``recipes/Switchboard/normalize_util.py``."""
    jnorm = load_path("swbd_norm_jax", SWBD / "normalize_util.py")
    text = " ".join(words).lower()
    assert prep.expand_contractions(text) == jnorm.expand_contractions(text)
    assert prep.expand_contractions_batch([words, text]) == (
        jnorm.expand_contractions_batch([words, text]))
    assert prep.remove_hesitations(words) == jnorm.remove_hesitations(words)
    assert prep.normalize_words([words]) == jnorm.normalize_words([words])
    glm = tmp_path / "en20000405_hub5.glm"
    glm.write_text(";; comment\n[ALRIGHT] => [ALL RIGHT] / [ ] __ [ ] ;; x\n"
                   "{GONNA} => GOING TO\nno arrow here\n")
    assert prep.read_glm(str(glm)) == jnorm.read_glm(str(glm)) == {
        "ALRIGHT": "ALL RIGHT", "GONNA": "GOING TO"}
    assert prep.read_glm(str(tmp_path / "missing")) == {}


def test_prepare_writes_the_jax_manifests(corpus, tmp_path):
    """Both preparations on one corpus: ``train.json``, ``dev.json`` (the
    last conversation) and ``eval2000.json``, byte for byte; no
    ``test.json``."""
    prep.prepare_switchboard(str(corpus), str(tmp_path / "port"),
                             dev_conversations=1)
    _jax_prepare().prepare_switchboard(str(corpus), str(tmp_path / "jax"),
                                       dev_conversations=1)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert names == {"train.json", "dev.json", "eval2000.json"}
    dev = json.loads((tmp_path / "port/dev.json").read_text())
    assert {r["spk_id"][:6] for r in dev.values()} == {"sw2004"}
    assert {r["channel"] for r in dev.values()} == {0, 1}
    test = json.loads((tmp_path / "port/eval2000.json").read_text())
    assert len(test) == 5  # 6 segments, one excluded from scoring


@pytest.mark.parametrize("name", list(YAMLS))
def test_yamls_match_the_dicts(name, tmp_path):
    hp, path = YAMLS[name]
    y = load_yaml(path, "", tmp_path)
    if name.startswith("lm"):
        assert_yaml_values(y, hp, 15)
        m = y["model"]
        assert (m.vocab, m.d_model, m.nhead, m.num_encoder_layers, m.d_ffn,
                m.dropout) == (hp["vocab_size"], hp["d_model"], hp["nhead"],
                               hp["num_layers"], hp["d_ffn"], hp["dropout"])
        assert y["lr_annealing"].lr_initial == hp["lr"]
    elif name == "seq2seq":
        assert_yaml_values(y, hp, 30)
        assert (y["dec"].attn_dim, y["lm_model"].rnn_neurons) == (
            hp["attn_dim"], hp["lm_rnn_neurons"])
    else:
        assert_yaml_values(y, hp, 35)
        assert_transformer_yaml(y, hp)
        assert y["test_splits"] == ["eval2000"]


def test_finetune_yamls_load_no_librispeech_lm(tmp_path):
    """The two "finetune" yamls say they start from a LibriSpeech LM
    (``LM/hparams/transformer_finetune.yaml:2``,
    ``transformer_finetuned_LM.yaml:2``), but neither script loads one;
    the yamls hold their siblings' values but the LM's rate and the
    folders.  Copied: the port's dicts are the siblings' (and the LM's
    rate)."""
    for script in ("LM/train.py", "ASR/transformer/train.py"):
        text = (SWBD / script).read_text()
        assert "Pretrainer" not in text and "pretrained" not in text.lower()
    for a, b, differ in (("LM/hparams/transformer.yaml",
                          "LM/hparams/transformer_finetune.yaml", {"lr"}),
                         ("ASR/transformer/hparams/transformer.yaml",
                          "ASR/transformer/hparams/"
                          "transformer_finetuned_LM.yaml", set())):
        assert "LibriSpeech" in (SWBD / b).read_text().splitlines()[1]
        ya = load_yaml(SWBD / a, "", tmp_path / "a")
        yb = load_yaml(SWBD / b, "", tmp_path / "b")
        plain = [k for k in ya if isinstance(ya[k], (int, float, str, list))
                 and "folder" not in k and k not in ("train_log", "train_json",
                                                     "valid_json", "test_json")]
        assert {k for k in plain if ya[k] != yb[k]} == differ
    assert recipe.HPARAMS_TRANSFORMER_FINETUNED_LM == recipe.HPARAMS_TRANSFORMER
    assert lm_training.HPARAMS_SWITCHBOARD_FINETUNE == dict(
        lm_training.HPARAMS_SWITCHBOARD, lr=1e-4)


def test_jax_seq2seq_reads_both_channels_and_stops(corpus, tmp_path):
    """The JAX seq2seq script reads the stereo segment whole
    (``ASR/seq2seq/train.py:221``), and the global normalization of its
    (B, T, n_mels, 2) features raises; the port reads the row's channel,
    as the JAX transformer script does (``ASR/transformer/
    train.py:235-240``)."""
    prep.prepare_switchboard(str(corpus), str(tmp_path), dev_conversations=1)
    row = next(iter(json.loads((tmp_path / "dev.json").read_text()).values()))
    stereo = j_read_audio(row["wav"])
    assert stereo.ndim == 2 and stereo.shape[1] == 2
    mono = recipe.read_channel(row["wav"], row["channel"])
    np.testing.assert_array_equal(mono, stereo[:, row["channel"]])
    assert not np.array_equal(stereo[:, 0], stereo[:, 1])
    feats = JFbank(sample_rate=16000, n_mels=40)(jnp.asarray(stereo[None]))
    assert feats.shape[-1] == 2
    with pytest.raises(ValueError, match="broadcast"):
        JInputNorm(norm_type="global")(feats, jnp.ones(1),
                                       state=GlobalNormState.init(40),
                                       training=True)


def test_jax_seq2seq_names_a_test_manifest_never_written(corpus, tmp_path):
    """``train_BPE_2000.yaml:19`` names ``test.json``, which the prepare
    script never writes (it writes ``eval2000.json`` when an stm is
    found): the JAX script's ``dataio_prepare`` stops on it; the port's
    seq2seq recipe tests on ``eval2000.json`` (``test_run_...``)."""
    script = load_path("swbd_s2s_jax", SWBD / "ASR/seq2seq/train.py")
    hp = load_yaml(YAMLS["seq2seq"][1], "dev_conversations: 1\n", tmp_path)
    prep.prepare_switchboard(str(corpus), hp["save_folder"],
                             dev_conversations=1)
    assert hp["test_json"].endswith("/test.json")
    assert not Path(hp["test_json"]).exists()
    with pytest.raises(FileNotFoundError):
        script.dataio_prepare(hp, tokenizer=None)


def test_seq2seq_sample_rate_is_the_yamls(corpus, tmp_path):
    """Copied: ``train_BPE_2000.yaml`` sets ``sample_rate`` 16000 on the
    8 kHz audio, and nothing resamples, so its Fbank frames at 20 ms (a
    10 ms hop at 16 kHz), as JAX's does; the transformer yaml says
    8000."""
    assert recipe.HPARAMS_SEQ2SEQ["sample_rate"] == 16000
    assert recipe.HPARAMS_TRANSFORMER["sample_rate"] == 8000
    prep.prepare_switchboard(str(corpus), str(tmp_path), dev_conversations=1)
    row = next(iter(json.loads((tmp_path / "dev.json").read_text()).values()))
    header = open(row["wav"]["file"], "rb").read(1024).decode("ascii")
    assert "sample_rate -i 8000" in header
    sig = recipe.read_channel(row["wav"], row["channel"])
    seconds = len(sig) / prep.SAMPLERATE
    import torch

    feats = Fbank(sample_rate=16000, n_mels=40)(torch.from_numpy(sig[None]))
    jfeats = JFbank(sample_rate=16000, n_mels=40)(jnp.asarray(sig[None]))
    assert feats.shape == jfeats.shape
    assert abs(feats.shape[1] - seconds * 50) <= 1


def test_seq2seq_step_matches_jax(corpus, tmp_path):
    """``Seq2SeqBrain`` with ``HPARAMS_SEQ2SEQ`` (a CTC epoch) against the
    JAX Switchboard seq2seq script's ``ASR`` on the port's batch."""
    parts = recipe.build_seq2seq(str(corpus), str(tmp_path / "port"),
                                 S2S_TOY, RUN_OPTS)
    script = load_path("swbd_s2s_jax", SWBD / "ASR/seq2seq/train.py")
    jb = jax_recipe_brain(script, load_yaml(YAMLS["seq2seq"][1],
                                            S2S_YAML_TOY, tmp_path))
    params, model_state, extra, grads = crdnn_jax_state(parts["brain"])
    batch = next(iter(parts["train_loader"]))
    assert batch.sig.data.ndim == 2
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


def test_transformer_step_matches_jax(corpus, tmp_path):
    """``SwitchboardASRBrain`` against the JAX transformer script's
    ``ASR`` (8 kHz features)."""
    parts = recipe.build_transformer(str(corpus), str(tmp_path / "port"),
                                     TR_TOY, RUN_OPTS)
    script = load_path("swbd_tr_jax", SWBD / "ASR/transformer/train.py")
    jb = jax_recipe_brain(script, load_yaml(YAMLS["transformer"][1],
                                            conformer_yaml_toy(), tmp_path))
    params, model_state, extra, grads = conformer_jax_state(parts["brain"])
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(parts["brain"], jb, batch, params, model_state,
                        extra, grads)


def test_transformer_scores_the_normalized_words():
    """``SwitchboardASRBrain._score_words``: the WER after
    ``normalize_words`` on both sides, as JAX's ``train.py:98-108``."""
    jnorm = load_path("swbd_norm_jax", SWBD / "normalize_util.py")
    predicted = [["UH", "I'M", "GONNA", "GO"], ["WE'RE", "HERE"]]
    targets = [["I", "AM", "GOING", "TO", "GO"], ["UM", "WE", "ARE", "THERE"]]
    brain = recipe.SwitchboardASRBrain.__new__(recipe.SwitchboardASRBrain)
    brain.wer_metric = ErrorRateStats()
    brain._score_words(["0", "1"], predicted, targets)
    jwer = JErrorRate()
    jwer.append(["0", "1"], jnorm.normalize_words(predicted),
                jnorm.normalize_words(targets))
    assert brain.stage_metrics() == {"WER": jwer.summarize("error_rate")}
    assert brain.stage_metrics()["WER"] == pytest.approx(100 / 8)


@pytest.mark.parametrize("name", ["seq2seq", "transformer"])
def test_run_tests_eval2000_and_resumes_bit_for_bit(corpus, tmp_path, name):
    """2 epochs equal 1 epoch plus a resumed one in a fresh Brain, bit for
    bit; then ``run`` tests ``eval2000`` from the best checkpoint with the
    family's WER file."""
    build_family, run_family, toy = (
        (recipe.build_seq2seq, recipe.run_seq2seq, S2S_TOY)
        if name == "seq2seq" else
        (recipe.build_transformer, recipe.run_transformer, TR_TOY))

    def build(folder, epochs):
        return build_family(str(corpus), str(tmp_path / folder),
                            dict(toy, **RESUME, number_of_epochs=epochs),
                            RUN_OPTS)

    assert_resume_matches(build)
    brain = run_family(str(corpus), str(tmp_path / "run"), toy, RUN_OPTS)
    assert set(brain.test_stats) == {"eval2000"}
    wer_file = "wer.txt" if name == "seq2seq" else "wer_eval2000.txt"
    assert (tmp_path / "run" / wer_file).read_text().startswith("%WER")


def test_lm_step_matches_jax(tmp_path):
    """``LM`` with ``HPARAMS_SWITCHBOARD`` at toy widths against
    ``recipes/Switchboard/LM/train.py``'s ``LM``."""
    lm_step_matches(SWBD / "LM/train.py", YAMLS["lm"][1],
                    dict(lm_training.HPARAMS_SWITCHBOARD, **LM_TOY), tmp_path)


@pytest.mark.parametrize("name", ["lm", "lm_finetune"])
def test_lm_runs_on_the_manifests_and_resumes(corpus, tmp_path, name):
    """The LM recipes on the Switchboard manifests (``words``; dev as the
    validation and the test set): 1 epoch plus a resumed one equals 2
    epochs bit for bit; the finetune dict's first step runs at 1e-4."""
    hp = YAMLS[name][0]
    toy = dict(LM_TOY, dev_conversations=1)

    def build(folder, epochs):
        return lm_training.build(str(corpus), str(tmp_path / folder),
                                 dict(toy, number_of_epochs=epochs),
                                 RUN_OPTS, hp)

    full = assert_resume_matches(build)
    assert full["brain"].lr_annealing.lr_initial == hp["lr"]
    brain = lm_training.run(str(corpus), str(tmp_path / "run"), toy,
                            RUN_OPTS, hp)
    assert brain.stage_stats["VALID"] == brain.stage_stats["TEST"]
