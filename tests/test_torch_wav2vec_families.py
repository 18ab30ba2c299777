"""The wav2vec 2.0 yamls of the port's recipe families against the JAX
scripts, taken by path: CommonVoice ``ASR/seq2seq/train_with_wav2vec.py``
(``recipes/commonvoice_asr.py``, four yamls), TIMIT
``ASR/seq2seq/train_with_wav2vec2.py`` (``recipes/timit_seq2seq.py``),
SLURP and Timers and Such ``direct/train_with_wav2vec2.py``
(``recipes/slu_direct.py``), AISHELL-1
``ASR/transformer/train_with_wav2vect.py`` (``recipes/aishell_asr.py``) and
IWSLT22 ``train.py`` with ``prepare_iwslt22.py``
(``recipes/iwslt22_st.py``, ``recipes/iwslt22_prepare.py``), on
synthetic corpora at toy widths (2 convolutions of 32, a 2-layer encoder
at d 32, clips of 0.3-0.6 s); and the checkpointer's tie-break.

Tolerances:

- the IWSLT22 manifests: byte for byte;
- the training steps (each recipe's first training batch through the
  JAX script's ``_loss_fn`` at the port's weights): the CTC families
  (CommonVoice, TIMIT, AISHELL-1) in float64 on both sides under
  ``jax.enable_x64``, the loss within 1e-9 relative (AISHELL-1's 2e-8:
  ``CONFORMER_F64_LOSS_RTOL``) and each gradient within
  ``STEP_GRAD_TOL`` (1e-6) of its tensor's largest plus 1e-9 of the
  largest overall (``tests/test_torch_wav2vec_recipes.py`` says why not
  float32: the CTC gradients' float32 error at T ~900); the AISHELL-1
  step runs K1-K4 through their plain versions on the CPU.  The SLU and IWSLT22
  steps (no CTC) in float32, as ``tests/test_torch_slu.py`` holds the SLU
  steps (``assert_step_matches``: the loss within 1e-5 relative, each
  gradient within 1e-4 of its tensor's largest plus 1e-6 of the largest
  overall);
- the greedy CTC CER, the TIMIT beam search's PER and the Timers and
  Such greedy search's exact matches: the same hypotheses and rates as
  the JAX scripts' on one batch at the same weights;
- a resumed run: bit for bit.

The JAX properties of ROADMAP Queue 3 that these recipes meet are each
pinned by a test here.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRate
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes import aishell_asr, aishell_prepare
from speechbrain_tpu_torch.recipes import common_voice_prepare
from speechbrain_tpu_torch.recipes import commonvoice_asr as cv
from speechbrain_tpu_torch.recipes import iwslt22_prepare, iwslt22_st
from speechbrain_tpu_torch.recipes import slu_direct, slurp_prepare
from speechbrain_tpu_torch.recipes import timers_and_such_prepare
from speechbrain_tpu_torch.recipes import timit_ctc, timit_seq2seq
from speechbrain_tpu_torch.utils import checkpoints
from speechbrain_tpu_torch.utils.checkpoints import Checkpointer, Recoverable

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
STEP_GRAD_TOL = 1e-6
# the conformer's float64 loss: JAX makes its rel-pos encoding table in
# float32 under x64 too (``speechbrain_tpu/nnet/attention.py:185-191``), so
# the encoder states differ at float32's relative 1e-8 (4e-9 of the loss
# here)
CONFORMER_F64_LOSS_RTOL = 2e-8
W2V_TOY = dict(latent_channels=(32, 32), embedding_dim=32, encoder_layers=2,
               nhead=4, d_ffn=64, encoder_dropout=0.0, precision="fp32",
               batch_size=2, number_of_epochs=2)
ENCODER_YAML = """
precision: fp32
dropout: 0.0
extractor: !new:speechbrain_tpu.lobes.models.wav2vec.W2VLatentExtractor
    out_channels: !tuple [32, 32]
encoder: !new:speechbrain_tpu.lobes.models.wav2vec.EncoderWrapper
    in_dim: 32
    embedding_dim: 32
    num_layers: 2
    nhead: 4
    d_ffn: 64
    dropout: 0.0
"""


def _decoder_yaml(attn_type):
    return f"""
emb_size: 8
dec_neurons: 16
dec: !new:speechbrain_tpu.nnet.RNN.AttentionalRNNDecoder
    rnn_type: gru
    attn_type: {attn_type}
    hidden_size: 16
    attn_dim: 12
    num_layers: 1
    dropout: 0.0
"""


DEC_TOY = dict(emb_size=8, dec_neurons=16, attn_dim=12, dropout=0.0)
# TIMIT's clips are 1-1.6 s (its train split must hold the 39 phones), 1600
# to 2560 frames at the toy extractor's 1.6 kHz: its beam searches stop at
# 2 % of them
TIMIT_SEARCH = dict(dnn_neurons=24, valid_beam_size=3, test_beam_size=3,
                    max_decode_ratio=0.02)
AISHELL_TOY = dict(
    {k: W2V_TOY[k] for k in ("latent_channels", "precision",
                             "number_of_epochs")},
    vocab_size=40, input_size=32, d_model=32, nhead=2, num_encoder_layers=2,
    num_decoder_layers=1, d_ffn=64, kernel_size=7, transformer_dropout=0.0,
    n_warmup_steps=4, max_batch_length=1.2, num_buckets=2, num_workers=0)
IWSLT_TOY = dict(latent_channels=(32, 32), features_dim=32, keep_n_layers=2,
                 nhead_w2v=4, d_ffn_w2v=64, encoder_dropout=0.0, d_model=16,
                 nhead=2, num_decoder_layers=2, d_ffn=32, vocab_size=60,
                 transformer_dropout=0.0, number_of_epochs=2)
# each family: (its dicts by yaml, the JAX script, the yaml's folder)
FAMILIES = {
    "commonvoice": ({f"CommonVoice/ASR/seq2seq/hparams/{n}": hp
                     for n, hp in cv.WAV2VEC_YAMLS.items()},
                    "CommonVoice/ASR/seq2seq/train_with_wav2vec.py"),
    "timit": ({"TIMIT/ASR/seq2seq/hparams/train_with_wav2vec2.yaml":
               timit_seq2seq.HPARAMS_WAV2VEC},
              "TIMIT/ASR/seq2seq/train_with_wav2vec2.py"),
    "slurp": ({"SLURP/direct/hparams/train_with_wav2vec2.yaml":
               slu_direct.HPARAMS_SLURP_WAV2VEC},
              "SLURP/direct/train_with_wav2vec2.py"),
    "tas": ({"timers-and-such/direct/hparams/train_with_wav2vec2.yaml":
             slu_direct.HPARAMS_TAS_WAV2VEC},
            "timers-and-such/direct/train_with_wav2vec2.py"),
    "aishell": ({"AISHELL-1/ASR/transformer/hparams/"
                 "train_ASR_transformer_with_wav2vect.yaml":
                 aishell_asr.HPARAMS_WAV2VECT},
                "AISHELL-1/ASR/transformer/train_with_wav2vect.py"),
    "iwslt": ({"IWSLT22_lowresource/hparams/train_w2v2_st.yaml":
               iwslt22_st.HPARAMS}, "IWSLT22_lowresource/train.py"),
}
YAMLS = {rel: hp for dicts, _ in FAMILIES.values()
         for rel, hp in dicts.items()}


# ------------------------------------------------------------ the checkpointer


@pytest.mark.parametrize("key", ["min_key", "max_key"])
def test_tied_checkpoints_load_one_choice(tmp_path, monkeypatch, key):
    """Two checkpoints tie on the key (CER 50, BLEU 0) beside a third that
    does not (CER 80, BLEU -1): whichever order the save folder lists
    them in, ``find_checkpoint`` picks the same one, the newest of the
    tied, and ``find_checkpoints`` orders all three the same; with equal
    times too, the later directory name wins.  ``Path.iterdir()``'s order
    decided before."""
    ckptr = Checkpointer(tmp_path, {"x": Recoverable({"x": torch.zeros(1)})})
    for i, (cer, bleu) in enumerate(((50.0, 0.0), (80.0, -1.0),
                                     (50.0, 0.0))):
        ckptr.save_checkpoint(meta={"CER": cer, "BLEU": bleu,
                                    "unixtime": 100.0 + i}, name=f"c{i}")
    arg = {"min_key": "CER"} if key == "min_key" else {"max_key": "BLEU"}
    listed = Checkpointer._list_checkpoint_dirs
    picks = []
    for order in (sorted, lambda dirs: sorted(dirs, reverse=True)):
        monkeypatch.setattr(Checkpointer, "_list_checkpoint_dirs",
                            lambda self, order=order: order(listed(self)))
        picks.append([c.path.name for c in ckptr.find_checkpoints(**arg)])
        assert ckptr.find_checkpoint(**arg).path.name == "CKPT+c2"
    assert picks[0] == picks[1] == ["CKPT+c2", "CKPT+c0", "CKPT+c1"]
    same_time = [checkpoints.Checkpoint(Path(f"CKPT+{n}"), {"CER": 1.0,
                                                             "unixtime": 5.0},
                                        {}) for n in ("a", "b")]
    for order in (same_time, same_time[::-1]):
        ranked = checkpoints._ranked(order, lambda c: -c.meta["CER"])
        assert [c.path.name for c in ranked] == ["CKPT+b", "CKPT+a"]


def test_tied_keep_best_keeps_the_newest(tmp_path, monkeypatch):
    """``save_and_keep_only`` on a tie of its ``min_keys`` keeps the
    newest (also the most recent, so one checkpoint), whatever the
    listing order."""
    listed = Checkpointer._list_checkpoint_dirs
    for reverse in (False, True):
        monkeypatch.setattr(Checkpointer, "_list_checkpoint_dirs",
                            lambda self, r=reverse: sorted(listed(self),
                                                           reverse=r))
        ckptr = Checkpointer(tmp_path / str(reverse),
                             {"x": Recoverable({"x": torch.zeros(1)})})
        for i in range(2):
            ckptr.save_and_keep_only(meta={"CER": 100.0,
                                           "unixtime": 100.0 + i},
                                     min_keys=["CER"], name=f"c{i}")
        assert [c.path.name for c in ckptr.list_checkpoints()] == ["CKPT+c1"]


# ------------------------------------------------------------ corpora


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2v_families")
    common_voice_prepare.write_synthetic_common_voice(
        str(root / "cv"), {"train": 4, "dev": 2, "test": 2}, language="fr",
        seconds=(0.3, 0.6), seed=3)
    timit_ctc.write_synthetic_timit(str(root / "timit"),
                                    {"train": 8, "dev": 4, "test": 4},
                                    seconds=(1.0, 1.6), max_phones=16,
                                    seed=6)
    slurp_prepare.write_synthetic_slurp(
        str(root / "slurp"), {"train": 4, "devel": 2, "test": 2},
        seconds=(0.3, 0.6), seed=2)
    timers_and_such_prepare.write_synthetic_tas(
        str(root / "tas"), {"train-synth": 2, "train-real": 2,
                            "dev-real": 2, "test-real": 2},
        seconds=(0.3, 0.6), seed=3)
    aishell_prepare.write_synthetic_aishell(
        str(root / "aishell"), {"train": 4, "dev": 2, "test": 2},
        seconds=(0.3, 0.6), n_chars=20, seed=3)
    iwslt22_prepare.write_synthetic_iwslt22(
        str(root / "iwslt"), {"train": 4, "valid": 2, "test": 2},
        seconds=(0.3, 0.6), shared=1, seed=3)
    return root


def _build(name, corpora, out, **over):
    """The family's ``build`` at toy widths on its corpus."""
    data, out = str(corpora / {"commonvoice": "cv"}.get(name, name)), str(out)
    if name == "commonvoice":
        return cv.build_wav2vec(data, out, dict(W2V_TOY, **DEC_TOY, **over),
                                RUN_OPTS)
    if name == "timit":
        return timit_seq2seq.build(
            data, out, dict(W2V_TOY, **DEC_TOY, **TIMIT_SEARCH, **over),
            RUN_OPTS, timit_seq2seq.HPARAMS_WAV2VEC)
    if name in ("slurp", "tas"):
        hp = (slu_direct.HPARAMS_SLURP_WAV2VEC if name == "slurp"
              else slu_direct.HPARAMS_TAS_WAV2VEC)
        return slu_direct.build(data, out, dict(W2V_TOY, **DEC_TOY, **over),
                                RUN_OPTS, hp)
    if name == "aishell":
        return aishell_asr.build_transformer(
            data, out, dict(AISHELL_TOY, **over), RUN_OPTS,
            aishell_asr.HPARAMS_WAV2VECT)
    return iwslt22_st.build(data, out, dict(IWSLT_TOY, **over), RUN_OPTS)


_TOY_YAML = {
    "commonvoice": ENCODER_YAML + _decoder_yaml("location"),
    "timit": ENCODER_YAML + _decoder_yaml("location") + "".join(
        f"{k}: {v}\n" for k, v in TIMIT_SEARCH.items()),
    "slurp": ENCODER_YAML + _decoder_yaml("content"),
    "tas": ENCODER_YAML + _decoder_yaml("content"),
    "aishell": """
precision: fp32
vocab_size: 40
d_model: 32
nhead: 2
num_encoder_layers: 2
num_decoder_layers: 1
d_ffn: 64
kernel_size: 7
transformer_dropout: 0.0
extractor: !new:speechbrain_tpu.lobes.models.wav2vec.W2VLatentExtractor
    out_channels: !tuple [32, 32]
transformer: !new:speechbrain_tpu.lobes.models.transformer.TransformerASR.TransformerASR
    input_size: 32
    tgt_vocab: !ref <output_neurons>
    d_model: !ref <d_model>
    nhead: !ref <nhead>
    num_encoder_layers: !ref <num_encoder_layers>
    num_decoder_layers: !ref <num_decoder_layers>
    d_ffn: !ref <d_ffn>
    dropout: !ref <transformer_dropout>
    encoder_module: conformer
    attention_type: RelPosMHAXL
    normalize_before: True
    kernel_size: !ref <kernel_size>
""",
    "iwslt": """
latent_dim: 32
features_dim: 32
keep_n_layers: 2
nhead_w2v: 4
d_ffn_w2v: 64
d_model: 16
nhead: 2
num_decoder_layers: 2
d_ffn: 32
vocab_size: 60
transformer_dropout: 0.0
extractor: !new:speechbrain_tpu.lobes.models.wav2vec.W2VLatentExtractor
    out_channels: !tuple [32, 32]
encoder: !new:speechbrain_tpu.lobes.models.wav2vec.EncoderWrapper
    in_dim: !ref <latent_dim>
    embedding_dim: !ref <features_dim>
    num_layers: !ref <keep_n_layers>
    nhead: !ref <nhead_w2v>
    d_ffn: !ref <d_ffn_w2v>
    dropout: 0.0
""",
}


def _jax_brain(name, tmp_path):
    """The family's JAX script's Brain on its yaml at the toy widths."""
    dicts, script_rel = FAMILIES[name]
    rel = next(iter(dicts)) if name != "commonvoice" else (
        "CommonVoice/ASR/seq2seq/hparams/train_fr_with_wav2vec.yaml")
    script = load_path(f"w2v_family_{name}_jax", RECIPES / script_rel)
    y = load_yaml(RECIPES / rel, _TOY_YAML[name], tmp_path)
    cls = {"slurp": "SLU", "tas": "SLU", "iwslt": "ST"}.get(name, "ASR")
    return getattr(script, cls)(
        modules=y["modules"],
        opt_class=lambda lr: y["opt_class"](learning_rate=lr), hparams=y,
        run_opts={"noprogressbar": True}), script


# ------------------------------------------------------------ preparation


def test_iwslt22_prepare_writes_the_jax_manifests(corpora, tmp_path):
    """Both preparations on one corpus folder: the same three manifests,
    byte for byte.  A recording listed twice (two segments at offsets 0
    and half its duration) is one row, the last segment's duration, its
    whole file: ``prepare_iwslt22.py:38-47`` keys rows by the wav's
    basename and never reads the offset (copied)."""
    data = corpora / "iwslt"
    iwslt22_prepare.data_proc(str(data), str(tmp_path / "port"))
    load_path("iwslt22_prepare_jax", RECIPES / "IWSLT22_lowresource/"
              "prepare_iwslt22.py").data_proc(str(data), str(tmp_path / "jax"))
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    index = (data / "train.yaml").read_text().splitlines()
    rows = json.loads((tmp_path / "port/train.json").read_text())
    assert len(index) == 5 and len(rows) == 4
    last = re.search(r"duration: ([0-9.]+), offset: ([0-9.]+)", index[-1])
    first = re.search(r"duration: ([0-9.]+), offset: ([0-9.]+)", index[3])
    assert float(last.group(2)) > 0 and index[-1].endswith(
        index[3].split("wav: ")[1])
    row = rows["train_00003"]
    assert row["duration"] == pytest.approx(float(last.group(1)))
    assert row["duration"] == pytest.approx(float(first.group(1)) / 2, 1e-5)
    assert row["trans"] == (data / "train.fra").read_text().splitlines()[-1]


# ------------------------------------------------------------ the yamls


def _optimizer(y):
    """The yaml's ``opt_class``: its function's name and arguments."""
    opt = y["opt_class"]
    return (getattr(opt, "func", opt).__name__,
            dict(getattr(opt, "keywords", {})))


@pytest.mark.parametrize("rel", sorted(YAMLS))
def test_yaml_matches_the_dict(rel, tmp_path):
    """Each of the 9 yamls, loaded by JAX's ``load_hyperpyyaml``, against
    its dict: the shared values, the wav2vec modules' fields, the
    decoder's or transformer's, the optimizer's and the schedule's."""
    hp = YAMLS[rel]
    y = load_yaml(RECIPES / rel, "", tmp_path)
    assert_yaml_values(y, hp, 8, skip=("vocab_size",))
    ext = y["extractor"]
    assert (tuple(ext.out_channels), tuple(ext.kernel_sizes),
            tuple(ext.strides)) == (hp["latent_channels"],
                                    hp["kernel_sizes"], hp["strides"])
    assert y.get("precision", "fp32") == hp["precision"]
    if "IWSLT22" in rel:
        enc, t = y["encoder"], y["Transformer"]
        assert (enc.embedding_dim, enc.num_layers, enc.nhead, enc.d_ffn,
                enc.dropout) == (hp["features_dim"], hp["keep_n_layers"],
                                 hp["nhead_w2v"], hp["d_ffn_w2v"],
                                 hp["encoder_dropout"])
        assert (t.tgt_vocab, t.input_size, t.d_model, t.nhead,
                t.num_encoder_layers, t.num_decoder_layers, t.d_ffn,
                t.dropout, t.activation, t.normalize_before) == (
            hp["vocab_size"], hp["d_model"], hp["d_model"], hp["nhead"],
            hp["num_encoder_layers"], hp["num_decoder_layers"], hp["d_ffn"],
            hp["transformer_dropout"], hp["activation"],
            hp["normalize_before"])
        assert (y["enc"].n_neurons, y["seq_lin"].n_neurons) == (
            hp["d_model"], hp["vocab_size"])
        assert (y["noam_annealing"].lr_initial,
                y["noam_annealing"].n_warmup_steps) == (hp["lr_adam"],
                                                        hp["n_warmup_steps"])
        assert _optimizer(y) == ("adam", {})  # optax's defaults
        return
    if "AISHELL" in rel:
        t = y["transformer"]
        assert (t.input_size, t.tgt_vocab, t.d_model, t.nhead,
                t.num_encoder_layers, t.num_decoder_layers, t.d_ffn,
                t.dropout, t.encoder_module, t.attention_type,
                t.normalize_before, t.kernel_size, t.activation) == (
            hp["input_size"], hp["vocab_size"], hp["d_model"], hp["nhead"],
            hp["num_encoder_layers"], hp["num_decoder_layers"], hp["d_ffn"],
            hp["transformer_dropout"], hp["encoder_module"],
            hp["attention_type"], hp["normalize_before"], hp["kernel_size"],
            hp["activation"])
        assert hp["input_size"] == ext.out_channels[-1] == 512
        opt = y["opt_class"].keywords
        assert (opt["b1"], opt["b2"], opt["eps"]) == (0.9, 0.98, 1e-9)
        assert (y["noam_annealing"].lr_initial,
                y["noam_annealing"].n_warmup_steps) == (hp["lr_adam"],
                                                        hp["n_warmup_steps"])
        assert set(y["modules"]) == {"extractor", "transformer", "ctc_lin",
                                     "seq_lin"}
        return
    enc = y["encoder"]
    assert (enc.in_dim, enc.embedding_dim, enc.num_layers, enc.nhead,
            enc.d_ffn, enc.dropout) == (
        hp["latent_channels"][-1], hp["embedding_dim"], hp["encoder_layers"],
        hp["nhead"], hp["d_ffn"], hp["encoder_dropout"])
    assert hp["encoder"] == "wav2vec"
    dec = y["dec"]
    assert (dec.rnn_type, dec.hidden_size, dec.attn_dim, dec.num_layers,
            dec.dropout, y["emb"].embedding_dim) == (
        "gru", hp["dec_neurons"], hp["attn_dim"], 1, hp["dropout"],
        hp["emb_size"])
    outputs = y.get("output_neurons", y.get("vocab_size"))
    assert outputs == hp.get("output_neurons", hp.get("vocab_size"))
    if "direct" in rel:
        assert dec.attn_type == hp["attn_type"] == "content"
        assert _optimizer(y) == ("adam", {})  # at lr
        assert set(y["modules"]) == {"extractor", "encoder", "emb", "dec",
                                     "seq_lin"}
        return
    assert dec.attn_type == "location"
    opt = y["opt_class"].keywords
    assert (opt["rho"], opt["eps"]) == (hp["rho"], hp["eps"])
    nb = y["lr_annealing"]
    assert (nb.hyperparam_value, nb.improvement_threshold,
            nb.annealing_factor, nb.patient) == (
        hp["lr"], hp["improvement_threshold"], hp["annealing_factor"],
        hp["patient"])
    if "TIMIT" in rel:
        assert (y["enc_dnn"].dnn_blocks, y["enc_dnn"].dnn_neurons) == (
            hp["dnn_blocks"], hp["dnn_neurons"])
        assert (y["valid_beam_size"], y["test_beam_size"]) == (8, 16)
    else:
        assert outputs == 500 and "enc_dnn" not in y["modules"]


# ------------------------------------------------------------ the steps


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _assert_f64_step_matches(pb, jb, batch, loss_rtol=1e-9):
    """The port's Brain in float64 against the JAX script's ``_loss_fn``
    under ``jax.enable_x64`` on ``batch`` at the port's weights (the
    bridge's ``to_jax_wav2vec``).  JAX's relative lengths and
    ``batch_mask`` stay float32: its attention's and its losses' length
    masks (``_length_mask``, ``speechbrain_tpu/nnet/attention.py:36-40``)
    read a float64 length as a count of frames, so under x64 they would
    keep frame 0 alone (a float32 relative length times T is the same
    count on both sides)."""
    host = {k: torch.as_tensor(v) for k, v in batch.numeric_dict().items()}
    host.setdefault("batch_mask", torch.ones(host["sig"].shape[0]))
    host = {k: v.double() if v.is_floating_point() else v
            for k, v in host.items()}
    with jax.enable_x64(True):
        params = _f64(bridge.to_jax_wav2vec(pb.modules.state_dict()))
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in host.items()}
        for k in jbatch:
            if k.endswith("_lens") or k == "batch_mask":
                jbatch[k] = jnp.asarray(host[k].float().numpy())
        rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

        def loss_fn(p):
            return jb._loss_fn(p, {}, {}, jbatch, rngs, JStage.TRAIN)[0]

        jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            params))
    pb.modules.double().train()
    pb.dtype = torch.float64
    if hasattr(pb, "model"):
        pb.model.dtype = torch.float64
    pb.set_kernels(False)
    loss = pb.compute_objectives(pb.compute_forward(host, Stage.TRAIN), host,
                                 Stage.TRAIN)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=loss_rtol)
    sd = dict(pb.modules.state_dict())
    sd.update({k: p.grad for k, p in pb.modules.named_parameters()})
    got = jax.tree_util.tree_leaves_with_path(bridge.to_jax_wav2vec(sd))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [k for k, _ in got] == [k for k, _ in want]
    top = max(float(np.abs(w).max()) for _, w in want)
    for (path, g), (_, w) in zip(got, want):
        bound = STEP_GRAD_TOL * float(np.abs(w).max()) + 1e-9 * top
        dev = float(np.abs(g - w).max())
        assert dev <= bound, f"{jax.tree_util.keystr(path)}: {dev} > {bound}"


@pytest.mark.parametrize("name", ["commonvoice", "timit", "aishell"])
def test_ctc_family_step_matches_jax(corpora, tmp_path, name):
    """The CTC families' training step on the recipe's first batch against
    the JAX script's, in float64: CommonVoice's and TIMIT's wav2vec +
    location-attention GRU decoder (TIMIT through ``enc_dnn``), 0.3 or 0.5
    CTC + NLL; AISHELL-1's latents into the conformer ``TransformerASR``
    (K1/K2 and the rel-pos attention on their plain versions), 0.3 CTC +
    0.7 label-smoothed KL, both ``batchmean``."""
    parts = _build(name, corpora, tmp_path / "port")
    jb, _ = _jax_brain(name, tmp_path)
    _assert_f64_step_matches(parts["brain"], jb,
                             next(iter(parts["train_loader"])),
                             CONFORMER_F64_LOSS_RTOL if name == "aishell"
                             else 1e-9)


@pytest.mark.parametrize("name", ["slurp", "tas", "iwslt"])
def test_step_matches_jax(corpora, tmp_path, name):
    """The SLU (the content-attention GRU decoder over the wav2vec states,
    the NLL of the semantics' pieces) and IWSLT22 (``enc`` and the
    decoder-only ``TransformerST``, the label-smoothed NLL) steps in
    float32 against the JAX scripts'."""
    parts = _build(name, corpora, tmp_path / "port")
    jb, _ = _jax_brain(name, tmp_path)
    pb = parts["brain"]
    params = bridge.to_jax_wav2vec(pb.modules.state_dict())
    assert_step_matches(pb, jb, next(iter(parts["train_loader"])), params,
                        {}, {}, bridge.to_jax_wav2vec)


def test_bridge_round_trips_the_new_modules(corpora, tmp_path):
    """``to_jax_wav2vec`` then ``wav2vec_state_dict`` gives back each
    family's modules bit for bit (the decoder-only ``TransformerST``: the
    entries Flax holds, its unused encoder left out)."""
    for name in ("commonvoice", "timit", "slurp", "aishell", "iwslt"):
        brain = _build(name, corpora, tmp_path / name)["brain"]
        sd = brain.modules.state_dict()
        back = bridge.wav2vec_state_dict(bridge.to_jax_wav2vec(sd))
        if name == "iwslt":
            assert not any(k.startswith("Transformer.st.encoder")
                           for k in back)
            sd = {k: v for k, v in sd.items() if k in back
                  or not k.startswith("Transformer.")}
            assert {k for k in sd if k.startswith("Transformer.")} == {
                k for k in back if k.startswith("Transformer.")}
        assert back.keys() == sd.keys(), name
        for k in sd:
            assert torch.equal(back[k], sd[k]), (name, k)


# ------------------------------------------------------------ the scoring


def _scoring_inputs(pb, jb, batch):
    tb = pb.prepare_batch(batch)
    params = bridge.to_jax_wav2vec(pb.modules.state_dict())
    jbatch = _jax_batch(batch.numeric_dict())
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

    def forward(params, jbatch):
        jb._bind(params, {}, {}, rngs, train=False)
        return jb.compute_forward(jbatch, JStage.VALID)

    jpreds = jax.jit(forward)(params, jbatch)
    jb._bind(params, {}, {}, rngs, train=False)
    pb.modules.eval()
    with torch.no_grad():
        preds = pb.compute_forward(tb, Stage.VALID)
    return tb, preds, jbatch, jpreds


@pytest.mark.parametrize("name", ["commonvoice", "timit", "tas"])
def test_scoring_matches_jax(corpora, tmp_path, name):
    """The validation stage's scoring of one batch at the same weights:
    CommonVoice's greedy CTC CER, TIMIT's beam search at beam 3 (its PER)
    and Timers and Such's greedy search (its exact matches) give the JAX
    scripts' hypotheses and rates (their ``compute_objectives`` at
    VALID)."""
    parts = _build(name, corpora, tmp_path / "port")
    pb, enc = parts["brain"], parts.get("label_encoder")
    jb, _ = _jax_brain(name, tmp_path)
    jb.label_encoder = enc
    batch = next(iter(parts["valid_loader"]))
    tb, preds, jbatch, jpreds = _scoring_inputs(pb, jb, batch)
    pb.on_stage_start(Stage.VALID, 1)
    jb.on_stage_start(JStage.VALID)
    with torch.no_grad():
        pb.compute_objectives(preds, tb, Stage.VALID)
    jb.compute_objectives(jpreds, jbatch, JStage.VALID)
    if name == "tas":
        assert pb.exact == jb.exact and len(pb.exact) == 2
        return
    port = pb.cer_metric if name == "commonvoice" else pb.per_metrics
    ref = jb.cer_metric if name == "commonvoice" else jb.per_metrics
    assert [s["hyp_tokens"] for s in port.scores] == [
        s["hyp_tokens"] for s in ref.scores]
    assert port.summarize("error_rate") == ref.summarize("error_rate") > 0
    assert any(s["hyp_tokens"] for s in port.scores)


def test_iwslt22_bleu_holds_each_hypothesis_to_its_reference(corpora,
                                                             tmp_path):
    """IWSLT22's BLEU at VALID on one batch: the JAX script appends the
    batch's references as one segment (``[refs]``) and its hypotheses and
    references as joined strings (``train.py:56-73``), so its BLEU counts
    character n-grams and pairs the batch's first hypothesis with every
    reference; the port appends each hypothesis's words with its own
    reference's, as ``fisher_st`` does.  Both decode the same
    teacher-forced argmax."""
    parts = _build("iwslt", corpora, tmp_path / "port")
    pb, tok = parts["brain"], parts["tokenizer"]
    jb, _ = _jax_brain("iwslt", tmp_path)
    jb.tokenizer = tok
    batch = next(iter(parts["valid_loader"]))
    tb, preds, jbatch, jpreds = _scoring_inputs(pb, jb, batch)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), atol=1e-4)
    pb.on_stage_start(Stage.VALID, 1)
    jb.on_stage_start(JStage.VALID)
    pb.compute_objectives(preds, tb, Stage.VALID)
    jb.compute_objectives(jnp.asarray(preds.numpy()), jbatch, JStage.VALID)
    refs = tok(tb["tokens"].numpy().tolist(), tb["tokens_lens"].numpy(),
               task="decode")
    assert pb.bleu_metric.targets == [[r] for r in refs]
    assert jb.bleu_metric.targets == [[" ".join(r) for r in refs]]
    assert [" ".join(h) for h in pb.bleu_metric.predicts] == (
        jb.bleu_metric.predicts)
    assert all(isinstance(h, str) for h in jb.bleu_metric.predicts)


# ------------------------------------------------------------ the runs


RESUMED = ["commonvoice", "commonvoice_en", "timit", "slurp", "tas",
           "aishell", "iwslt"]


@pytest.mark.parametrize("name", RESUMED)
def test_run_resumes_bit_for_bit(corpora, tmp_path, name):
    """Each family's ``build`` (CommonVoice also with the English dict on
    its own folder): 2 epochs equal 1 epoch plus a resumed one in a fresh
    Brain, bit for bit (modules, the optimizer's state, the rate; NewBob
    and Noam checkpointed); then the test from the best checkpoint, its
    loss and metric finite."""
    over = {}
    if name == "commonvoice_en":
        common_voice_prepare.write_synthetic_common_voice(
            str(tmp_path / "cv_en"), {"train": 4, "dev": 2, "test": 2},
            language="en", seconds=(0.3, 0.6), seed=4)

        def make(folder, epochs):
            return cv.build_wav2vec(
                str(tmp_path / "cv_en"), str(tmp_path / folder),
                dict(W2V_TOY, **DEC_TOY, **RESUME, number_of_epochs=epochs),
                RUN_OPTS, cv.HPARAMS_WAV2VEC_EN)
    else:
        def make(folder, epochs):
            return _build(name, corpora, tmp_path / folder, **RESUME,
                          number_of_epochs=epochs, **over)

    full = assert_resume_matches(make)
    brain = full["brain"]
    family = name.split("_")[0]
    metric, best = {"timit": ("PER", "min_key"), "slurp": ("loss", "min_key"),
                    "tas": ("acc", "max_key"),
                    "iwslt": ("BLEU", "max_key")}.get(family,
                                                      ("CER", "min_key"))
    brain.evaluate(full["test_loader"], **{best: metric})
    stats = brain.stage_stats["TEST"]
    assert metric in stats and all(np.isfinite(v) for v in stats.values())
    schedule = ("noam_annealing" if family in ("aishell", "iwslt")
                else "lr_annealing" if family in ("commonvoice", "timit")
                else None)
    ckpt = next((tmp_path / "full/save").glob("CKPT*"))
    if schedule is not None:
        assert (ckpt / f"{schedule}.ckpt").exists()
    log = (tmp_path / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 3 and "test loss" in log[2]


# ------------------------------------------------------------ JAX's properties


SCRIPTS = [script for _, script in FAMILIES.values()]


def test_padding_is_attended(corpora, tmp_path):
    """None of the six scripts passes ``wav_lens`` to the wav2vec encoder
    (``encoder(latents)``), so its attention reads the padded frames of a
    batch's shorter clips; AISHELL-1's passes ``wav_len`` to its
    ``TransformerASR``.  On CommonVoice's step the short clip's CTC
    log-probs at its own frames change with its partner's padding, in the
    JAX script and in the port alike (copied)."""
    for rel in SCRIPTS:
        text = (RECIPES / rel).read_text()
        if "AISHELL" in rel:
            assert "wav_len=batch[\"sig_lens\"]" in text
        else:
            assert "self.modules.encoder(latents)[\"embeddings\"]" in text
    parts = _build("commonvoice", corpora, tmp_path / "port")
    pb = parts["brain"]
    jb, _ = _jax_brain("commonvoice", tmp_path)
    params = bridge.to_jax_wav2vec(pb.modules.state_dict())
    rng = np.random.default_rng(9)
    short = rng.standard_normal(4000).astype(np.float32)
    T = pb.modules.extractor.get_output_lengths(4000)
    outs = {}
    for n in (4000, 6000):
        sig = np.zeros((2, n), np.float32)
        sig[0, :4000] = short
        sig[1] = rng.standard_normal(n)
        batch = {"sig": sig, "sig_lens": np.array([4000 / n, 1.0], np.float32),
                 "tokens_bos": np.array([[1, 5], [1, 6]])}
        pb.modules.eval()
        with torch.no_grad():
            port = pb.compute_forward({k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                                      Stage.VALID)[0][0, :T].numpy()
        jb._bind(params, {}, {}, None, train=False)
        ref = np.asarray(jb.compute_forward({k: jnp.asarray(v)
                                             for k, v in batch.items()},
                                            JStage.VALID)[0])[0, :T]
        np.testing.assert_allclose(port, ref, atol=1e-4)
        outs[n] = port
    assert np.abs(outs[4000] - outs[6000]).max() > 1e-3


def test_schedules_are_not_checkpointed_by_the_jax_scripts():
    """No JAX script registers its NewBob or Noam schedule with the
    checkpointer, so a resumed run restarts it; the port registers them
    (``test_run_resumes_bit_for_bit`` finds them in the checkpoints)."""
    for rel in SCRIPTS:
        text = (RECIPES / rel).read_text()
        assert "add_recoverable" not in text
    annealed = [rel for rel in SCRIPTS if "lr_annealing(" in (
        RECIPES / rel).read_text() or "noam_annealing()" in (
        RECIPES / rel).read_text()]
    assert len(annealed) == 4  # the SLU scripts anneal nothing


def test_precision_each_script_runs(corpora, tmp_path):
    """What each JAX script runs in: AISHELL-1's casts the extractor's
    latents to bf16 under its yaml's bf16 (``train_with_wav2vect.py:37-38``)
    and the port does the same (the extractor in float32, the conformer in
    bfloat16); the TIMIT yaml says bf16 but its script never casts (float32
    in JAX), and the port runs the Brain's precision, the wave cast before
    the extractor; the other yamls set no precision (float32)."""
    for rel in SCRIPTS:
        text = (RECIPES / rel).read_text()
        casts = "bfloat16" in text or "self.precision" in text
        assert casts == ("AISHELL" in rel), rel
    assert timit_seq2seq.HPARAMS_WAV2VEC["precision"] == "bf16"
    assert aishell_asr.HPARAMS_WAV2VECT["precision"] == "bf16"
    assert {cv.HPARAMS_WAV2VEC_FR["precision"],
            slu_direct.HPARAMS_SLURP_WAV2VEC["precision"],
            iwslt22_st.HPARAMS["precision"]} == {"fp32"}
    seen = {}
    for name in ("aishell", "timit"):
        brain = _build(name, corpora, tmp_path / name,
                       precision="bf16")["brain"]
        hooks = [brain.modules.extractor.register_forward_hook(
            lambda m, a, out, n=name: seen.setdefault(n, []).append(
                ("extractor", a[0].dtype, out.dtype)))]
        if name == "aishell":
            hooks.append(brain.modules.transformer.register_forward_hook(
                lambda m, a, out: seen[name].append(("transformer",
                                                     a[0].dtype))))
        brain.step = 1
        brain.fit_batch(next(iter(_build(name, corpora, tmp_path / name,
                                         precision="bf16")["train_loader"])))
        for h in hooks:
            h.remove()
    assert seen["aishell"] == [("extractor", torch.float32, torch.float32),
                               ("transformer", torch.bfloat16)]
    assert seen["timit"] == [("extractor", torch.bfloat16, torch.bfloat16)]


def test_timit_inventory_against_output_neurons(corpora, tmp_path):
    """TIMIT's seq2seq yamls give 42 outputs ("39 phonemes + blank/bos/
    eos"): the port's 39-phone fold (``timit_ctc.FOLD39``) fills them
    exactly; the JAX preparation's fold gives 40 phones
    (``recipes/TIMIT/timit_prepare.py:139-166``), 43 labels, one past
    both heads.  The port's build raises, naming the inventory's size,
    when it passes ``output_neurons``."""
    parts = _build("timit", corpora, tmp_path / "port")
    assert len(parts["label_encoder"]) == 42 == (
        timit_seq2seq.HPARAMS_WAV2VEC["output_neurons"])
    jprep = load_path("timit_prepare_jax", RECIPES / "TIMIT/timit_prepare.py")
    out = tmp_path / "jax"
    out.mkdir()
    jprep.prepare_timit(str(corpora / "timit"), str(out / "train.json"),
                        str(out / "dev.json"), str(out / "test.json"),
                        phn_set=39)
    phones = set()
    for split in ("train", "dev", "test"):
        for row in json.loads((out / f"{split}.json").read_text()).values():
            phones.update(row["phn"].split())
    assert len(phones) == 40 and len(phones) + 3 > 42
    with pytest.raises(ValueError, match="42 labels"):
        _build("timit", corpora, tmp_path / "small", output_neurons=41)
    with pytest.raises(ValueError, match="pass output_neurons 8"):
        _build("commonvoice", corpora, tmp_path / "cv_small", vocab_size=8)
