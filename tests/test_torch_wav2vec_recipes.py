"""The wav2vec 2.0 recipes on the port against the JAX scripts, taken by
path: ``recipes/wav2vec_pretrain.py`` (LibriSpeech and CommonVoice
``self-supervised-learning/wav2vec2``), ``recipes/wav2vec_ctc.py`` (the
LibriSpeech, DVoice, CommonVoice, AISHELL-1 and Switchboard
``train_with_wav2vec`` scripts and their 15 yamls) and
``recipes/dvoice_prepare.py``, on synthetic corpora at toy widths (2
convolutions of 32, a 2-layer encoder at d 32, 8 x 2 codewords, clips of
0.25-0.5 s).

Tolerances:

- the DVoice manifests: byte for byte;
- the training steps (the recipes' first batch through the JAX scripts'
  ``_loss_fn`` at the port's weights): the CTC steps in float64 on both
  sides, the loss within 1e-9 relative and each gradient within 1e-6 of
  its tensor's largest (``test_ctc_step_matches_jax`` says why not
  float32); the pretraining step in float32, with the same Gumbel draw and
  negatives' offsets handed to both, as ``tests/test_torch_aishell.py``
  holds its steps (``assert_step_matches``: the loss within 1e-5
  relative, each gradient within 1e-4 of its tensor's largest plus 1e-6
  of the largest overall);
- the greedy CER and WER: the same hypotheses and error rates;
- a resumed run: bit for bit.

The JAX properties of ROADMAP Queue 3 that these recipes meet are each
pinned by a test here.
"""

import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.dataio.dataio import read_audio as j_read_audio
from speechbrain_tpu.lobes.models import wav2vec as JW
from speechbrain_tpu.nnet.losses import ContrastiveLoss as JContrastiveLoss
from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRate
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.nnet.losses import ContrastiveLoss
from speechbrain_tpu_torch.recipes import aishell_prepare
from speechbrain_tpu_torch.recipes import common_voice_prepare
from speechbrain_tpu_torch.recipes import dvoice_prepare
from speechbrain_tpu_torch.recipes import librispeech_asr
from speechbrain_tpu_torch.recipes import switchboard_prepare
from speechbrain_tpu_torch.recipes import wav2vec_ctc as ctc
from speechbrain_tpu_torch.recipes import wav2vec_pretrain as pre
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_transformer_encoder_asr import (
    RESUME,
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
COUNTS = {"train": 4, "dev": 2, "test": 2}
SECONDS = (0.25, 0.5)
TOY = dict(latent_channels=(32, 32), embedding_dim=32, encoder_layers=2,
           nhead=4, d_ffn=64, dnn_neurons=24, encoder_dropout=0.0,
           precision="fp32", batch_size=2, number_of_epochs=2)
PRE_TOY = dict(TOY, quantiser_vars=8, target_dim=16, num_negatives=4,
               mask_length=3, mask_prob=0.3, crop_seconds=0.25,
               grad_accumulation_factor=1)
LS = {"train_splits": ["train-clean-100"]}
STEP_GRAD_TOL = 1e-6
ENCODER_YAML = """
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
CTC_YAML = ENCODER_YAML + """
enc_dnn: !new:speechbrain_tpu.lobes.models.VanillaNN.VanillaNN
    dnn_blocks: 2
    dnn_neurons: 24
"""
PRE_YAML = ENCODER_YAML + """
quantiser: !new:speechbrain_tpu.lobes.models.wav2vec.W2VTargetQuantiser
    in_dim: 32
    out_dim: 16
    quantiser_vars: 8
    quantiser_groups: 2
proj: !new:speechbrain_tpu.nnet.linear.Linear
    n_neurons: 16
num_negatives: 4
mask_length: 3
mask_prob: 0.3
"""
SSL_YAMLS = {
    "LibriSpeech/self-supervised-learning/wav2vec2/hparams/"
    "wav2vec2_base.yaml": pre.HPARAMS,
    "CommonVoice/self-supervised-learning/wav2vec2/hparams/"
    "wav2vec2_base.yaml": pre.HPARAMS_COMMONVOICE,
}
SCRIPTS = {
    "librispeech": "LibriSpeech/ASR/CTC/train_with_wav2vec.py",
    "dvoice": "DVoice/ASR/CTC/train_with_wav2vec2.py",
    "commonvoice": "CommonVoice/ASR/CTC/train_with_wav2vec.py",
    "aishell": "AISHELL-1/ASR/CTC/train_with_wav2vec.py",
    "switchboard": "Switchboard/ASR/CTC/train_with_wav2vec.py",
}
HPARAMS = {"librispeech": ctc.HPARAMS_LIBRISPEECH,
           "dvoice": ctc.HPARAMS_DVOICE_DAR,
           "commonvoice": ctc.HPARAMS_COMMONVOICE_FR,
           "aishell": ctc.HPARAMS_AISHELL,
           "switchboard": ctc.HPARAMS_SWITCHBOARD}


def _write(name, root):
    """A synthetic corpus of ``name`` under ``root``; returns its folder."""
    data = root / name
    if name == "librispeech":
        librispeech_asr.write_synthetic_librispeech(
            str(data), {"train-clean-100": 4, "dev-clean": 2,
                        "test-clean": 2}, seconds=SECONDS, n_words=(2, 3),
            lexicon_size=12, seed=3)
    elif name == "dvoice":
        dvoice_prepare.write_synthetic_dvoice(str(data), COUNTS,
                                              seconds=SECONDS, missing=1,
                                              seed=3)
    elif name == "commonvoice":
        common_voice_prepare.write_synthetic_common_voice(
            str(data), COUNTS, language="fr", seconds=SECONDS, seed=3)
    elif name == "aishell":
        aishell_prepare.write_synthetic_aishell(str(data), COUNTS,
                                                seconds=SECONDS, seed=3)
    else:
        switchboard_prepare.write_synthetic_switchboard(
            str(data), conversations=3, turns=2, eval_segments=2,
            seconds=(0.5, 0.8), n_words=(2, 3), lexicon_size=12, seed=3)
    return data


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2v")
    return {name: _write(name, root) for name in SCRIPTS}


def _toy(name):
    return dict(TOY, **(LS if name == "librispeech" else {}),
                **({"dev_conversations": 1} if name == "switchboard" else {}))


def _build(name, corpora, out, **over):
    return ctc.build(str(corpora[name]), str(out), dict(_toy(name), **over),
                     RUN_OPTS, HPARAMS[name])


# ------------------------------------------------------------ preparation


def test_dvoice_prepare_writes_the_jax_manifests(corpora, tmp_path):
    """Both preparations on one language folder (a row of each table names
    a file that is missing): the same three manifests, byte for byte."""
    data = corpora["dvoice"]
    dvoice_prepare.prepare_dvoice(str(data), str(tmp_path / "port"))
    load_path("dvoice_prepare_jax", RECIPES / "DVoice/dvoice_prepare.py"
              ).prepare_dvoice(str(data), str(tmp_path / "jax"))
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    rows = json.loads((tmp_path / "port/train.json").read_text())
    assert len(rows) == COUNTS["train"]  # the missing file left out
    assert all(set(r) == {"wav", "duration", "words"} for r in rows.values())


# ------------------------------------------------------------ the yamls


@pytest.mark.parametrize("rel", sorted(ctc.YAMLS) + sorted(SSL_YAMLS))
def test_yaml_matches_the_dict(rel, tmp_path):
    """Each of the 17 yamls, loaded by JAX's ``load_hyperpyyaml``, against
    its dict: the shared values, the modules' fields, the optimizer's and
    the schedule's arguments."""
    hp = {**ctc.YAMLS, **SSL_YAMLS}[rel]
    y = load_yaml(RECIPES / rel, "", tmp_path)
    assert_yaml_values(y, hp, 10)
    ext, enc = y["extractor"], y["encoder"]
    assert (tuple(ext.out_channels), tuple(ext.kernel_sizes),
            tuple(ext.strides)) == (hp["latent_channels"],
                                    hp["kernel_sizes"], hp["strides"])
    assert (enc.in_dim, enc.embedding_dim, enc.num_layers, enc.nhead,
            enc.d_ffn, enc.dropout) == (
        hp["latent_channels"][-1], hp["embedding_dim"],
        hp["encoder_layers"], hp["nhead"], hp["d_ffn"], hp["encoder_dropout"])
    opt = y["opt_class"].keywords
    if rel in SSL_YAMLS:
        q = y["quantiser"]
        assert (q.in_dim, q.out_dim, q.quantiser_vars, q.quantiser_groups,
                y["proj"].n_neurons) == (
            hp["latent_channels"][-1], hp["target_dim"], hp["quantiser_vars"],
            hp["quantiser_groups"], hp["target_dim"])
        assert ((opt["b1"], opt["b2"]), opt["eps"]) == (hp["betas"],
                                                        hp["eps"])
        assert "weight_decay" not in opt  # optax's default 1e-4
        assert (y["noam_annealing"].lr_initial,
                y["noam_annealing"].n_warmup_steps) == (hp["lr"],
                                                        hp["n_warmup_steps"])
        assert set(y["modules"]) == {"extractor", "quantiser", "encoder",
                                     "proj"}
    else:
        assert (y["enc_dnn"].dnn_blocks, y["enc_dnn"].dnn_neurons,
                y["ctc_lin"].n_neurons) == (hp["dnn_blocks"],
                                            hp["dnn_neurons"],
                                            hp["output_neurons"])
        assert (opt["rho"], opt["eps"]) == (hp["rho"], hp["eps"])
        nb = y["lr_annealing"]
        assert (nb.hyperparam_value, nb.improvement_threshold,
                nb.annealing_factor, nb.patient) == (
            hp["lr"], hp["improvement_threshold"], hp["annealing_factor"],
            hp["patient"])
        assert set(y["modules"]) == {"extractor", "encoder", "enc_dnn",
                                     "ctc_lin"}
    assert "precision" not in y or y["precision"] == hp["precision"]


# ------------------------------------------------------------ the steps


def _jax_brain(cls, y):
    return cls(modules=y["modules"],
               opt_class=lambda lr: y["opt_class"](learning_rate=lr),
               hparams=y, run_opts={"noprogressbar": True})


def _wav2vec_state(pb):
    params = bridge.to_jax_wav2vec(pb.modules.state_dict())
    return params, {}, {}, bridge.to_jax_wav2vec


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("name", ["librispeech", "aishell"])
def test_ctc_step_matches_jax(corpora, tmp_path, name):
    """The ``ASR`` step (the extractor, the encoder without a mask or key
    padding, the DNN, the CTC head, the CTC loss) against the JAX script's
    on the recipe's first training batch, both in float64
    (``jax.enable_x64``; on the CPU the port's CTC runs its plain
    recursions, which keep float64): the loss within 1e-9 relative, each
    gradient within ``STEP_GRAD_TOL`` of its scale plus 1e-9 of the largest
    overall.  In float32 the lattices of these clips (T 400-800 frames,
    |log Z| up to ~7e3 at V 5000) carry the CTC occupancies' float32 error
    into the gradients: the port's own float32 gradients lay up to 5.4e-4
    (LibriSpeech) and 2.0e-3 (AISHELL-1) of their scale from its float64
    ones here."""
    parts = _build(name, corpora, tmp_path / "port")
    pb = parts["brain"]
    script = load_path(f"w2v_ctc_{name}_jax", RECIPES / SCRIPTS[name])
    y = load_yaml(RECIPES / SCRIPTS[name].replace(
        "train_with_wav2vec.py", "hparams/" + (
            "train_en_with_wav2vec.yaml" if name == "librispeech"
            else "train_with_wav2vec.yaml")), CTC_YAML, tmp_path)
    jb = _jax_brain(script.ASR, y)
    host = next(iter(parts["train_loader"])).numeric_dict()
    host["batch_mask"] = np.ones(host["sig"].shape[0])
    host = {k: v.double() if v.is_floating_point() else v
            for k, v in map(lambda kv: (kv[0], torch.as_tensor(kv[1])),
                            host.items())}
    with jax.enable_x64(True):
        params = _f64(bridge.to_jax_wav2vec(pb.modules.state_dict()))
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in host.items()}
        rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

        def loss_fn(p):
            return jb._loss_fn(p, {}, {}, jbatch, rngs, JStage.TRAIN)[0]

        jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            params))
    pb.modules.double().train()
    pb.dtype = torch.float64
    loss = pb.compute_objectives(pb.compute_forward(host, Stage.TRAIN), host,
                                 Stage.TRAIN)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-9)
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


class _Batch(dict):
    def numeric_dict(self):
        return dict(self)


def test_pretraining_step_matches_jax(corpora, tmp_path, monkeypatch):
    """``W2VBrain``'s step (the mask of step 1, the quantiser in training
    mode, the masked encoder, ``proj``, the negatives, the contrastive and
    diversity losses) against the JAX script's ``W2VBrain`` on a batch of
    the recipe's crops, with the Gumbel draw and the negatives' offsets
    handed to both (JAX's ``jax.random.uniform`` and ``randint`` return
    them)."""
    parts = pre.build(str(corpora["librispeech"]), str(tmp_path / "port"),
                      dict(PRE_TOY, **LS), RUN_OPTS)
    pb = parts["brain"]
    script = load_path("w2v_pretrain_jax", RECIPES / "LibriSpeech/"
                       "self-supervised-learning/wav2vec2/train.py")
    y = load_yaml(RECIPES / "LibriSpeech/self-supervised-learning/wav2vec2/"
                  "hparams/wav2vec2_base.yaml", PRE_YAML, tmp_path)
    jb = _jax_brain(script.W2VBrain, y)
    batch = next(iter(parts["train_loader"]))
    B, N = batch.sig.data.shape
    T = pb.modules.extractor.get_output_lengths(N)
    rng = np.random.default_rng(5)
    u = rng.uniform(size=(B * T * 2, 8)).astype(np.float32)
    off = rng.integers(1, T, size=(4, B, T))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k:
                        jnp.asarray(u).reshape(shape))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, *a, **k:
                        jnp.asarray(off).reshape(shape))
    pb.gumbel_uniform = lambda shape: torch.from_numpy(u).reshape(shape)
    pb.negative_offsets = lambda B, T: torch.from_numpy(off)
    jb.step = pb.step = 1
    assert pb.mask_for(B, T).any()
    assert_step_matches(pb, jb, _Batch(batch.numeric_dict()),
                        *_wav2vec_state(pb))


def test_greedy_cer_and_wer_match_jax(corpora, tmp_path):
    """The off-train scoring of one batch (the greedy CTC decode of the
    real rows, the CER on characters, the WER on the joined characters
    split at the spaces) against the JAX script's ``compute_objectives``
    at VALID, on log-probs with repeats, blanks and a short row."""
    parts = _build("librispeech", corpora, tmp_path / "port")
    brain, enc = parts["brain"], parts["label_encoder"]
    script = load_path("w2v_ctc_scoring_jax", RECIPES / SCRIPTS["librispeech"])
    jb = script.ASR(modules={}, hparams={"blank_index": 0},
                    run_opts={"noprogressbar": True})
    rng = np.random.default_rng(6)
    V = brain.modules.ctc_lin.weight.shape[0]
    logits = rng.standard_normal((3, 30, V)).astype(np.float32) * 3
    logits[:, ::2, 0] += 4.0  # blanks between characters
    space = enc.lab2ind[" "]
    logits[:, 7::9, space] += 9.0
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    words = ["AB CD", "EFG H", "IJ"]
    tokens = np.zeros((3, 5), np.int64)
    for i, w in enumerate(words):
        tokens[i, :len(w)] = enc.encode_sequence(list(w))
    lens = np.array([len(w) / 5 for w in words], np.float32)
    sig_lens = np.array([1.0, 0.8, 0.5], np.float32)
    batch = {"tokens": torch.from_numpy(tokens),
             "tokens_lens": torch.from_numpy(lens),
             "sig_lens": torch.from_numpy(sig_lens),
             "batch_mask": torch.ones(3)}
    brain.on_stage_start(Stage.VALID)
    brain.score(logp, batch)
    jb.label_encoder = enc
    jb.wer_metric, jb.cer_metric = JErrorRate(), JErrorRate()
    jb.compute_objectives(jnp.asarray(logp.numpy()),
                          {k: jnp.asarray(v.numpy()) for k, v in
                           batch.items()}, JStage.VALID)
    for port, jax_metric in ((brain.wer_metric, jb.wer_metric),
                             (brain.cer_metric, jb.cer_metric)):
        assert port.summarize("error_rate") == jax_metric.summarize(
            "error_rate")
        assert [s["hyp_tokens"] for s in port.scores] == [
            s["hyp_tokens"] for s in jax_metric.scores]
    assert 0 < brain.wer_metric.summarize("error_rate")


# ------------------------------------------------------------ the runs


@pytest.mark.parametrize("name", ["pretrain_librispeech",
                                  "pretrain_commonvoice", *SCRIPTS])
def test_run_resumes_bit_for_bit(corpora, tmp_path, name):
    """2 epochs equal 1 epoch plus a resumed one in a fresh Brain, bit for
    bit (the checkpoints keep the best validation loss or WER); a CTC
    recipe's test then writes its WER file."""
    if name.startswith("pretrain"):
        corpus = "librispeech" if name.endswith("librispeech") else (
            "commonvoice")
        hp = pre.HPARAMS if corpus == "librispeech" else (
            pre.HPARAMS_COMMONVOICE)
        toy = dict(PRE_TOY, **(LS if corpus == "librispeech" else {}))

        def build(folder, epochs):
            return pre.build(str(corpora[corpus]), str(tmp_path / folder),
                             dict(toy, **RESUME, number_of_epochs=epochs),
                             RUN_OPTS, hp)
    else:
        def build(folder, epochs):
            return _build(name, corpora, tmp_path / folder, **RESUME,
                          number_of_epochs=epochs)

    full = assert_resume_matches(build)
    brain = full["brain"]
    assert "lr_annealing" in brain.checkpointer.recoverables
    if name.startswith("pretrain"):
        assert set(brain.stage_stats) == {"VALID"}
        return
    brain.evaluate(full["test_loader"], min_key="WER")
    assert set(brain.stage_stats["TEST"]) == {"loss", "WER", "CER"}
    assert (tmp_path / "full/wer.txt").read_text().startswith("%WER")
    log = (tmp_path / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 3 and "test WER" in log[2]


# ------------------------------------------------------------ JAX's properties


def test_loss_covers_every_frame():
    """``ContrastiveLoss`` averages -log p(positive) over every (B, T)
    frame, masked or not (``losses.py:610``), in both packages; the
    published objective takes the masked frames only.  The JAX script
    passes no mask to it.  Copied."""
    rng = np.random.default_rng(7)
    e, q = (rng.standard_normal((2, 6, 4)).astype(np.float32)
            for _ in range(2))
    n = rng.standard_normal((3, 2, 6, 4)).astype(np.float32)
    cand = np.concatenate([q[None], n])
    cos = (e[None] * cand).sum(-1) / (np.linalg.norm(e, axis=-1)[None]
                                      * np.linalg.norm(cand, axis=-1) + 1e-8)
    logp = torch.log_softmax(torch.from_numpy(cos / 0.1), 0)[0].numpy()
    mask = JW.compute_mask((2, 6), [6, 6], 0.4, 2, seed=0)
    assert mask.any() and not mask.all()
    for value in (float(JContrastiveLoss(0.1)(e, q, n)),
                  float(ContrastiveLoss(0.1)(*map(torch.from_numpy,
                                                  (e, q, n))))):
        assert value == pytest.approx(-logp.mean(), rel=1e-6)
        assert value != pytest.approx(-logp[mask].mean(), rel=1e-3)
    text = (RECIPES / "LibriSpeech/self-supervised-learning/wav2vec2/"
            "train.py").read_text()
    assert "self.loss_fn(proj, targets, negatives)" in text


def test_temperature_never_anneals():
    """The JAX pretraining quantiser takes no temperature
    (``W2VTargetQuantiser.__call__``) and calls ``GumbelVectorQuantizer``
    without one, so it stays at ``temp_tuple[0]`` = 2.0
    (``quantisers.py:50-51``); the port's likewise, at every step."""
    assert "temp" not in inspect.signature(JW.W2VTargetQuantiser.__call__
                                           ).parameters
    assert "temp" not in inspect.getsource(JW.W2VTargetQuantiser.__call__)
    brain = pre.W2VBrain(dict(PRE_TOY, number_of_epochs=1), RUN_OPTS)
    q = brain.modules.quantiser.quantiser
    seen = []
    hook = q.register_forward_hook(lambda m, a, out: seen.append(out["temp"]))
    batch = {"sig": np.random.default_rng(8).standard_normal(
        (2, 4000)).astype(np.float32)}
    for _ in range(3):
        brain.step += 1
        brain.fit_batch(batch)
    hook.remove()
    assert brain.optimizer_step == 3 and seen == [2.0] * 3
    assert q.temp_tuple == (2.0, 0.5, 0.999995)


def test_padding_is_attended(corpora, tmp_path):
    """The CTC scripts call the encoder without ``wav_lens``
    (``train_with_wav2vec.py:41``): a short clip's log-probs at its own
    frames change with the padding a longer partner brings, in JAX's
    script and in the port alike (copied)."""
    parts = _build("librispeech", corpora, tmp_path / "port")
    pb = parts["brain"]
    script = load_path("w2v_ctc_padding_jax", RECIPES / SCRIPTS["librispeech"])
    y = load_yaml(RECIPES / "LibriSpeech/ASR/CTC/hparams/"
                  "train_en_with_wav2vec.yaml", CTC_YAML, tmp_path)
    jb = _jax_brain(script.ASR, y)
    params = bridge.to_jax_wav2vec(pb.modules.state_dict())
    rng = np.random.default_rng(9)
    short = rng.standard_normal(4000).astype(np.float32)
    T = pb.modules.extractor.get_output_lengths(4000)
    outs = {}
    for n in (4000, 6000):
        sig = np.zeros((2, n), np.float32)
        sig[0, :4000] = short
        sig[1] = rng.standard_normal(n)
        pb.modules.eval()
        with torch.no_grad():
            port = pb.compute_forward({"sig": torch.from_numpy(sig)},
                                      Stage.VALID)[0, :T].numpy()
        jb._bind(params, {}, {}, None, train=False)
        ref = np.asarray(jb.compute_forward({"sig": jnp.asarray(sig)},
                                            JStage.VALID))[0, :T]
        np.testing.assert_allclose(port, ref, atol=1e-4)
        outs[n] = port
    assert np.abs(outs[4000] - outs[6000]).max() > 1e-3
    assert "encoder(latents)" in (RECIPES / SCRIPTS["librispeech"]).read_text()


def test_what_self_step_counts(corpora, tmp_path, monkeypatch):
    """``int(self.step)``, the mask's seed, counts micro-batches (1, 2, ...
    in an epoch; the optimizer steps every ``grad_accumulation_factor``):
    ``speechbrain_tpu/core.py:1173``.  JAX's script reads it while
    ``jax.jit`` traces the step, so its mask is a constant of the compiled
    program: micro-batches 1 and 2 both train on step 1's.  The port draws
    the mask at every micro-batch from its step, and an intra-epoch
    checkpoint brings the count back."""
    script = load_path("w2v_pretrain_step_jax", RECIPES / "LibriSpeech/"
                       "self-supervised-learning/wav2vec2/train.py")
    y = load_yaml(RECIPES / "LibriSpeech/self-supervised-learning/wav2vec2/"
                  "hparams/wav2vec2_base.yaml", PRE_YAML, tmp_path)
    jb = _jax_brain(script.W2VBrain, y)
    assert jb.grad_accumulation_factor == 8  # the yaml's
    seeds = []

    def recording(*args, **kwargs):
        seeds.append(kwargs["seed"])
        return JW.compute_mask(*args, **kwargs)

    monkeypatch.setattr(script, "compute_mask", recording)
    batch = {"sig": np.random.default_rng(10).standard_normal(
        (2, 4000)).astype(np.float32)}
    for step in (1, 2):
        jb.step = step
        jb.fit_batch(batch)
    assert set(seeds) == {1} and jb.optimizer_step == 0
    out = tmp_path / "port"
    parts = pre.build(str(corpora["librispeech"]), str(out),
                      dict(PRE_TOY, **LS, grad_accumulation_factor=8),
                      RUN_OPTS)
    pb, port_seeds = parts["brain"], []
    monkeypatch.setattr(pre, "compute_mask",
                        lambda *a, **k: port_seeds.append(k["seed"])
                        or JW.compute_mask(*a, **k))
    for _ in range(3):
        pb.step += 1
        pb.fit_batch(batch)
    assert port_seeds == [1, 2, 3] and pb.optimizer_step == 0
    pb._save_intra_epoch_ckpt()
    fresh = pre.build(str(corpora["librispeech"]), str(out),
                      dict(PRE_TOY, **LS, grad_accumulation_factor=8),
                      RUN_OPTS)["brain"]
    fresh.checkpointer.recover_if_possible()
    assert fresh.step == 3


def test_switchboard_reads_the_rows_channel(corpora, tmp_path):
    """Switchboard's rows name a stereo SPHERE segment and a ``channel``
    (``switchboard_prepare.py:115-118``); the JAX script reads the segment
    whole, so a (B, N, 2) batch reaches ``W2VLatentExtractor``, whose
    ``x.ndim == 2`` test takes the two sides as ``conv_0``'s input
    channels.  The port reads the row's channel.  Its yaml names a
    ``test.json`` that is never written; the port tests on
    ``eval2000.json``."""
    parts = _build("switchboard", corpora, tmp_path / "port")
    hp = parts["hparams"]
    assert hp["test_json"].endswith("/eval2000.json")
    assert not Path(hp["save_folder"], "test.json").exists()
    row = next(iter(json.loads(Path(hp["train_json"]).read_text()).values()))
    stereo = j_read_audio(row["wav"])
    assert stereo.ndim == 2 and stereo.shape[1] == 2
    ds = parts["train_loader"].dataset
    sig = next(ds[i]["sig"] for i in range(len(ds))
               if ds[i]["id"] == next(iter(json.loads(
                   Path(hp["train_json"]).read_text()))))
    np.testing.assert_array_equal(sig, stereo[:, row["channel"]])
    ext = JW.W2VLatentExtractor(out_channels=(8,))
    shapes = jax.eval_shape(ext.init, jax.random.PRNGKey(0),
                            jnp.asarray(stereo[None, :2000]))
    assert shapes["params"]["conv_0"]["kernel"].shape == (11, 2, 8)


def test_inventory_against_output_neurons(corpora, tmp_path):
    """LibriSpeech's characters (26 letters, the apostrophe, the space)
    and the blank fill its 29 outputs exactly; an inventory past
    ``output_neurons`` gives labels past the CTC head, which the JAX
    scripts do not check: the port raises, naming the size."""
    letters = [chr(c) for c in range(ord("A"), ord("Z") + 1)] + ["'", " "]
    assert len(letters) + 1 == ctc.HPARAMS_LIBRISPEECH["output_neurons"]
    assert (ctc.HPARAMS_DVOICE_DAR["output_neurons"],
            ctc.HPARAMS_COMMONVOICE_FR["output_neurons"],
            ctc.HPARAMS_AISHELL["output_neurons"]) == (76, 76, 5000)
    for name in ("dvoice", "aishell"):
        n = len(_build(name, corpora, tmp_path / name)["label_encoder"])
        assert n <= HPARAMS[name]["output_neurons"]
        with pytest.raises(ValueError, match=f"{n} labels"):
            _build(name, corpora, tmp_path / f"{name}_small",
                   output_neurons=n - 1)
    text = (RECIPES / SCRIPTS["dvoice"]).read_text()
    assert "output_neurons" not in text


def test_schedules_are_checkpointed_where_the_jax_scripts_do_not(
        corpora, tmp_path):
    """Neither JAX script registers its NewBob or Noam schedule with the
    checkpointer (a resumed run restarts it); the port's Brains register
    them, so a resumed run continues the schedule."""
    for rel in (SCRIPTS["librispeech"], "LibriSpeech/self-supervised-"
                "learning/wav2vec2/train.py"):
        text = (RECIPES / rel).read_text()
        assert "add_recoverable" not in text
        assert "lr_annealing(" in text or "noam_annealing()" in text
    out = tmp_path / "out"
    parts = pre.build(str(corpora["librispeech"]), str(out),
                      dict(PRE_TOY, **LS, number_of_epochs=1), RUN_OPTS)
    parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                       parts["valid_loader"])
    steps = parts["brain"].lr_annealing.n_steps
    assert steps > 0
    ckpt = next((out / "save").glob("CKPT*"))
    assert (ckpt / "lr_annealing.ckpt").exists()
    fresh = pre.build(str(corpora["librispeech"]), str(out),
                      dict(PRE_TOY, **LS), RUN_OPTS)["brain"]
    fresh.checkpointer.recover_if_possible()
    assert fresh.lr_annealing.n_steps == steps


def test_jax_scripts_ignore_precision(corpora, tmp_path):
    """The LibriSpeech yamls set ``precision: bf16``, but no wav2vec
    script casts (the modules run in the input's float32); the port runs
    the Brain's precision."""
    for rel in list(SCRIPTS.values()) + [
            "LibriSpeech/self-supervised-learning/wav2vec2/train.py"]:
        text = (RECIPES / rel).read_text()
        assert "bfloat16" not in text and "self.precision" not in text
    parts = _build("librispeech", corpora, tmp_path / "port",
                   precision="bf16")
    brain = parts["brain"]
    seen = []
    hook = brain.modules.extractor.register_forward_hook(
        lambda m, a, out: seen.append(out.dtype))
    brain.step = 1
    brain.fit_batch(next(iter(parts["train_loader"])))
    hook.remove()
    assert seen == [torch.bfloat16]
