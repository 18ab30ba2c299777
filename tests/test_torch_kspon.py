"""The KsponSpeech recipes on the port against the JAX recipes:
``recipes/ksponspeech_prepare.py`` (``convert_to_wav``,
``prepare_ksponspeech``, ``normalize``), ``recipes/ksponspeech_asr.py``
(``conformer_medium.yaml``) and the LM (``lm_training.HPARAMS_KSPON``,
``LM/hparams/transformer.yaml``), the JAX scripts taken by path.

A synthetic corpus (``write_synthetic_kspon``: raw ``.pcm`` files, the
``.trn`` indexes with ``(A)/(B)`` pairs, ``n/ b/ o/ l/ u/`` markers and
punctuation) goes through both.  Tolerances:

- the converted WAVs and the manifests: byte for byte;
- ``normalize``: equal strings, case by case;
- the ASR step (the recipe's first training batch at toy widths, f32,
  through the JAX script's ``ASR._loss_fn`` at the port's weights): the
  loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
  largest plus 1e-6 of the largest overall (f32 sums in other orders),
  the conv front end's first kernel within 5e-4 of its largest (its
  gradient sums the features, which differ by up to 2e-3 dB between the
  frameworks' Fbanks), the front end's biases, which a training-mode
  BatchNorm removes, within 1e-5 of the largest overall;
- the LM step: the same bounds against the JAX script's ``LM._loss_fn``;
- the CER: equal to JAX's arithmetic on the same words;
- a resumed run: bit for bit.
"""

import json
import shutil
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
from speechbrain_tpu_torch.recipes import ksponspeech_asr as recipe
from speechbrain_tpu_torch.recipes import ksponspeech_prepare as prep
from speechbrain_tpu_torch.recipes import librispeech_asr
from speechbrain_tpu_torch.recipes import lm_training
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

from .test_torch_kernels import jax_value_and_grad, one_torch_thread  # noqa: F401
from .test_torch_transformer_encoder_asr import (
    CONFORMER_TOY,
    GRAD_SHARE,
    LOSS_RTOL,
    RESUME,
    assert_same_files,
    assert_resume_matches,
    assert_step_matches,
    assert_transformer_yaml,
    assert_yaml_values,
    conformer_jax_state,
    conformer_yaml_toy,
    jax_recipe_brain,
    load_path,
    load_yaml,
)

REPO = Path(__file__).resolve().parents[1]
KSPON = REPO / "recipes/KsponSpeech"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
COUNTS = {"train": 8, "dev": 2, "eval_clean": 2, "eval_other": 2}
LM_TOY = dict(vocab_size=40, d_model=16, nhead=2, num_layers=1, d_ffn=32,
              dropout=0.0, batch_size=4, number_of_epochs=2,
              n_warmup_steps=5)


def _corpus(root):
    data = root / "KsponSpeech"
    prep.write_synthetic_kspon(str(data), COUNTS, seconds=(1.0, 1.3),
                               n_words=(2, 4), lexicon_size=16, seed=3)
    prep.convert_all(str(data))
    return data


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("kspon"))


@pytest.mark.parametrize("raw,want", [
    ("(70%)/(칠십 퍼센트) 정도", "70% 정도"),
    ("n/ 아 b/ 그래서 o/ 요 l/ u/", "아 그래서 요"),
    ("뭐+ 했어? 진짜! 그래, 응.", "뭐 했어 진짜 그래 응"),
    ("*음* 그 (3G)/(쓰리 쥐)/ 폰", "음 그 3G 폰"),
    ("  여러   칸  ", "여러 칸"),
])
def test_normalize_matches_jax(raw, want):
    """KsponSpeech's transcript rules, case by case, against JAX's."""
    jprep = load_path("kspon_prepare_jax", KSPON / "ksponspeech_prepare.py")
    assert prep.normalize(raw) == jprep.normalize(raw) == want


def test_convert_and_prepare_write_the_jax_files(tmp_path):
    """``convert_to_wav`` writes JAX's WAV bytes; ``prepare_ksponspeech``
    (all four splits, train and dev merged) writes JAX's manifests."""
    data = tmp_path / "KsponSpeech"
    prep.write_synthetic_kspon(str(data), COUNTS, seconds=(0.3, 0.5),
                               n_words=(2, 6), lexicon_size=16, seed=5)
    jconv = load_path("kspon_convert_jax", KSPON / "convert_to_wav.py")
    pcms = sorted(data.glob("**/*.pcm"))
    assert len(pcms) == sum(COUNTS.values())
    for pcm in pcms:
        jconv.convert_to_wav(pcm)
    jwavs = {p: p.with_suffix(".wav").read_bytes() for p in pcms}
    for p in pcms:
        p.with_suffix(".wav").unlink()
    prep.convert_all(str(data))
    for p in pcms:
        assert p.with_suffix(".wav").read_bytes() == jwavs[p], p
    jprep = load_path("kspon_prepare_jax", KSPON / "ksponspeech_prepare.py")
    kwargs = dict(tr_splits=["train"], dev_splits=["dev"],
                  te_splits=["eval_clean", "eval_other"],
                  merge_lst=["train", "dev"], merge_name="train_dev.json")
    prep.prepare_ksponspeech(str(data), str(tmp_path / "port"), **kwargs)
    jprep.prepare_ksponspeech(str(data), str(tmp_path / "jax"), **kwargs)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    dev = json.loads((tmp_path / "port/dev.json").read_text("utf-8"))
    assert len(dev) == COUNTS["dev"]
    assert all(r["wav"].endswith(".wav") and "/" not in r["wrd"]
               for r in dev.values())


def test_yamls_match_the_dicts(tmp_path):
    """``conformer_medium.yaml`` against ``HPARAMS`` and the LM's
    ``transformer.yaml`` against ``lm_training.HPARAMS_KSPON``."""
    y = load_yaml(KSPON / "ASR/transformer/hparams/conformer_medium.yaml", "",
                  tmp_path)
    assert_yaml_values(y, recipe.HPARAMS, 35)
    assert_transformer_yaml(y, recipe.HPARAMS)
    assert y["test_splits"] == ["eval_clean", "eval_other"]
    assert (recipe.HPARAMS["d_model"], recipe.HPARAMS["lm_model"]["d_model"],
            recipe.HPARAMS["grad_accumulation_factor"],
            recipe.HPARAMS["max_batch_length"]) == (256, 768, 4, 300)
    y = load_yaml(KSPON / "LM/hparams/transformer.yaml", "", tmp_path)
    hp = lm_training.HPARAMS_KSPON
    assert_yaml_values(y, hp, 15)
    m = y["model"]
    assert (m.vocab, m.d_model, m.nhead, m.num_encoder_layers, m.d_ffn,
            m.dropout, m.activation, m.normalize_before) == (
        hp["vocab_size"], hp["d_model"], hp["nhead"], hp["num_layers"],
        hp["d_ffn"], hp["dropout"], "gelu", False)
    assert (y["lr_annealing"].lr_initial,
            y["lr_annealing"].n_warmup_steps) == (hp["lr"],
                                                  hp["n_warmup_steps"])


def test_asr_step_matches_jax(corpus, tmp_path):
    """The recipe's first training batch through the port's
    ``KsponASRBrain`` and the JAX script's ``ASR`` at the same weights."""
    parts = recipe.build(str(corpus), str(tmp_path / "port"), CONFORMER_TOY,
                         RUN_OPTS)
    pb = parts["brain"]
    script = load_path("kspon_train_jax", KSPON / "ASR/transformer/train.py")
    jb = jax_recipe_brain(script, load_yaml(
        KSPON / "ASR/transformer/hparams/conformer_medium.yaml",
        conformer_yaml_toy(), tmp_path))
    params, model_state, extra, grads = conformer_jax_state(pb)
    batch = next(iter(parts["train_loader"]))
    assert_step_matches(pb, jb, batch, params, model_state, extra, grads)


def test_cer_strips_the_spaces_as_jax_does():
    """The CER of ``KsponASRBrain._score_words``: over the characters of
    the words joined without spaces (``train.py:108-113``), against JAX's
    metric on the same lists; the WER beside it."""
    predicted = [["나는", "학교에", "간다"], ["좋아"]]
    targets = [["나는", "학교", "에", "간다"], ["좋아요"]]
    brain = recipe.KsponASRBrain.__new__(recipe.KsponASRBrain)
    brain.wer_metric, brain.cer_metric = ErrorRateStats(), ErrorRateStats()
    brain._score_words(["0", "1"], predicted, targets)
    jwer, jcer = JErrorRate(), JErrorRate()
    jwer.append(["0", "1"], predicted, targets)
    jcer.append(["0", "1"], [list("".join(p)) for p in predicted],
                [list("".join(t)) for t in targets])
    assert brain.stage_metrics() == {
        "WER": jwer.summarize("error_rate"),
        "CER": jcer.summarize("error_rate")}
    # one deletion in 10 characters; the WER counts 3 errors in 5 words
    assert brain.stage_metrics()["CER"] == pytest.approx(10.0)
    assert brain.stage_metrics()["WER"] == pytest.approx(60.0)


def test_run_tests_both_splits_and_resumes_bit_for_bit(corpus, tmp_path):
    """2 epochs (the validation's WER and CER, the best by WER kept) equal
    1 epoch plus a resumed one in a fresh Brain, bit for bit; then
    ``eval_clean`` and ``eval_other`` from the best checkpoint, each with
    its ``wer_<split>.txt`` (the WER's details, then the CER's)."""
    def build(name, epochs):
        return recipe.build(str(corpus), str(tmp_path / name),
                            dict(CONFORMER_TOY, **RESUME,
                                 number_of_epochs=epochs), RUN_OPTS)

    full = librispeech_asr.fit_and_test(assert_resume_matches(build))
    assert set(full.test_stats) == {"eval_clean", "eval_other"}
    for stats in full.test_stats.values():
        assert set(stats) == {"loss", "WER", "CER"}
    for split in ("eval_clean", "eval_other"):
        text = (tmp_path / f"full/wer_{split}.txt").read_text()
        assert text.count("\nScored ") == 2 and text.startswith("%WER")
    log = (tmp_path / "full/train_log.txt").read_text().splitlines()
    assert len(log) == 4 and "valid CER" in log[0]


def lm_step_matches(script_path, yaml_path, hp, tmp_path, bos=1, eos=2):
    """The LM Brain's loss and gradients on a ragged token batch against
    the JAX script's ``LM._loss_fn`` at the same weights."""
    pb = lm_training.LM(hp, RUN_OPTS)
    script = load_path(f"lm_jax_{hp['corpus']}", script_path)
    jhp = load_yaml(yaml_path, (
        f"vocab_size: {hp['vocab_size']}\nd_model: {hp['d_model']}\n"
        f"nhead: {hp['nhead']}\nnum_layers: {hp['num_layers']}\n"
        f"d_ffn: {hp['d_ffn']}\ntransformer_dropout: 0.0\n"), tmp_path)
    jb = script.LM(modules=jhp["modules"],
                   opt_class=lambda lr: jhp["opt_class"](learning_rate=lr),
                   hparams=jhp, run_opts={"noprogressbar": True})
    sd = pb.modules.model.state_dict()
    params = jax.tree_util.tree_map(
        jnp.asarray, {"model": bridge.to_jax_transformer_lm(sd)})
    rng = np.random.default_rng(7)
    n = np.array([7, 5, 3, 6])
    tok = rng.integers(3, hp["vocab_size"], (4, 7))
    tok[np.arange(7)[None, :] >= n[:, None]] = 0
    host = {"tokens_bos": np.concatenate([np.full((4, 1), bos), tok], 1),
            "tokens_eos": np.concatenate([tok, np.zeros((4, 1), int)], 1),
            "tokens_eos_lens": ((n + 1) / 8).astype(np.float32)}
    host["tokens_eos"][np.arange(4), n] = eos
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jbatch["batch_mask"] = jnp.ones(4, jnp.float32)
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

    def loss_fn(p):
        loss, _ = jb._loss_fn(p, {}, {}, jbatch, rngs, JStage.TRAIN)
        return loss, None

    (jloss, _), jgrads = jax_value_and_grad(loss_fn)(params)
    pb.modules.train()
    batch = pb.prepare_batch(host)
    loss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                 batch, Stage.TRAIN)
    named = dict(pb.modules.model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(
        float(jloss))
    gsd = dict(sd)
    gsd.update(dict(zip(named, grads)))
    got = bridge.to_jax_transformer_lm(gsd)
    want = jax.tree_util.tree_map(np.asarray, jgrads)["model"]
    paths_g = jax.tree_util.tree_leaves_with_path(got)
    paths_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in paths_g] == [k for k, _ in paths_w]
    top = max(float(np.abs(w).max()) for _, w in paths_w)
    for (path, g), (_, w) in zip(paths_g, paths_w):
        np.testing.assert_allclose(
            g, w, rtol=0,
            atol=GRAD_SHARE * float(np.abs(w).max()) + 1e-6 * top,
            err_msg=jax.tree_util.keystr(path))


def test_lm_step_matches_jax(tmp_path):
    """``LM`` with ``HPARAMS_KSPON`` at toy widths against
    ``recipes/KsponSpeech/LM/train.py``'s ``LM``."""
    lm_step_matches(KSPON / "LM/train.py", KSPON / "LM/hparams/transformer.yaml",
                    dict(lm_training.HPARAMS_KSPON, **LM_TOY), tmp_path)


def test_lm_trains_on_the_asr_tokenizer_fuses_and_resumes(corpus, tmp_path):
    """The LM recipe on the KsponSpeech manifests (train, dev, eval_clean;
    ``wrd``) with the ASR recipe's tokenizer file: 1 epoch plus a resumed
    one equals 2 epochs bit for bit; its ``lm.ckpt`` loads into the ASR
    recipe as the yaml's ``lm_model``, fused at 0.6."""
    asr = recipe.build(str(corpus), str(tmp_path / "asr"), CONFORMER_TOY,
                       RUN_OPTS)
    tok = asr["brain"].tokenizer.prefix_model_file
    hp = lm_training.HPARAMS_KSPON

    def build(name, epochs):
        return lm_training.build(str(corpus), str(tmp_path / name),
                                 dict(LM_TOY, number_of_epochs=epochs),
                                 RUN_OPTS, hp, tokenizer_file=tok)

    assert_resume_matches(build)
    lm_training.run(str(corpus), str(tmp_path / "lm"), LM_TOY, RUN_OPTS, hp,
                    tokenizer_file=tok)
    manifests = {p.name for p in (tmp_path / "lm/save").glob("*.json")}
    assert {"train.json", "dev.json", "eval_clean.json"} <= manifests
    shutil.rmtree(tmp_path / "asr")
    fused = recipe.build(str(corpus), str(tmp_path / "asr"), CONFORMER_TOY, dict(
        RUN_OPTS, lm_ckpt=str(tmp_path / "lm/lm.ckpt")))["brain"]
    assert fused.lm is not None
    assert fused.config["lm_weight"] == 0.6
    assert fused.config["ctc_weight_decode"] == 0.4
