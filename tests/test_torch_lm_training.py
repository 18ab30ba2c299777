"""The LM training recipes on the port (``recipes/lm_training``,
``recipes/timers_and_such_prepare``) against the JAX recipes
(``recipes/LibriSpeech/LM/train.py``, ``recipes/timers-and-such/LM/
train.py`` and ``prepare.py``, taken by path) on the CPU, and the
handoff of the trained LMs to the ASR recipes' searches.

- The yamls (``RNNLM.yaml``, ``transformer.yaml``, the timers-and-such
  ``train.yaml``), loaded by JAX's ``load_hyperpyyaml``, against
  ``HPARAMS_RNNLM``, ``HPARAMS_TRANSFORMER`` and ``HPARAMS_TAS``; the
  bos/eos that differ on purpose (``HPARAMS_RNNLM``'s 0) are named.
- One training step of each dict's LM at toy widths (an RNNLM of 2 x 16,
  a TransformerLM of 1 x 16, 2 heads; dropout 0) on ragged token rows
  with bos and eos given explicitly: the loss within 1e-5 relative and
  every gradient within 1e-4 of its tensor's largest magnitude plus 1e-6
  of the largest over all (f32 sums in other orders).
- ``prepare_TAS`` writes the JAX script's manifests, byte for byte.
- ``run`` on synthetic corpora with each dict: NewBob or Noam, the log,
  the best checkpoint by ppl and ``lm.ckpt``; two epochs resumed after
  the first in a fresh Brain equal two uninterrupted ones bit for bit
  (the model, Adam's moments, the rate and the schedule's state).
- The LMs trained on the ASR recipes' tokenizer files load into the
  recipes' searches through ``run_opts["lm_ckpt"]`` (the RNNLM into
  ``librispeech_seq2seq``, the TransformerLM into ``librispeech_asr``),
  and the fused scores differ from the same search at ``lm_weight`` 0.
"""

import importlib.util
import json
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
from speechbrain_tpu_torch.recipes import librispeech_asr, librispeech_seq2seq
from speechbrain_tpu_torch.recipes import lm_training as recipe
from speechbrain_tpu_torch.recipes.timers_and_such_prepare import (
    prepare_TAS,
    write_synthetic_tas,
)

from .test_torch_kernels import jax_value_and_grad, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LS_LM = REPO / "recipes/LibriSpeech/LM"
TAS_DIR = REPO / "recipes/timers-and-such"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
LOSS_RTOL, GRAD_SHARE = 1e-5, 1e-4
V = 40
TOY = {
    "rnnlm": dict(vocab_size=V, emb_dim=8, rnn_layers=2, rnn_neurons=16,
                  dnn_neurons=12, dropout=0.0),
    "transformer": dict(vocab_size=V, d_model=16, nhead=2, num_layers=1,
                        d_ffn=32, dropout=0.0),
    "tas": dict(vocab_size=V, emb_dim=8, rnn_layers=2, rnn_neurons=16,
                dnn_neurons=12, dropout=0.0),
}
DICTS = {"rnnlm": recipe.HPARAMS_RNNLM,
         "transformer": recipe.HPARAMS_TRANSFORMER, "tas": recipe.HPARAMS_TAS}
YAML_TOY = {
    "rnnlm": f"vocab_size: {V}\nemb_dim: 8\nrnn_neurons: 16\n"
             "dnn_neurons: 12\nrnn_dropout: 0.0\n",
    "transformer": f"vocab_size: {V}\nd_model: 16\nnhead: 2\nnum_layers: 1\n"
                   "d_ffn: 32\ntransformer_dropout: 0.0\n",
    "tas": f"vocab_size: {V}\n" + """
model: !new:speechbrain_tpu.lobes.models.RNNLM.RNNLM
    output_neurons: !ref <vocab_size>
    embedding_dim: 8
    rnn_layers: 2
    rnn_neurons: 16
    dnn_blocks: 1
    dnn_neurons: 12
    dropout: 0.0
""",
}
YAML_PATHS = {"rnnlm": LS_LM / "hparams/RNNLM.yaml",
              "transformer": LS_LM / "hparams/transformer.yaml",
              "tas": TAS_DIR / "LM/hparams/train.yaml"}
SCRIPTS = {"rnnlm": LS_LM / "train.py", "transformer": LS_LM / "train.py",
           "tas": TAS_DIR / "LM/train.py"}


def _load_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(DICTS))
def test_yaml_matches_the_dict(name, tmp_path):
    """The values the yaml and the dict share (bos and eos apart, where
    ``HPARAMS_RNNLM`` trains with 0: the seq2seq fusion's), the model's
    fields and the schedule's."""
    hp = DICTS[name]
    with open(YAML_PATHS[name]) as f:
        y = load_hyperpyyaml(f, {"data_folder": str(tmp_path),
                                 "output_folder": str(tmp_path)})
    differ = {"bos_index", "eos_index"} if name == "rnnlm" else set()
    shared = [k for k in hp if k in y and k not in differ | {"model"}]
    assert len(shared) >= 8
    for key in shared:
        assert y[key] == hp[key], key
    if name == "rnnlm":
        assert (y["bos_index"], y["eos_index"]) == (1, 2)
        assert (hp["bos_index"], hp["eos_index"]) == (0, 0)
    m = y["model"]
    assert type(m).__name__ == ("TransformerLM" if name == "transformer"
                                else "RNNLM")
    if name == "transformer":
        assert (m.vocab, m.d_model, m.nhead, m.num_encoder_layers, m.d_ffn,
                m.dropout, m.activation, m.normalize_before) == (
            hp["vocab_size"], hp["d_model"], hp["nhead"], hp["num_layers"],
            hp["d_ffn"], hp["dropout"], "gelu", False)
    else:
        assert (m.output_neurons, m.embedding_dim, m.rnn_layers,
                m.rnn_neurons, m.dnn_blocks, m.dnn_neurons, m.dropout) == (
            hp["vocab_size"], hp["emb_dim"], hp["rnn_layers"],
            hp["rnn_neurons"], hp["dnn_blocks"], hp["dnn_neurons"],
            hp["dropout"])
    s = y["lr_annealing"]
    if hp["schedule"] == "noam":
        assert type(s).__name__ == "NoamScheduler"
        assert (s.lr_initial, s.n_warmup_steps) == (hp["lr"],
                                                    hp["n_warmup_steps"])
    else:
        assert (type(s).__name__, s.hyperparam_value, s.annealing_factor,
                s.improvement_threshold, s.patient) == (
            "NewBobScheduler", hp["lr"], hp["annealing_factor"],
            hp["improvement_threshold"], hp["patient"])


def test_jax_lm_script_trains_its_own_tokenizer():
    """JAX's ``LM/train.py`` trains a tokenizer on the LM text in the LM's
    save folder, although ``RNNLM.yaml`` says it is shared with the ASR
    recipe: the port's ``run`` takes the ASR recipe's model file."""
    text = (LS_LM / "train.py").read_text()
    assert 'model_dir=hparams["save_folder"]' in text
    assert 'annotation_train=hparams["train_text"]' in text
    assert "shared with the ASR recipe" in (
        LS_LM / "hparams/RNNLM.yaml").read_text()


def _token_batch(seed, bos, eos, B=4, L=7):
    """Ragged rows of 3 to L tokens in 3..V-1, with bos and eos given."""
    rng = np.random.default_rng(seed)
    n = np.array([L, 5, 3, 6])[:B]
    tok = rng.integers(3, V, (B, L))
    tok[np.arange(L)[None, :] >= n[:, None]] = 0
    bos_col = np.full((B, 1), bos)
    tokens_bos = np.concatenate([bos_col, tok], 1)
    tokens_eos = np.concatenate([tok, np.zeros((B, 1), tok.dtype)], 1)
    tokens_eos[np.arange(B), n] = eos
    return {"tokens_bos": tokens_bos, "tokens_eos": tokens_eos,
            "tokens_eos_lens": ((n + 1) / (L + 1)).astype(np.float32)}


@pytest.mark.parametrize("name", list(DICTS))
@pytest.mark.parametrize("bos,eos", [(0, 0), (1, 2)])
def test_step_matches_jax(name, bos, eos, tmp_path):
    """``LM``'s loss and gradients against the JAX recipe's
    ``LM._loss_fn`` from the same weights (the port's, through the
    bridge) and the same batch."""
    hp = dict(DICTS[name], **TOY[name], bos_index=bos, eos_index=eos)
    pb = recipe.LM(hp, RUN_OPTS)
    train = _load_path(f"lm_train_jax_{name}", SCRIPTS[name])
    with open(YAML_PATHS[name]) as f:
        jhp = load_hyperpyyaml(f, YAML_TOY[name]
                               + f"data_folder: {tmp_path}\n"
                               f"output_folder: {tmp_path / 'jax'}\n")
    jb = train.LM(modules=jhp["modules"],
                  opt_class=lambda lr: jhp["opt_class"](learning_rate=lr),
                  hparams=jhp, run_opts={"noprogressbar": True})
    sd = pb.modules.model.state_dict()
    to_jax = (bridge.to_jax_transformer_lm if name == "transformer"
              else bridge.to_jax_rnnlm)
    params = jax.tree_util.tree_map(jnp.asarray, {"model": to_jax(sd)})
    host = _token_batch(7, bos, eos)
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
    got = to_jax(gsd)
    want = jax.tree_util.tree_map(np.asarray, jgrads)["model"]
    paths_g = jax.tree_util.tree_leaves_with_path(got)
    paths_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in paths_g] == [k for k, _ in paths_w]
    top = max(float(np.abs(w).max()) for _, w in paths_w)
    for (path, g), (_, w) in zip(paths_g, paths_w):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_SHARE * float(np.abs(w).max()) + 1e-6 * top,
            err_msg=jax.tree_util.keystr(path))


def test_prepare_tas_writes_the_jax_manifests(tmp_path):
    """Both preparations on one synthetic corpus (two splits missing):
    the same files, byte for byte."""
    data = tmp_path / "TAS"
    write_synthetic_tas(str(data), {"train-synth": 5, "train-real": 3,
                                    "dev-real": 2, "test-real": 2},
                        seconds=(0.2, 0.3), seed=2)
    jprep = _load_path("tas_prepare_jax", TAS_DIR / "prepare.py")
    splits = ["train-synth", "train-real"]
    prepare_TAS(str(data), str(tmp_path / "port"), splits)
    jprep.prepare_TAS(str(data), str(tmp_path / "jax"), splits)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "train.json" in files and "dev-synth.json" not in files
    for name in files:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    train = json.loads((tmp_path / "port/train.json").read_text())
    assert len(train) == 8
    assert all("|" in r["semantics"] and "," not in r["semantics"]
               for r in train.values())


# ------------------------------------------------------------ recipes


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A LibriSpeech tree, the ASR recipes' tokenizers (vocab 40: the
    conformer recipe's and the seq2seq recipe's builds train them), LM
    text from the tree's words and a Timers-and-Such corpus."""
    root = tmp_path_factory.mktemp("lm_recipes")
    data = str(root / "LibriSpeech")
    librispeech_asr.write_synthetic_librispeech(
        data, {"train-clean-100": 8, "dev-clean": 3, "test-clean": 2},
        seconds=(1.0, 1.3), n_words=(2, 4), lexicon_size=24, seed=4)
    asr = librispeech_asr.build(data, str(root / "asr"), dict(
        librispeech_asr.HPARAMS, **ASR_TOY), RUN_OPTS)
    s2s = librispeech_seq2seq.build(data, str(root / "s2s"), S2S_TOY,
                                    RUN_OPTS)
    words = [w for r in json.loads(
        (root / "asr/save/train.json").read_text()).values()
        for w in r["words"].split()]
    recipe.write_synthetic_text(str(root / "text"),
                                {"train": 24, "valid": 6, "test": 6}, words,
                                n_words=(3, 9), seed=1)
    write_synthetic_tas(str(root / "TAS"), {
        "train-synth": 20, "train-real": 6, "dev-real": 6, "test-real": 6},
        seconds=(0.2, 0.3), seed=3)
    return {"root": root, "data": data,
            "asr": asr, "s2s": s2s,
            "tokenizer": {
                "rnnlm": s2s["brain"].tokenizer.prefix_model_file,
                "transformer": asr["brain"].tokenizer.prefix_model_file,
                "tas": None}}


ASR_TOY = dict(
    train_splits=["train-clean-100"], test_splits=["test-clean"],
    vocab_size=V, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
    d_ffn=64, kernel_size=7, transformer_dropout=0.0, augmentation=None,
    n_warmup_steps=4, number_of_epochs=1, max_batch_length=4.8,
    num_buckets=2, num_workers=0, valid_beam_size=2, test_beam_size=2,
    precision="fp32",
    lm_model=dict(d_model=16, nhead=2, num_encoder_layers=1, d_ffn=32,
                  activation="gelu", normalize_before=False))
S2S_TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8,
               dnn_blocks=1, dnn_neurons=8, emb_size=8, dec_neurons=16,
               attn_dim=12, vocab_size=V, dropout=0.0, batch_size=4,
               number_of_epochs=1, precision="fp32",
               train_splits=["train-clean-100"], valid_beam_size=3,
               test_beam_size=4, max_attn_shift=20, lm_emb_dim=8,
               lm_rnn_layers=2, lm_rnn_neurons=16, lm_dnn_neurons=12)


def _lm_overrides(name, epochs):
    return dict(TOY[name], batch_size=8, number_of_epochs=epochs,
                n_warmup_steps=5, dropout=0.1)


def _corpus_folder(corpora, name):
    return str(corpora["root"] / ("TAS" if name == "tas" else "text"))


@pytest.fixture(scope="module")
def trained(corpora):
    """Each dict through ``run``: two epochs on its corpus (the
    LibriSpeech LMs on the ASR recipes' tokenizer files)."""
    out = {}
    for name in DICTS:
        folder = corpora["root"] / f"run_{name}"
        brain = recipe.run(_corpus_folder(corpora, name), str(folder),
                           _lm_overrides(name, 2), RUN_OPTS, DICTS[name],
                           tokenizer_file=corpora["tokenizer"][name])
        out[name] = (folder, brain)
    return out


@pytest.mark.parametrize("name", list(DICTS))
def test_run_trains_logs_and_writes_lm_ckpt(corpora, trained, name):
    """The log's lines, the rate (Noam after each step, or NewBob after
    each validation), the checkpoint kept by ppl and ``lm.ckpt`` holding
    the best model's weights."""
    folder, brain = trained[name]
    for stage in ("VALID", "TEST"):
        stats = brain.stage_stats[stage]
        assert set(stats) == {"loss", "ppl"}
        assert stats["ppl"] == pytest.approx(np.exp(stats["loss"]))
    log = (folder / "train_log.txt").read_text().splitlines()
    assert len(log) == 3 and log[2].startswith("Epoch loaded: 2 - test loss")
    assert "valid ppl" in log[0]
    if DICTS[name]["schedule"] == "noam":
        n = brain.lr_annealing.n_steps
        assert n == brain.optimizer_step and n > 0
        assert brain.lr == brain.lr_annealing.current_lr
    else:
        assert len(brain.lr_annealing.metric_values) == 2
    ckpt = brain._recovered_ckpt
    logged = [float(line.split("valid ppl: ")[1]) for line in log[:2]]
    assert abs(ckpt.meta["ppl"] - min(logged)) <= 0.01
    assert "lr_annealing.ckpt" in {f.name for f in ckpt.path.iterdir()}
    state = torch.load(folder / "lm.ckpt", weights_only=True)
    model = brain.modules.model.state_dict()
    assert state.keys() == model.keys()
    assert all(torch.equal(state[k], model[k]) for k in state)
    tokenizer = corpora["tokenizer"][name]
    if tokenizer is not None:  # the ASR recipe's file, not a new one
        copy = folder / "save" / Path(tokenizer).name
        assert copy.read_bytes() == Path(tokenizer).read_bytes()


def _final_state(brain):
    return ({k: v.clone() for k, v in brain.modules.state_dict().items()},
            brain.optimizer.state_dict()["state"], brain.lr,
            brain.lr_annealing)


@pytest.mark.parametrize("name", list(DICTS))
def test_resumed_epoch_equals_the_uninterrupted_one(corpora, tmp_path, name):
    """Dropout 0.1, so the generator's state counts too."""

    def fit(out, epochs):
        parts = recipe.build(_corpus_folder(corpora, name), out,
                             _lm_overrides(name, epochs), RUN_OPTS,
                             DICTS[name], corpora["tokenizer"][name])
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    fit(str(tmp_path / "resumed"), 1)
    resumed = fit(str(tmp_path / "resumed"), 2)
    whole = fit(str(tmp_path / "whole"), 2)
    (ma, oa, lra, sa), (mb, ob, lrb, sb) = (_final_state(resumed),
                                           _final_state(whole))
    assert ma.keys() == mb.keys()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert lra == lrb
    assert vars(sa) == vars(sb)
    shutil.rmtree(tmp_path / "whole")


def test_rnnlm_ckpt_fuses_into_the_seq2seq_search(corpora, trained):
    """``librispeech_seq2seq.build`` loads the RNNLM's ``lm.ckpt``; its
    search's scores move from those at ``lm_weight`` 0."""
    folder, _ = trained["rnnlm"]
    run_opts = dict(RUN_OPTS, lm_ckpt=str(folder / "lm.ckpt"))
    root = corpora["root"]
    scores = {}
    for weight in (0.5, 0.0):
        parts = librispeech_seq2seq.build(
            corpora["data"], str(root / "s2s"),
            dict(S2S_TOY, lm_weight=weight), run_opts)
        brain = parts["brain"]
        lm = torch.load(folder / "lm.ckpt", weights_only=True)
        assert all(torch.equal(lm[k], v)
                   for k, v in brain.lm.state_dict().items())
        batch = brain.prepare_batch(next(iter(parts["valid_loader"])))
        brain.modules.eval()
        with torch.no_grad():
            m = brain.modules
            enc = m.enc(m.normalize(m.compute_features(batch["sig"]),
                                    batch["sig_lens"]), batch["sig_lens"])
            searcher = brain.make_searcher(3)
            assert type(searcher).__name__ == "S2SRNNBeamSearchLM"
            _, scores[weight] = searcher(enc, batch["sig_lens"])
    assert np.all(np.isfinite(scores[0.5]))
    assert np.abs(scores[0.5] - scores[0.0]).max() > 1e-3


def test_transformer_lm_ckpt_fuses_into_the_conformer_search(corpora,
                                                             trained):
    """``librispeech_asr.build`` loads the TransformerLM's ``lm.ckpt`` as
    the yaml's ``lm_model``; the recipe's validation search fuses it at
    ``lm_weight`` 0.6, and its scores move from those at 0."""
    folder, _ = trained["transformer"]
    root = corpora["root"]
    parts = librispeech_asr.build(
        corpora["data"], str(root / "asr"), ASR_TOY,
        dict(RUN_OPTS, lm_ckpt=str(folder / "lm.ckpt")))
    brain = parts["brain"]
    lm = torch.load(folder / "lm.ckpt", weights_only=True)
    assert all(torch.equal(lm[k], v) for k, v in brain.lm.state_dict().items())
    batch = brain.prepare_batch(next(iter(parts["valid_loader"])))
    brain.modules.eval()
    fused, _ = brain.model.transcribe(batch["sig"], batch["sig_lens"],
                                      beam_size=2, lm=brain.lm)
    _, s_fused = brain.model.transcribe(batch["sig"], batch["sig_lens"],
                                        beam_size=2, lm=brain.lm,
                                        lm_weight=0.6)
    _, s_plain = brain.model.transcribe(batch["sig"], batch["sig_lens"],
                                        beam_size=2, lm=brain.lm,
                                        lm_weight=0.0)
    assert np.abs(np.asarray(s_fused) - np.asarray(s_plain)).max() > 1e-3
    brain.on_stage_start(Stage.VALID, 1)
    brain.evaluate_batch(batch, Stage.VALID)
    assert len(brain.wer_metric.scores) == batch["sig"].shape[0]
    assert brain.config["lm_weight"] == 0.6 and fused is not None
