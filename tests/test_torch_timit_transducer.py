"""The TIMIT transducer recipes on the port against the JAX scripts, taken
by path: ``recipes/TIMIT/ASR/transducer/train.py`` with
``hparams/train.yaml`` and ``train_wav2vec.py`` with
``hparams/train_wav2vec.yaml`` (``recipes/timit_transducer.py``), on a
synthetic TIMIT tree at toy widths.

Tolerances:

- the training steps (the recipe's first training batch through the JAX
  script's ``_loss_fn`` at the port's weights) in float32, the RNN-T loss
  on K8/K9's plain version on the port's side and JAX's scan on its side:
  the loss within 1e-5 relative, each gradient within
  ``TRANSDUCER_GRAD_SHARE`` (1e-3) of its tensor's largest plus 1e-6 of
  the largest overall, as ``tests/test_torch_commonvoice.py`` holds the
  CommonVoice transducer's.  Not float64: ``TransducerLoss`` casts its
  logits to float32 in both packages (ROADMAP Queue 3), so a
  float64 step still runs the lattice in float32, and its occupancies
  carry float32's error into every gradient behind them.  The CRDNN step
  uses clips of one length: its CNN blocks end in a max pool over
  frequency whose argmax flips on the padding's constant frames;
- the validation stage's greedy search and the test stage's beam 4: the
  same hypotheses and PER as the JAX script's ``TransducerBeamSearcher`` on
  the same encoder states;
- a resumed run: bit for bit.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRate
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes import timit_transducer as tt
from speechbrain_tpu_torch.recipes.timit_ctc import write_synthetic_timit

from .test_torch_commonvoice import _jax_searcher, transducer_jax_state
from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_transformer_encoder_asr import (
    RESUME,
    assert_resume_matches,
    assert_step_matches,
    assert_yaml_values,
    load_path,
    load_yaml,
)

REPO = Path(__file__).resolve().parents[1]
TIMIT = REPO / "recipes/TIMIT"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
TRANSDUCER_GRAD_SHARE = 1e-3
HEAD_TOY = dict(joint_dim=8, dec_emb_dim=8, dec_neurons=8, precision="fp32",
                batch_size=4, number_of_epochs=2)
CRDNN_TOY = dict(HEAD_TOY, n_mels=16, cnn_channels=(4, 4), rnn_layers=1,
                 rnn_neurons=8, dnn_blocks=1, dnn_neurons=8, dropout=0.0)
# five convolutions (5 ms frames, T 198 a 1 s clip) keep the lattice and
# the beam short
W2V_TOY = dict(HEAD_TOY, latent_channels=(16,) * 5, embedding_dim=16,
               encoder_layers=2, nhead=2, d_ffn=32, encoder_dropout=0.0)
YAML_TOY = """
precision: fp32
joint_dim: 8
"""
CRDNN_YAML_TOY = YAML_TOY + """
n_mels: 16
cnn_channels: !tuple [4, 4]
rnn_layers: 1
rnn_neurons: 8
dnn_blocks: 1
dnn_neurons: 8
dropout: 0.0
"""
W2V_YAML_TOY = YAML_TOY + """
extractor: !new:speechbrain_tpu.lobes.models.wav2vec.W2VLatentExtractor
    out_channels: !tuple [16, 16, 16, 16, 16]
encoder: !new:speechbrain_tpu.lobes.models.wav2vec.EncoderWrapper
    in_dim: 16
    embedding_dim: 16
    num_layers: 2
    nhead: 2
    d_ffn: 32
    dropout: 0.0
"""
# each recipe: its dict, toy values, the JAX script and yaml
RECIPES = {
    "crdnn": (tt.HPARAMS, CRDNN_TOY, "train.py", "train.yaml",
              CRDNN_YAML_TOY),
    "wav2vec": (tt.HPARAMS_WAV2VEC, W2V_TOY, "train_wav2vec.py",
                "train_wav2vec.yaml", W2V_YAML_TOY),
}
# added to the blank logit's bias, so that the toy models' searches emit
# blanks and end in a few rounds a frame
BLANK_BIAS = 1.0
_KEYS = {"tokens": "phn_encoded", "tokens_blank": "phn_encoded_blank",
         "tokens_lens": "phn_encoded_lens",
         "tokens_blank_lens": "phn_encoded_blank_lens"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A TIMIT tree whose clips all last 1 s (see the tolerances)."""
    root = tmp_path_factory.mktemp("timit_transducer")
    write_synthetic_timit(str(root / "timit"), {"train": 8, "dev": 4,
                                                "test": 4},
                          seconds=(1.0, 1.0), max_phones=10, seed=6)
    return root / "timit"


def _build(name, tree, out, **over):
    hp, toy = RECIPES[name][:2]
    return tt.build(str(tree), str(out), dict(toy, **over), RUN_OPTS, hp)


def _jax_transducer(name, tmp_path):
    """The JAX script's ``Transducer`` on its yaml at toy widths, reading
    the port's batch keys."""
    _, _, script_name, yaml_name, overrides = RECIPES[name]
    script = load_path(f"timit_transducer_{name}_jax",
                       TIMIT / "ASR/transducer" / script_name)

    def rename(batch):
        return {_KEYS.get(k, k): v for k, v in batch.items()}

    class Transducer(script.Transducer):
        def compute_forward(self, batch, stage):
            return super().compute_forward(rename(batch), stage)

        def compute_objectives(self, predictions, batch, stage):
            return super().compute_objectives(predictions, rename(batch),
                                              stage)

    hp = load_yaml(TIMIT / "ASR/transducer/hparams" / yaml_name, overrides,
                   tmp_path)
    return Transducer(modules=hp["modules"],
                      opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                      hparams=hp, run_opts={"noprogressbar": True})


def _jax_state(name, brain):
    if name == "crdnn":
        return transducer_jax_state(brain)
    params = bridge.to_jax_wav2vec(brain.modules.state_dict())
    return params, {}, {}, bridge.to_jax_wav2vec


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_yaml_matches_the_dict(name, tmp_path):
    """Both yamls through JAX's ``load_hyperpyyaml`` against their dicts:
    the shared values, the encoder's, the prediction network's and joint's
    widths, the searches' beams, Adadelta's and NewBob's arguments."""
    hp, _, _, yaml_name, _ = RECIPES[name]
    y = load_yaml(TIMIT / "ASR/transducer/hparams" / yaml_name, "", tmp_path)
    assert_yaml_values(y, hp, 12, skip=("vocab_size",))
    assert y["output_neurons"] == hp["vocab_size"] == 40
    assert (y["test_beam_size"], y["valid_beam_size"]) == (hp["beam_size"],
                                                           1)
    assert y["emb"].embedding_dim == hp["dec_emb_dim"] == hp["joint_dim"]
    assert y["dec"].hidden_size == hp["dec_neurons"] == hp["joint_dim"]
    assert (y["enc_lin"].n_neurons, y["dec_lin"].n_neurons,
            y["out_lin"].n_neurons) == (hp["joint_dim"], hp["joint_dim"],
                                        hp["vocab_size"])
    opt = y["opt_class"].keywords
    assert (opt["rho"], opt["eps"]) == (hp["rho"], hp["eps"])
    nb = y["lr_annealing"]
    assert (nb.hyperparam_value, nb.improvement_threshold,
            nb.annealing_factor, nb.patient) == (
        hp["lr"], hp["improvement_threshold"], hp["annealing_factor"],
        hp["patient"])
    if name == "crdnn":
        enc = y["enc"]
        assert (enc.rnn_class, tuple(enc.cnn_channels),
                tuple(enc.inter_layer_pooling_size), enc.rnn_layers,
                enc.rnn_neurons, enc.dnn_blocks, enc.dnn_neurons) == (
            "ligru", hp["cnn_channels"], hp["inter_layer_pooling_size"],
            hp["rnn_layers"], hp["rnn_neurons"], hp["dnn_blocks"],
            hp["dnn_neurons"])
        assert y["compute_features"].deltas and hp["deltas"]
        return
    ext, enc = y["extractor"], y["encoder"]
    assert tuple(ext.out_channels) == hp["latent_channels"]
    assert (enc.in_dim, enc.embedding_dim, enc.num_layers, enc.nhead,
            enc.d_ffn, enc.dropout) == (
        hp["latent_channels"][-1], hp["embedding_dim"], hp["encoder_layers"],
        hp["nhead"], hp["d_ffn"], hp["encoder_dropout"])
    assert set(y["modules"]) == {"extractor", "encoder", "enc_lin", "emb",
                                 "dec", "dec_lin", "out_lin"}


def test_bridge_round_trips_the_wav2vec_transducer(tree, tmp_path):
    """``to_jax_wav2vec`` then ``wav2vec_state_dict`` gives back the wav2vec
    transducer's modules bit for bit (``dec`` as a ``GRU``)."""
    brain = _build("wav2vec", tree, tmp_path / "port")["brain"]
    sd = brain.modules.state_dict()
    jax_params = bridge.to_jax_wav2vec(sd)
    assert "l0_u_bias" in jax_params["dec"]
    back = bridge.wav2vec_state_dict(jax_params)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_step_matches_jax(tree, tmp_path, name):
    """The ``Transducer`` step (the CRDNN or the wav2vec encoder,
    ``enc_lin``, the GRU prediction network, the tanh joint, the RNN-T
    loss) against the JAX script's on the recipe's first batch."""
    parts = _build(name, tree, tmp_path / "port")
    brain = parts["brain"]
    assert type(brain.optimizer).__name__ == "Adadelta"
    batch = next(iter(parts["train_loader"]))
    assert float(batch.numeric_dict()["sig_lens"].min()) == 1.0
    params, model_state, extra, grads = _jax_state(name, brain)
    assert_step_matches(brain, _jax_transducer(name, tmp_path), batch,
                        params, model_state, extra, grads,
                        grad_share=TRANSDUCER_GRAD_SHARE)


@pytest.mark.parametrize("name,stage", [("crdnn", Stage.VALID),
                                        ("wav2vec", Stage.TEST)])
def test_search_matches_jax(tree, tmp_path, name, stage):
    """The validation stage's greedy search and the test stage's beam 4
    (``state_beam`` and ``expand_beam`` 2.3) on one batch's encoder
    states: the port's hypotheses and PER equal those of the JAX
    script's searcher at the same beam, the blank logit biased +1."""
    parts = _build(name, tree, tmp_path / "port")
    brain = parts["brain"]
    with torch.no_grad():
        brain.modules.out_lin.bias[0] += BLANK_BIAS
    loader = parts["valid_loader" if stage == Stage.VALID else "test_loader"]
    batch = brain.prepare_batch(next(iter(loader)))
    brain.modules.eval()
    brain.on_stage_start(stage, 1)
    with torch.no_grad():
        _, enc = brain.compute_forward(batch, stage)
        hyps, _ = brain.searcher(enc, batch["sig_lens"])
    brain._score_hyps(hyps, batch)
    jb = _jax_transducer(name, tmp_path)
    if stage == Stage.TEST:
        jb.hparams.valid_beam_size = jb.hparams.test_beam_size
    params = _jax_state(name, brain)[0]
    j_hyps, _ = _jax_searcher(jb, params)(
        jnp.asarray(enc.numpy()), jnp.asarray(batch["sig_lens"].numpy()))
    assert [list(map(int, h)) for h in j_hyps] == hyps
    assert any(hyps)
    jer = JErrorRate()
    real = int(batch["batch_mask"].sum())
    jer.append([str(i) for i in range(real)], j_hyps[:real],
               batch["tokens"][:real].numpy().tolist(),
               target_len=batch["tokens_lens"][:real].numpy(),
               ind2lab=parts["label_encoder"].decode_ndim)
    assert brain.wer_metric.summarize("error_rate") == jer.summarize(
        "error_rate")


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_run_resumes_bit_for_bit(tree, tmp_path, name):
    """Each dict through ``build``: 2 epochs equal 1 epoch plus a resumed
    one in a fresh Brain, bit for bit (modules, Adadelta's state, the
    rate, NewBob checkpointed); then the beam-4 test from the best
    checkpoint, its loss and PER finite, its PER file written."""
    def make(folder, epochs):
        parts = _build(name, tree, tmp_path / folder, **RESUME,
                       number_of_epochs=epochs)
        with torch.no_grad():
            parts["brain"].modules.out_lin.bias[0] += BLANK_BIAS
        return parts

    full = assert_resume_matches(make)
    brain = full["brain"]
    brain.evaluate(full["test_loader"], min_key="PER")
    stats = brain.stage_stats["TEST"]
    assert set(stats) == {"loss", "PER"} and all(
        np.isfinite(v) for v in stats.values())
    assert (tmp_path / "full/per.txt").read_text().startswith("%WER")
    ckpt = next((tmp_path / "full/save").glob("CKPT*"))
    assert (ckpt / "lr_annealing.ckpt").exists()


def test_inventory_against_output_neurons(tree, tmp_path):
    """The yamls' 40 outputs ("39 phonemes + blank"): the port's 39-phone
    fold and the blank fill them exactly; the JAX preparation's fold
    gives 40 phones (``recipes/TIMIT/timit_prepare.py:139-166``), 41
    labels, whose last id passes the embedding's table and ``out_lin``.
    The port's build raises, naming the inventory's size, when it passes
    ``vocab_size``."""
    parts = _build("crdnn", tree, tmp_path / "port")
    assert len(parts["label_encoder"]) == 40 == tt.HPARAMS["vocab_size"]
    jprep = load_path("timit_prepare_jax_t", TIMIT / "timit_prepare.py")
    out = tmp_path / "jax"
    out.mkdir()
    jprep.prepare_timit(str(tree), str(out / "train.json"),
                        str(out / "dev.json"), str(out / "test.json"),
                        phn_set=39)
    phones = set()
    for split in ("train", "dev", "test"):
        for row in json.loads((out / f"{split}.json").read_text()).values():
            phones.update(row["phn"].split())
    assert len(phones) + 1 == 41 > tt.HPARAMS["vocab_size"]
    with pytest.raises(ValueError, match="40 labels .* past the 39 outputs"):
        _build("crdnn", tree, tmp_path / "small", vocab_size=39)


def test_precision_the_scripts_run(tree, tmp_path):
    """Both yamls say bf16, but neither JAX script casts (its modules run
    in the input's float32); the port runs the Brain's precision: the
    wav2vec transducer's encoder in bfloat16, its prediction network and
    joint in float32, as ``asr._Transducer`` runs every encoder."""
    assert tt.HPARAMS["precision"] == tt.HPARAMS_WAV2VEC["precision"] == (
        "bf16")
    for script in ("train.py", "train_wav2vec.py"):
        text = (TIMIT / "ASR/transducer" / script).read_text()
        assert "bfloat16" not in text and "self.precision" not in text
    parts = _build("wav2vec", tree, tmp_path / "port", precision="bf16")
    brain = parts["brain"]
    seen = {}
    def record(name):
        def hook(module, args, out):
            seen[name] = (out["embeddings"] if name == "encoder"
                          else out).dtype
        return hook

    hooks = [getattr(brain.modules, n).register_forward_hook(record(n))
             for n in ("encoder", "dec_lin", "out_lin")]
    brain.step = 1
    brain.fit_batch(next(iter(parts["train_loader"])))
    for h in hooks:
        h.remove()
    assert seen == {"encoder": torch.bfloat16, "dec_lin": torch.float32,
                    "out_lin": torch.float32}
