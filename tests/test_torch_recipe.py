"""The LibriSpeech conformer recipe end to end: the port's
``recipes/librispeech_asr`` against the JAX recipe
(``recipes/LibriSpeech/ASR/transformer/train.py``, its ``ASR`` Brain and
``dataio_prepare`` taken by path, with hparams from
``hparams/conformer_small.yaml`` through JAX's ``load_hyperpyyaml``).

A tiny synthetic LibriSpeech tree in ``tmp_path`` (11 train, 3 dev and
2 test WAVs) goes through both with the same overrides to toy dims
(d_model 32, 1 encoder and 1 decoder layer, vocab 40, 40 mels, 8 front
end channels, f32), dropout 0 and no SpecAugment; the yaml's
``grad_accumulation_factor`` 2 and its batching (``DynamicBatchSampler``
and the ``BatchShapePolicy``, with a dummy row of length 0 in one batch
an epoch) stay.  The JAX Brain's initial weights move to the port
through ``bridge.py``.  Then both fit 2 epochs on the same batches:

- the per-step losses agree within ``tests/test_torch_brain.py``'s
  tolerance (1e-5 relative) and the learning rates exactly;
- the validation WERs are equal each epoch, and so are the hypotheses'
  words;
- ``train_log.txt`` has the same lines up to the numbers;
- the port's checkpoint folders hold the best WER, and
  ``evaluate(min_key="WER")`` recovers that checkpoint.

The optimizer state crosses too: optax ``adamw``'s ``mu``/``nu``/
``count`` after the JAX fit become torch ``AdamW``'s ``exp_avg``/
``exp_avg_sq``/``step`` (``bridge.adamw_state_to_torch``), and the port,
carried into the JAX state, takes the next optimizer step to JAX's
parameters and moments (and back, ``bridge.adamw_state_from_torch``).

Also: an uninterrupted 2-epoch fit of the port's recipe equals 1 epoch
plus a resumed epoch in a fresh Brain, bit for bit, and the losses on a
batch with dummy rows (length 0 in CTC's lattice and in the KL) equal
JAX's, per loss.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from recipes.LibriSpeech.librispeech_prepare import (
    prepare_librispeech as j_prepare,
)
from speechbrain_tpu.nnet.losses import ctc_loss as j_ctc_loss
from speechbrain_tpu.nnet.losses import kldiv_loss as j_kldiv_loss
from speechbrain_tpu.parallel.mesh import make_mesh
from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JSentencePiece,
)
from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.nnet.losses import ctc_loss, kldiv_loss
from speechbrain_tpu_torch.recipes import librispeech_asr as recipe

from .test_torch_kernels import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "recipes/LibriSpeech/ASR/transformer"

# The yaml's keys at toy dims; frontend and transformer are restated
# because the yaml fixes their channels and input size.
OVERRIDES = """
train_splits: ["train-clean-100"]
test_splits: ["test-clean"]
vocab_size: 40
n_mels: 40
d_model: 32
nhead: 2
num_encoder_layers: 1
num_decoder_layers: 1
d_ffn: 64
kernel_size: 7
transformer_dropout: 0.0
n_warmup_steps: 4
number_of_epochs: 2
max_batch_length: 4.8
num_buckets: 2
num_workers: 0
valid_beam_size: 2
test_beam_size: 2
precision: fp32
frontend: !new:speechbrain_tpu.lobes.models.convolution.ConvolutionFrontEnd
    num_blocks: 2
    num_layers_per_block: 1
    out_channels: !tuple [8, 8]
    kernel_sizes: !tuple [[3, 3], [3, 3]]
    strides: !tuple [2, 2]
transformer: !new:speechbrain_tpu.lobes.models.transformer.TransformerASR.TransformerASR
    input_size: 80
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
"""
PORT_OVERRIDES = dict(
    train_splits=["train-clean-100"], test_splits=["test-clean"],
    vocab_size=40, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
    d_ffn=64, kernel_size=7, transformer_dropout=0.0, augmentation=None,
    n_warmup_steps=4, number_of_epochs=2, max_batch_length=4.8,
    num_buckets=2, num_workers=0, valid_beam_size=2, test_beam_size=2,
    precision="fp32",
)
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}


def _jax_recipe_module():
    spec = importlib.util.spec_from_file_location(
        "librispeech_transformer_train", RECIPE / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _corpus(root):
    data = root / "LibriSpeech"
    recipe.write_synthetic_librispeech(
        str(data), {"train-clean-100": 11, "dev-clean": 3, "test-clean": 2},
        seconds=(1.0, 1.3), n_words=(2, 3), lexicon_size=12, seed=3)
    return str(data)


def _record(brain, losses, lrs, wers):
    """Wrap the hooks: per-step losses and learning rates, and each
    validation's per-utterance WER details."""
    fit_end, stage_end = brain.on_fit_batch_end, brain.on_stage_end

    def on_fit_batch_end(batch, outputs, loss, should_step):
        losses.append(float(loss))
        lrs.append(brain.lr)
        fit_end(batch, outputs, loss, should_step)

    def on_stage_end(stage, stage_loss, epoch=None):
        if stage.name != "TRAIN":
            wers.append([dict(s) for s in brain.wer_metric.scores])
        stage_end(stage, stage_loss, epoch)

    brain.on_fit_batch_end = on_fit_batch_end
    brain.on_stage_end = on_stage_end


def _jax_pieces(brain):
    state = jax.device_get(brain.train_state)
    p = state["params"]
    return {"frontend": {"params": p["frontend"],
                         "batch_stats": state["model_state"]["frontend"][
                             "batch_stats"]},
            "transformer": p["transformer"], "ctc_lin": p["ctc_lin"],
            "seq_lin": p["seq_lin"], "norm": state["extra"]["norm"]}


def _to_port(pieces, params=None):
    """The port's state_dict from JAX pieces; with ``params`` (a tree
    like the JAX params, e.g. Adam's ``mu``) in place of the params."""
    if params is not None:
        pieces = dict(pieces, frontend=dict(pieces["frontend"],
                                            params=params["frontend"]),
                      transformer=params["transformer"],
                      ctc_lin=params["ctc_lin"], seq_lin=params["seq_lin"])
    return bridge.conformer_asr_state_dict(
        pieces["frontend"], pieces["transformer"], pieces["ctc_lin"],
        pieces["seq_lin"], pieces["norm"])


def _adam_state(brain):
    """optax ``ScaleByAdamState`` inside the JAX Brain's chain."""
    leaves = jax.tree_util.tree_leaves(
        brain.train_state["opt_state"],
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    (adam,) = [x for x in leaves if isinstance(x, optax.ScaleByAdamState)]
    return jax.device_get(adam)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Both recipes fitted for 2 epochs from the same weights."""
    root = tmp_path_factory.mktemp("recipe")
    data = _corpus(root)
    train = _jax_recipe_module()

    # ---- JAX: the recipe's __main__, less the test stage
    with open(RECIPE / "hparams/conformer_small.yaml") as f:
        hp = load_hyperpyyaml(f, OVERRIDES + f"data_folder: {data}\n"
                              f"output_folder: {root / 'jax'}\n")
    del hp["augmentation"]  # the recipe applies it whenever it is set
    j_prepare(data_folder=data, save_folder=hp["save_folder"],
              tr_splits=hp["train_splits"], dev_splits=hp["dev_splits"],
              te_splits=hp["test_splits"], merge_lst=hp["train_splits"],
              merge_name="train.json")
    j_tok = JSentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="words",
        model_type=hp["token_type"], annotation_format="json")
    j_train, j_valid, _ = train.dataio_prepare(hp, j_tok)
    j_ckpt = JCheckpointer(hp["save_folder"])
    j_ckpt.add_recoverable("noam_annealing", hp["noam_annealing"])

    class JaxASR(train.ASR):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            # one device, as the port trains (the suite's 8 virtual CPU
            # devices would pad every batch with replica rows)
            self.mesh = make_mesh(jax.devices()[:1])

        @functools.cached_property
        def _forward(self):
            def forward(state, rngs, batch, stage):
                self._bind(state["params"], state["model_state"],
                           state["extra"], rngs, train=False)
                return self.compute_forward(batch, stage)
            return jax.jit(forward, static_argnums=3)

        def evaluate_batch_full(self, batch, stage):
            """The Brain's eager evaluation with the forward jitted (eager,
            it compiles every operation on its own); the objectives (the
            losses, the beam search and the WER) outside jit on the bound
            parameters, as there."""
            device_batch = self.prepare_batch(batch)
            state = self.train_state
            rngs = self._make_step_rngs(self._next_rng())
            predictions = self._forward(state, rngs, device_batch, stage)
            self._new_extra = None
            self._bind(state["params"], state["model_state"],
                       state["extra"], rngs, train=False)
            return float(self.compute_objectives(predictions, device_batch,
                                                 stage))

    jb = JaxASR(modules=hp["modules"],
                opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                hparams=hp, run_opts={"loss_sync_interval": 1,
                                      "noprogressbar": True},
                checkpointer=j_ckpt)
    jb.tokenizer = j_tok
    first = next(iter(j_train))
    jb._ensure_initialized(jb.prepare_batch(first))
    init = _to_port(_jax_pieces(jb))

    # ---- the port: recipes.librispeech_asr with the same values
    parts = recipe.build(data, str(root / "port"), PORT_OVERRIDES, RUN_OPTS)
    pb = parts["brain"]
    pb.modules.load_state_dict(init)

    out = {"jax": {"losses": [], "lrs": [], "wers": []},
           "port": {"losses": [], "lrs": [], "wers": []}}
    _record(jb, out["jax"]["losses"], out["jax"]["lrs"], out["jax"]["wers"])
    _record(pb, out["port"]["losses"], out["port"]["lrs"],
            out["port"]["wers"])
    jb.fit(hp["epoch_counter"], j_train, j_valid)
    pb.fit(parts["epoch_counter"], parts["train_loader"],
           parts["valid_loader"])
    return dict(out, root=root, jb=jb, pb=pb, parts=parts, hp=hp,
                first=first, data=data)


def test_recipe_losses_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["losses"]) == len(j["losses"]) == 12
    for a, b in zip(p["losses"], j["losses"]):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (a, b)
    assert p["lrs"] == pytest.approx(j["lrs"], rel=1e-12)
    assert fitted["pb"].optimizer_step == fitted["jb"].optimizer_step == 6
    assert fitted["pb"].noam.n_steps == fitted["hp"]["noam_annealing"].n_steps


def test_recipe_validation_wer_and_words_match_jax(fitted):
    j, p = fitted["jax"]["wers"], fitted["port"]["wers"]
    assert len(p) == len(j) == 2
    for got, want in zip(p, j):
        assert got == want  # per utterance: words, alignment and WER
    assert all(s["num_ref_tokens"] > 0 for s in p[0])


def test_recipe_train_log_matches_jax(fitted):
    def shape(path):
        return [re.sub(r"-?\d[\d.e+-]*", "#", line)
                for line in Path(path).read_text().splitlines()]

    root = fitted["root"]
    got = shape(root / "port" / "train_log.txt")
    assert got == shape(root / "jax" / "train_log.txt")
    assert len(got) == 2 and got[0].startswith("epoch: #, lr: #")


def test_recipe_keeps_best_and_evaluates_it(fitted):
    pb, parts = fitted["pb"], fitted["parts"]
    ckpts = pb.checkpointer.list_checkpoints()
    best = min(c.meta["WER"] for c in ckpts)
    wers = [sum(s["num_edits"] for s in epoch)
            / sum(s["num_ref_tokens"] for s in epoch) * 100
            for epoch in fitted["port"]["wers"]]
    assert best == pytest.approx(min(wers))
    assert {"brain.ckpt", "train_state.ckpt", "noam_annealing.ckpt",
            "train_loader.ckpt", "epoch_counter.ckpt"} <= {
        f.name for f in ckpts[0].path.iterdir()}
    pb.config["valid_beam_size"] = parts["hparams"]["test_beam_size"]
    loss = pb.evaluate(parts["test_loader"], min_key="WER")
    assert pb._recovered_ckpt.meta["WER"] == best
    assert np.isfinite(loss) and 0 <= pb.stage_stats["TEST"]["WER"]
    log = (fitted["root"] / "port" / "train_log.txt").read_text()
    assert log.splitlines()[-1].startswith("Epoch loaded: ")


def test_adamw_state_crosses_to_jax_next_step(fitted):
    """The JAX train state after the fit (parameters, statistics and
    optax's mu/nu/count) carried into a fresh port Brain: the next
    optimizer step (2 batches, accumulation 2) gives JAX's parameters
    and moments."""
    jb, hp = fitted["jb"], fitted["hp"]
    pieces, adam = _jax_pieces(jb), _adam_state(jb)
    parts = recipe.build(fitted["data"], str(fitted["root"] / "port2"),
                         PORT_OVERRIDES, RUN_OPTS)
    pb = parts["brain"]
    pb.modules.load_state_dict(_to_port(pieces))
    names = [n for n, _ in pb.modules.named_parameters()]
    bridge.adamw_state_to_torch(
        pb.optimizer, names, _to_port(pieces, adam.mu),
        _to_port(pieces, adam.nu), adam.count)
    pb.lr, pb.noam.n_steps = jb.lr, hp["noam_annealing"].n_steps
    pb.noam.current_lr = hp["noam_annealing"].current_lr
    batches = [fitted["first"].numeric_dict()] * 2
    for step, batch in enumerate(batches, start=1):
        jb.step = pb.step = step
        a, b = pb.fit_batch(batch), jb.fit_batch(batch)
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    assert pb.optimizer_step == 1
    got_sd = {k: v.numpy() for k, v in pb.modules.state_dict().items()}
    want_sd = {k: v.numpy() for k, v in _to_port(_jax_pieces(jb)).items()}
    # the noise-driven entries of test_torch_brain (gradient 0 up to
    # rounding, so Adam's sign may differ) within 2 lr, one step
    from tests.test_torch_brain import _NOISE

    for k in want_sd:
        bound = 2 * 2e-3 if any(s in k for s in _NOISE) else 1e-5
        scale = max(1.0, float(np.max(np.abs(want_sd[k]), initial=0)))
        dev = np.max(np.abs(got_sd[k] - want_sd[k]), initial=0)
        assert dev <= bound * scale, (k, dev)
    mu, nu, step = bridge.adamw_state_from_torch(pb.optimizer, names)
    adam = _adam_state(jb)
    assert step == int(adam.count)
    for got, tree in ((mu, adam.mu), (nu, adam.nu)):
        want = _to_port(_jax_pieces(jb), tree)
        for k in names:
            w = want[k].numpy()
            dev = np.max(np.abs(got[k] - w))
            if any(s in k for s in _NOISE):  # moments of rounding noise
                assert dev <= 1e-6, (k, dev)
            else:
                assert dev <= 1e-4 * np.max(np.abs(w)), (k, dev)


def test_fit_resumed_in_a_fresh_brain_equals_uninterrupted(tmp_path):
    """2 epochs in one fit equal 1 epoch, then a fresh Brain (new
    process state: new loaders, counter and modules) that recovers the
    checkpoint and runs epoch 2 alone: the same losses and the same
    parameters and optimizer state, bit for bit (dropout 0, no
    SpecAugment, staging on)."""
    data = _corpus(tmp_path)
    opts = dict(RUN_OPTS, staging_depth=2)

    def fit(out, epochs):
        parts = recipe.build(data, str(tmp_path / out),
                             dict(PORT_OVERRIDES, number_of_epochs=epochs),
                             opts)
        losses = []
        _record(parts["brain"], losses, [], [])
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"], losses

    whole, whole_losses = fit("whole", 2)
    _, first = fit("split", 1)
    resumed, second = fit("split", 2)
    assert first + second == whole_losses and len(second) == 6
    for k, v in whole.modules.state_dict().items():
        assert torch.equal(v, resumed.modules.state_dict()[k]), k
    s1, s2 = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i in s1["state"]:
        for k in s1["state"][i]:
            assert torch.equal(s1["state"][i][k], s2["state"][i][k])
    assert resumed.noam.n_steps == whole.noam.n_steps == 6


def test_dummy_rows_losses_match_jax():
    """A batch whose last rows are dummies (length 0, ``batch_mask`` 0):
    CTC (``batchmean``: the lattice sees T = 0 and U = 0) and the KL
    equal JAX's."""
    rng = np.random.default_rng(0)
    B, T, U, V = 4, 12, 5, 9
    logp = np.log(rng.dirichlet(np.ones(V), (B, T))).astype(np.float32)
    seq = np.log(rng.dirichlet(np.ones(V), (B, U + 1))).astype(np.float32)
    tokens = rng.integers(1, V, (B, U))
    eos = rng.integers(1, V, (B, U + 1))
    mask = np.array([1, 1, 0, 0], np.float32)
    wav = np.array([1.0, 0.7, 0.0, 0.0], np.float32) * mask
    tok = np.array([1.0, 0.6, 0.0, 0.0], np.float32) * mask
    eos_lens = np.array([1.0, 4 / 6, 0.0, 0.0], np.float32)
    got = ctc_loss(torch.from_numpy(logp), torch.from_numpy(tokens),
                   torch.from_numpy(wav), torch.from_numpy(tok),
                   blank_index=0, reduction="batchmean")
    want = j_ctc_loss(logp, tokens, wav, tok, blank_index=0,
                      reduction="batchmean")
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    got = kldiv_loss(torch.from_numpy(seq), torch.from_numpy(eos),
                     length=torch.from_numpy(eos_lens * mask),
                     label_smoothing=0.1, reduction="batchmean")
    want = j_kldiv_loss(seq, eos, length=eos_lens * mask,
                        label_smoothing=0.1, reduction="batchmean")
    assert float(got) == pytest.approx(float(want), rel=1e-6)
