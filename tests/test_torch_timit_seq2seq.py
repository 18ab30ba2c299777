"""The TIMIT seq2seq recipe and its knowledge distillation on the port
(``recipes/timit_seq2seq``, ``recipes/timit_kd``, the distillation losses
of ``nnet/losses``), against the JAX package on the CPU.

- The yamls: ``seq2seq/hparams/train.yaml``, the ten teachers,
  ``train_kd.yaml`` and ``save_teachers.yaml``, loaded by JAX's
  ``load_hyperpyyaml``, against ``HPARAMS``, ``TEACHERS``,
  ``HPARAMS_KD`` and ``HPARAMS_SAVE_TEACHERS``.
- ``ctc_loss_kd``, ``nll_loss_kd`` and ``ce_kd`` against JAX's, values
  within 1e-5 relative and gradients within 1e-5 of their scale (float32
  sums in other orders), on teachers with repeated labels, an all-blank
  row (its path is one label equal to the blank) and rows shorter than T.
- The recipe's step (loss and every gradient) against the JAX recipe's
  ``ASR._loss_fn`` (``seq2seq/train.py`` taken by path) with each
  ``rnn_class`` of the CRDNN, and the distillation step against
  ``train_kd.py``'s, at toy widths in f32: the loss within 1e-5
  relative, each gradient within 3e-4 of its tensor's largest magnitude
  plus 1e-6 of the largest over all: the CTC runs in every step, and its
  f32 gradient (the plain recursions, JAX's Pallas kernels' arithmetic)
  lies 1.1e-4 of its scale from float64 at 81 frames, JAX's CPU route
  (optax) 3e-5; the sums over frames and the CNN's positions carry that
  into every tensor.
  The batch's utterances have one length, and both packages read JAX's
  Fbank features: padded frames of constant features tie in the CNN
  blocks' max pooling in the port and nearly tie in JAX, and Fbank's
  ~1e-5 dB differences flip near-ties too, where the gradient goes to
  other bins (see ``tests/test_torch_timit.py``).
- The chain on a synthetic tree: two teachers of other ``rnn_class``
  (ligru, lstm) one epoch each through ``run``; ``save_teachers``' npz
  against JAX's ``save_teachers.py`` ``main`` run on the same
  posteriors, key for key and bit for bit in float16; the student through
  ``run_kd``; the seq2seq recipe and the student each resumed in a fresh
  Brain bit for bit; the bridge's round trip over the three CRDNNs.
"""

import importlib.util
import os
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.nnet import losses as jlosses
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.dataio.dataloader import SaveableDataLoader
from speechbrain_tpu_torch.nnet.losses import ce_kd, ctc_loss_kd, nll_loss_kd
from speechbrain_tpu_torch.ops.ctc import ctc_loss_per_seq
from speechbrain_tpu_torch.recipes import timit_kd, timit_seq2seq
from speechbrain_tpu_torch.recipes.timit_ctc import (
    dataio_prep,
    prepare_timit,
    write_synthetic_timit,
)

from .test_torch_kernels import jax_value_and_grad, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
S2S = REPO / "recipes/TIMIT/ASR/seq2seq"
KD_DIR = REPO / "recipes/TIMIT/ASR/seq2seq_knowledge_distillation"
TOY = dict(cnn_channels=(4, 6), rnn_layers=1, rnn_neurons=8, dnn_blocks=1,
           dnn_neurons=8, emb_size=8, dec_neurons=16, attn_dim=12,
           dropout=0.0, batch_size=4, number_of_epochs=1, precision="fp32",
           valid_beam_size=2, test_beam_size=3, max_attn_shift=20)
YAML_TOY = """
dropout: 0.0
precision: fp32
enc: !new:speechbrain_tpu.lobes.models.CRDNN.CRDNN
    cnn_blocks: 2
    cnn_channels: !tuple [4, 6]
    inter_layer_pooling_size: !tuple [2, 2]
    rnn_class: {rnn_class}
    rnn_layers: 1
    rnn_neurons: 8
    rnn_bidirectional: true
    dnn_blocks: 1
    dnn_neurons: 8
    dropout: 0.0
emb: !new:speechbrain_tpu.nnet.embedding.Embedding
    num_embeddings: 42
    embedding_dim: 8
dec: !new:speechbrain_tpu.nnet.RNN.AttentionalRNNDecoder
    rnn_type: gru
    attn_type: location
    hidden_size: 16
    attn_dim: 12
    num_layers: 1
    dropout: 0.0
"""
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
# the CTC's gradient in f32 (the plain recursions, JAX's Pallas kernels'
# arithmetic) lies 1.1e-4 of its scale from float64 at T 81, JAX's CPU
# route (optax) 3e-5: each step gradient within 3e-4 of its tensor's scale
LOSS_RTOL, GRAD_SHARE = 1e-5, 3e-4
KD_RTOL = 1e-5


def _load_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ yamls


YAMLS = ([("seq2seq/hparams/train.yaml", {})]
         + [(f"seq2seq_knowledge_distillation/hparams/teachers/{k}.yaml", v)
            for k, v in timit_seq2seq.TEACHERS.items()]
         + [("seq2seq_knowledge_distillation/hparams/train_kd.yaml",
             {"kd_weight": 0.5})])


@pytest.mark.parametrize("path,overrides", YAMLS, ids=[p for p, _ in YAMLS])
def test_yaml_matches_the_dict(path, overrides, tmp_path):
    """Every value the yaml and the dict share, the CRDNN's and the
    decoder's fields, and the optimizer's and NewBob's settings."""
    hp = dict(timit_seq2seq.HPARAMS, **overrides)
    with open(REPO / "recipes/TIMIT/ASR" / path) as f:
        y = load_hyperpyyaml(f, {"data_folder": str(tmp_path),
                                 "output_folder": str(tmp_path)})
    shared = [k for k in hp if k in y]
    assert len(shared) >= 30
    for key in shared:
        want = list(hp[key]) if isinstance(hp[key], tuple) else hp[key]
        got = list(y[key]) if isinstance(y[key], tuple) else y[key]
        assert got == want, key
    enc, dec = y["enc"], y["dec"]
    assert enc.rnn_class == hp["rnn_class"]
    assert (enc.rnn_layers, enc.rnn_neurons, enc.dnn_neurons, enc.dropout,
            list(enc.cnn_channels)) == (
        hp["rnn_layers"], hp["rnn_neurons"], hp["dnn_neurons"], hp["dropout"],
        list(hp["cnn_channels"]))
    assert (dec.rnn_type, dec.attn_type, dec.hidden_size, dec.attn_dim) == (
        "gru", "location", hp["dec_neurons"], hp["attn_dim"])
    s = y["lr_annealing"]
    assert (s.hyperparam_value, s.improvement_threshold, s.annealing_factor,
            s.patient) == (hp["lr"], hp["improvement_threshold"],
                           hp["annealing_factor"], hp["patient"])


def test_save_teachers_yaml_matches_the_dict(tmp_path):
    with open(KD_DIR / "hparams/save_teachers.yaml") as f:
        y = load_hyperpyyaml(f, {"data_folder": str(tmp_path)})
    hp = timit_kd.HPARAMS_SAVE_TEACHERS
    assert (y["seed"], y["batch_size"]) == (hp["seed"], hp["batch_size"])
    assert [Path(p).stem for p in y["teacher_yamls"]] == list(hp["teachers"])


def test_jax_posteriors_folders_do_not_meet(tmp_path):
    """JAX's ``train_kd.yaml`` reads the posteriors from
    ``<save_folder>/teacher_posteriors``; ``save_teachers.py`` writes them
    to its own ``output_folder`` (``save_teachers.py:123-125``), another
    folder: the port's ``run_kd`` takes the folder as an argument."""
    with open(KD_DIR / "hparams/train_kd.yaml") as f:
        kd = load_hyperpyyaml(f, {"data_folder": str(tmp_path)})
    with open(KD_DIR / "hparams/save_teachers.yaml") as f:
        st = load_hyperpyyaml(f, {"data_folder": str(tmp_path)})
    assert kd["teacher_posteriors_folder"].endswith(
        "train_kd/1234/save/teacher_posteriors")
    assert st["output_folder"] == "results/save_teachers/1234"
    assert "ensemble_" in (KD_DIR / "save_teachers.py").read_text()


# ------------------------------------------------------------ KD losses


def _kd_inputs(seed=0):
    """Student log-probs (4, 14, 6) and teacher posteriors whose greedy
    paths have repeats and blanks (row 0), are all blank (row 1: the path
    is one blank label), repeat one label (row 2) and run past the row's
    length 0.6 (row 3); the teacher probabilities rounded through float16
    as ``save_teachers`` stores them (ties between classes included)."""
    rng = np.random.default_rng(seed)
    B, T, C = 4, 14, 6
    student = rng.standard_normal((B, T, C)).astype(np.float32)
    paths = np.array([[1, 1, 0, 2, 2, 2, 0, 0, 3, 1, 1, 0, 4, 5],
                      [0] * 14,
                      [3, 3, 3, 0, 3, 0, 0, 3, 3, 0, 2, 2, 0, 0],
                      [5, 0, 4, 4, 0, 3, 2, 0, 1, 1, 2, 3, 4, 5]])
    logits = rng.standard_normal((B, T, C)) + 4.0 * np.eye(C)[paths]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float16).astype(np.float32)
    probs[2, 4] = probs[2, 4, [3]]  # all tie: the first, the blank, wins
    lens = np.array([1.0, 1.0, 0.8, 0.6], np.float32)
    return student, probs, lens


def test_ctc_loss_kd_matches_jax():
    """Value and gradient w.r.t. the student's logits."""
    student, teacher, lens = _kd_inputs()

    def jfn(x):
        return jlosses.ctc_loss_kd(jax.nn.log_softmax(x), jnp.asarray(teacher),
                                   jnp.asarray(lens), blank_index=0), None

    (jv, _), jg = jax_value_and_grad(jfn)(jnp.asarray(student))
    x = torch.from_numpy(student).requires_grad_(True)
    v = ctc_loss_kd(torch.log_softmax(x, -1), torch.from_numpy(teacher),
                    torch.from_numpy(lens), 0)
    (g,) = torch.autograd.grad(v, x)
    assert abs(float(v.detach()) - float(jv)) <= KD_RTOL * abs(float(jv))
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= KD_RTOL * np.abs(jg).max()


def test_ctc_loss_kd_paths():
    """The teacher's paths as JAX's ``ctc_loss_kd`` builds them: a row's
    loss is the plain CTC of the collapsed path, the all-blank row's that
    of the one label 0, frames past the row's length left out."""
    student, teacher, lens = _kd_inputs()
    lp = torch.log_softmax(torch.from_numpy(student), -1)
    paths = [[1, 2, 3, 1, 4, 5], [0], [3, 3, 2], [5, 4, 3, 2]]
    for b, path in enumerate(paths):
        row = ctc_loss_kd(lp[b:b + 1], torch.from_numpy(teacher[b:b + 1]),
                          torch.from_numpy(lens[b:b + 1]), 0)
        tb = round(float(lens[b]) * 14)
        want = ctc_loss_per_seq(
            lp[b:b + 1, :tb].contiguous(), torch.tensor([path]),
            torch.tensor([tb]), torch.tensor([len(path)]), 0)
        assert abs(float(row) - float(want[0]) / len(path)) <= 1e-6


def test_nll_loss_kd_and_ce_kd_match_jax():
    """``nll_loss_kd`` over rows of 5, 3 and 0 of 6 positions, divided by
    the batch's count (not a mean of rows), and ``ce_kd`` of flattened
    rows: values and gradients."""
    rng = np.random.default_rng(1)
    lp = rng.standard_normal((3, 6, 5)).astype(np.float32)
    tp = rng.dirichlet(np.ones(5), (3, 6)).astype(np.float32)
    rel = np.array([5 / 6, 0.5, 0.0], np.float32)

    def jfn(x):
        return jlosses.nll_loss_kd(jax.nn.log_softmax(x), jnp.asarray(tp),
                                   jnp.asarray(rel)), None

    (jv, _), jg = jax_value_and_grad(jfn)(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_(True)
    v = nll_loss_kd(torch.log_softmax(x, -1), torch.from_numpy(tp),
                    torch.from_numpy(rel))
    (g,) = torch.autograd.grad(v, x)
    assert abs(float(v.detach()) - float(jv)) <= KD_RTOL * abs(float(jv))
    assert np.abs(g.numpy() - np.asarray(jg)).max() <= 1e-6
    per_row = -(np.log(np.exp(lp) / np.exp(lp).sum(-1, keepdims=True))
                * tp).sum(-1)
    assert abs(float(v.detach()) - (per_row[0, :5].sum() + per_row[1, :3].sum()) / 8
               ) <= 1e-5

    flat_lp, flat_tp = lp.reshape(-1, 5), tp.reshape(-1, 5)
    want = np.asarray(jlosses.ce_kd(jnp.asarray(flat_lp), jnp.asarray(flat_tp)))
    got = ce_kd(torch.from_numpy(flat_lp), torch.from_numpy(flat_tp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ the steps


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic TIMIT tree (8 train, 4 dev, 4 test utterances of
    0.8 s)."""
    root = tmp_path_factory.mktemp("timit_s2s")
    data = str(root / "TIMIT")
    write_synthetic_timit(data, {"train": 8, "dev": 4, "test": 4},
                          seconds=(0.8, 0.8), max_phones=10, seed=5)
    return root, data


def _jax_brain(script, yaml, rnn_class, root, extra=""):
    train = _load_path(f"timit_{script.stem}_jax", script)
    with open(yaml) as f:
        hp = load_hyperpyyaml(f, YAML_TOY.format(rnn_class=rnn_class)
                              + f"data_folder: {root}\n"
                              f"output_folder: {root / 'jax'}\n" + extra)
    return train.ASR(modules=hp["modules"],
                     opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                     hparams=hp, run_opts={"noprogressbar": True})


def _jax_state(sd):
    j = bridge.to_jax_crdnn_seq2seq(sd)
    state = {
        "params": {"enc": j["enc"]["params"], "emb": j["emb"],
                   "dec": j["dec"], "ctc_lin": j["ctc_lin"],
                   "seq_lin": j["seq_lin"]},
        "model_state": {"enc": {"batch_stats": j["enc"]["batch_stats"]}},
        "extra": {"norm": j["norm"]},
    }
    return jax.tree_util.tree_map(jnp.asarray, state)


class _Features(torch.nn.Module):
    """Stands in for ``Fbank``: the given features, whatever the signal."""

    def __init__(self, feats):
        super().__init__()
        self.feats = feats

    def forward(self, sig):
        return self.feats


def _compare_step(pb, jb, host):
    """One training step's loss and gradients, port against JAX."""
    state = _jax_state(pb.modules.state_dict())
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jbatch["batch_mask"] = jnp.ones(host["sig"].shape[0], jnp.float32)
    jb.hparams.epoch_counter.current = 1
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))

    def loss_fn(params):
        loss, (_, _, extra) = jb._loss_fn(params, state["model_state"],
                                          state["extra"], jbatch, rngs,
                                          JStage.TRAIN)
        return loss, extra

    (jloss, _), jgrads = jax_value_and_grad(loss_fn)(state["params"])
    pb.epoch = 1
    pb.modules.train()
    # both read JAX's Fbank features: f32 power spectra summed in other
    # orders move the dB by ~1e-5 (``test_fbank_with_deltas_matches_jax``),
    # enough to flip near-ties of the CNN blocks' max pooling
    feats = torch.from_numpy(np.array(
        jb.hparams.compute_features(jbatch["sig"])))
    pb.modules.compute_features = _Features(feats)
    batch = pb.prepare_batch(host)
    loss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                 batch, Stage.TRAIN)
    params = dict(pb.modules.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    sd = dict(pb.modules.state_dict())
    sd.update({k: torch.zeros_like(p) if g is None else g
               for (k, p), g in zip(params.items(), grads)})
    got = bridge.to_jax_crdnn_seq2seq(sd)
    got = {"enc": got["enc"]["params"], **{k: got[k] for k in (
        "emb", "dec", "ctc_lin", "seq_lin")}}
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    paths_g = jax.tree_util.tree_leaves_with_path(got)
    paths_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in paths_g] == [k for k, _ in paths_w]
    top = max(float(np.abs(w).max()) for _, w in paths_w)
    for (path, g), (_, w) in zip(paths_g, paths_w):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_SHARE * float(np.abs(w).max()) + 1e-6 * top,
            err_msg=jax.tree_util.keystr(path))
    return loss


@pytest.fixture(scope="module")
def first_batch(tree):
    """The manifests, the label encoder and the first training batch of 4
    utterances (unshuffled), as a host dict."""
    root, data = tree
    hp = dict(timit_seq2seq.HPARAMS, **TOY, data_folder=data,
              save_folder=str(root / "m"),
              train_json=str(root / "m/train.json"),
              valid_json=str(root / "m/dev.json"),
              test_json=str(root / "m/test.json"))
    prepare_timit(data, hp["train_json"], hp["valid_json"], hp["test_json"],
                  39)
    datasets, enc = dataio_prep(hp, seq2seq=True)
    batch = next(iter(SaveableDataLoader(datasets["train"], batch_size=4)))
    return batch.numeric_dict(), enc


@pytest.mark.parametrize("rnn_class", ["ligru", "lstm", "gru"])
def test_step_matches_jax(tree, first_batch, rnn_class):
    """The seq2seq step (0.5 CTC + 0.5 NLL) of each CRDNN, in training
    mode (the normalization and BatchNorms on the batch's statistics)."""
    root, _ = tree
    host, enc = first_batch
    assert enc.get_blank_index() == 0 and enc.lab2ind["<bos>"] == 1
    assert enc.lab2ind["<eos>"] == 2 and max(enc.ind2lab) < 42
    pb = timit_seq2seq.ASR(dict(TOY, rnn_class=rnn_class), RUN_OPTS)
    jb = _jax_brain(S2S / "train.py", S2S / "hparams/train.yaml", rnn_class,
                    root)
    _compare_step(pb, jb, host)


def test_kd_step_matches_jax(tree, first_batch):
    """The student's step with teacher posteriors longer in frames (+3)
    and shorter in tokens (-1) than the student's, cut to the shorter of
    the two as JAX cuts them; one row's teacher path all blank."""
    root, _ = tree
    host, _ = first_batch
    rng = np.random.default_rng(3)
    B, L = host["sig"].shape
    T = L // 160 + 1
    U = host["phn_encoded_eos"].shape[1]
    logits = rng.standard_normal((B, T + 3, 42)) * 2
    logits[1, :, 0] += 20.0
    ctc = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    seq = rng.dirichlet(np.ones(42), (B, U - 1))
    host = dict(host, teacher_ctc=ctc.astype(np.float16).astype(np.float32),
                teacher_seq=seq.astype(np.float16).astype(np.float32))
    pb = timit_kd.KD(dict(TOY, kd_weight=0.5), RUN_OPTS)
    jb = _jax_brain(KD_DIR / "train_kd.py", KD_DIR / "hparams/train_kd.yaml",
                    "ligru", root)
    loss_kd = _compare_step(pb, jb, host)
    pb.hparams.kd_weight = 0.0
    batch = pb.prepare_batch(host)
    with torch.no_grad():
        loss_gt = float(pb.compute_objectives(
            pb.compute_forward(batch, Stage.TRAIN), batch, Stage.TRAIN))
    assert abs(loss_kd - loss_gt) > 1e-3


def test_bridge_round_trips_each_crdnn():
    for rnn_class in ("ligru", "lstm", "gru"):
        sd = {k: v for k, v in timit_seq2seq.ASR(
            dict(TOY, rnn_class=rnn_class), RUN_OPTS).modules.state_dict()
            .items()}
        j = bridge.to_jax_crdnn_seq2seq(sd)
        back = bridge.crdnn_seq2seq_state_dict(
            j["enc"], j["emb"], j["dec"], j["ctc_lin"], j["seq_lin"],
            j["norm"])
        missing = sorted(set(sd) - set(back))
        # the LSTM's zero bias_hh buffers have no JAX counterpart
        assert all("bias_hh" in k for k in missing), missing
        for k, v in back.items():
            got = torch.as_tensor(np.asarray(v))
            assert torch.equal(got.to(sd[k].dtype), sd[k]), (rnn_class, k)


# ------------------------------------------------------------ the chain


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Two teachers (tea0: ligru; tea3: lstm) at toy widths, one epoch
    each through ``run``, and ``save_teachers`` over them."""
    root = tmp_path_factory.mktemp("timit_kd")
    data = str(root / "TIMIT")
    write_synthetic_timit(data, {"train": 8, "dev": 4, "test": 4},
                          seconds=(1.0, 1.6), max_phones=16, seed=6)
    teachers = []
    for name in ("tea0", "tea3"):
        overrides = dict(TOY, **timit_seq2seq.TEACHERS[name])
        brain = timit_seq2seq.run(data, str(root / name), overrides, RUN_OPTS)
        teachers.append((str(root / name), overrides, brain))
    paths = timit_kd.save_teachers(data, str(root / "ensemble"),
                                   [t[:2] for t in teachers], RUN_OPTS)
    return root, data, teachers, paths


def test_teacher_runs_validate_and_test(chain):
    """``run``: NewBob on the validation PER, the beam search's PERs, the
    log and the PER file, the checkpoint's recoverables."""
    root, _, teachers, _ = chain
    for folder, _, brain in teachers:
        for stage in ("VALID", "TEST"):
            stats = brain.stage_stats[stage]
            assert set(stats) == {"loss", "PER"}
            assert all(np.isfinite(v) for v in stats.values())
        log = (Path(folder) / "train_log.txt").read_text().splitlines()
        assert log[0].startswith("epoch: 1, lr: 1.00e+00 - train loss")
        assert log[1].startswith("Epoch loaded: 1 - test loss")
        assert "%WER" in (Path(folder) / "per.txt").read_text()
        names = {f.name for f in brain._recovered_ckpt.path.iterdir()}
        assert {"brain.ckpt", "train_state.ckpt", "lr_annealing.ckpt",
                "train_loader.ckpt", "epoch_counter.ckpt"} <= names
    lstm = teachers[1][2].modules.enc.rnn
    assert type(lstm).__name__ == "LSTM"


def test_save_teachers_matches_the_jax_script(chain):
    """JAX's ``save_teachers.py`` ``main`` runs on the posteriors the
    port's teachers give (its yaml loading, Brains, loaders and forward
    replaced by stand-ins that hand them over, in the same loader order);
    its npz files equal the port's, key for key and bit for bit."""
    root, data, teachers, paths = chain
    posteriors = []  # per teacher: per split: the batches
    for folder, overrides, _ in teachers:
        parts = timit_seq2seq.build(data, folder, overrides, RUN_OPTS)
        parts["brain"].checkpointer.recover_if_possible(min_key="PER")
        per_split = {}
        for split in ("train", "valid", "test"):
            loader = SaveableDataLoader(parts["datasets"][split],
                                        batch_size=8)
            per_split[split] = [
                (batch.id, *timit_kd.teacher_posteriors(parts["brain"],
                                                        batch))
                for batch in loader]
        posteriors.append(per_split)

    mod = _load_path("save_teachers_jax", KD_DIR / "save_teachers.py")
    out = root / "jax_ensemble"
    out.mkdir()
    current = {}

    class Teacher:
        def __init__(self, hparams, **_):
            current["i"] = hparams["i"]
            self.checkpointer = types.SimpleNamespace(
                recover_if_possible=lambda **_: None)

    def loader(dataset, batch_size):
        assert batch_size == 8
        return [{"id": ids, "split": dataset, "k": k}
                for k, (ids, *_) in enumerate(
                    posteriors[current["i"]][dataset])]

    def forward(brain, batch):
        _, ctc, seq, mask = posteriors[current["i"]][batch["split"]][
            batch["k"]]
        return ctc, seq, {"batch_mask": mask}

    yamls = {"st.yaml": {"output_folder": str(out), "batch_size": 8,
                         "data_folder": data, "teacher_dirs": ["t0", "t1"],
                         "teacher_yamls": ["y0", "y1"]},
             "y0": {"i": 0, "save_folder": "t0"},
             "y1": {"i": 1, "save_folder": "t1"}}
    mod._load_teacher_module = lambda: types.SimpleNamespace(
        ASR=Teacher, dataio_prep=lambda hp: (
            {s: s for s in ("train", "valid", "test")}, None))
    mod.SaveableDataLoader = loader
    mod.forward_posteriors = forward
    mod.load_hyperpyyaml = lambda f, overrides=None: dict(
        yamls[Path(f.name).name], modules={}, opt_class=None)
    mod.sb = types.SimpleNamespace(
        parse_arguments=lambda argv: (str(root / "st.yaml"), {}, {}),
        create_experiment_directory=lambda *a, **k: None)
    for name in ("st.yaml", "y0", "y1"):
        (root / name).write_text("")
    mod.Checkpointer = lambda *a, **k: None
    cwd = Path.cwd()
    try:
        os.chdir(root)
        mod.main()
    finally:
        os.chdir(cwd)
    for split, path in paths.items():
        got, want = np.load(path), np.load(out / f"ensemble_{split}.npz")
        assert sorted(got.files) == sorted(want.files) and got.files
        for key in want.files:
            assert got[key].dtype == np.float16
            assert got[key].tobytes() == want[key].tobytes(), key
    n_train = len([k for k in np.load(paths["train"]).files
                   if k.endswith("__ctc")])
    assert n_train == 8


def _final_state(brain):
    return ({k: v.clone() for k, v in brain.modules.state_dict().items()},
            brain.optimizer.state_dict()["state"], brain.lr,
            brain.lr_annealing.metric_values)


@pytest.mark.parametrize("kind", ["seq2seq", "kd"])
def test_resumed_epoch_equals_the_uninterrupted_one(chain, tmp_path, kind):
    """A fresh Brain resumes epoch 2 from the checkpoint of epoch 1 and
    ends where 2 uninterrupted epochs end, bit for bit (modules,
    Adadelta's accumulators, the rate, NewBob's history); the student
    then tests from its best checkpoint."""
    root, data, _, paths = chain

    def fit(out, epochs):
        overrides = dict(TOY, number_of_epochs=epochs, dropout=0.15)
        if kind == "kd":
            parts = timit_kd.build_kd(data, out, str(root / "ensemble"),
                                      overrides, RUN_OPTS)
        else:
            parts = timit_seq2seq.build(data, out, overrides, RUN_OPTS)
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts

    fit(str(tmp_path / "resumed"), 1)
    resumed = fit(str(tmp_path / "resumed"), 2)
    whole = fit(str(tmp_path / "whole"), 2)
    (ma, oa, lra, nba), (mb, ob, lrb, nbb) = (_final_state(resumed["brain"]),
                                             _final_state(whole["brain"]))
    assert ma.keys() == mb.keys()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert lra == lrb and nba == nbb and len(nba) == 2
    if kind == "kd":
        brain = resumed["brain"]
        brain.evaluate(resumed["test_loader"], min_key="PER")
        assert np.isfinite(brain.stage_stats["TEST"]["PER"])
    shutil.rmtree(tmp_path / "whole")


def test_run_kd_end_to_end(chain, tmp_path):
    """``run_kd``: the student trains on the ensemble's arrays, validates
    and tests by the beam search's PER; without them it cannot build."""
    root, data, _, _ = chain
    brain = timit_kd.run_kd(data, str(tmp_path / "kd"),
                            str(root / "ensemble"), TOY, RUN_OPTS)
    for stage in ("VALID", "TEST"):
        assert all(np.isfinite(v) for v in brain.stage_stats[stage].values())
    with pytest.raises(FileNotFoundError):
        timit_kd.build_kd(data, str(tmp_path / "kd2"), str(tmp_path / "none"),
                          TOY, RUN_OPTS)


def test_jax_dataio_puts_bos_and_eos_after_the_phones(tree, first_batch,
                                                      tmp_path):
    """JAX's ``seq2seq/train.py`` ``dataio_prep`` appends ``<bos>`` and
    ``<eos>`` after the phones, so the yaml's bos 1 and eos 2, which its
    batches and searcher use, are phones (the decoder starts from a phone
    and a hypothesis ends at another); the port's encoder holds them at 1
    and 2 and its phones after them."""
    root, _ = tree
    train = _load_path("timit_seq2seq_train_jax", S2S / "train.py")
    _, enc = first_batch
    hp = {f"{s}_json": str(root / f"m/{n}.json")
          for s, n in (("train", "train"), ("valid", "dev"), ("test", "test"))}
    _, jenc = train.dataio_prep(dict(hp, save_folder=str(tmp_path),
                                     bos_index=1, eos_index=2))
    assert jenc.lab2ind["<blank>"] == 0
    assert jenc.lab2ind["<bos>"] > 2 and jenc.lab2ind["<eos>"] > 2
    assert jenc.ind2lab[1] not in ("<bos>", "<eos>")
    assert (enc.lab2ind["<bos>"], enc.lab2ind["<eos>"]) == (1, 2)
    assert sorted(enc.lab2ind) == sorted(jenc.lab2ind)
