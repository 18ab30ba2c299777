"""The WSJ0-2mix separation recipe on the port (``recipes/
wsj0mix_separation``) against the JAX recipe (``recipes/WSJ0Mix/
separation/train.py``'s ``Separation``, ``prepare_wsjmix`` and
``dataio_prep``, taken by path, hparams from ``hparams/sepformer.yaml``
through JAX's ``load_hyperpyyaml``), on one synthetic tree at toy widths
(d_model 16, chunks of 10, one layer of each block), f32:

- the two preparations give the same manifests;
- both Brains fit 2 epochs from the same weights (the port's, through the
  bridge) on the same batches: training mixtures shorter than
  ``training_signal_len`` (zero-padded, no crop), validation and test
  batches padded with a dummy row, which ``batch_mask`` weights 0.  The
  per-step losses agree within 2e-6 relative (f32 rounding, carried by
  Adam's steps: at most 3e-7 apart in the runs that set it), the rates
  exactly (the validation loss falls, so the plateau schedule keeps the
  rate; ``test_torch_separation.py`` holds its halvings to JAX's), the
  validation and test losses (the negative SI-SNR in dB) within 2e-6
  relative;
- ``train_log.txt`` has the same lines up to the numbers.

And the port alone: 2 epochs and a resumed third in a fresh Brain end
with the state of 3 uninterrupted epochs, bit for bit (the modules,
Adam's state, the rate, the plateau schedule, the generator), with
mixtures longer than the crop; the keyed crop; the plateau schedule's
registration; the manifests' durations at the files' rate; the
conformer-intra and Conv-TasNet yamls through ``run``.  Each of the JAX
recipe's three faults that the port repairs has a test that shows the
JAX behaviour beside the port's.
"""

import functools
import json
import re
import shutil
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio.batch import BatchShapePolicy as JPolicy
from speechbrain_tpu.dataio.batch import PaddedBatch as JPaddedBatch
from speechbrain_tpu.dataio.dataloader import SaveableDataLoader as JLoader
from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.dataio.batch import BatchShapePolicy, PaddedBatch
from speechbrain_tpu_torch.recipes import wsj0mix_separation as recipe

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_timit import _jax_initialize, _load_path

REPO = Path(__file__).resolve().parents[1]
SEPARATION = REPO / "recipes/WSJ0Mix/separation"

TOY = dict(encoder_out_nchannels=16, masknet_chunksize=10,
           masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1,
           intra_nhead=4, inter_nhead=4, intra_dffn=32, inter_dffn=32,
           conformer_kernel_size=5)
TOY_TASNET = dict(N=16, B=8, H=16, X=2, R=1)
CROP, VALID_SAMPLES, ROWS = 2400, 2000, 2
TREE = {"tr": 6, "cv": 3, "tt": 3}
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}


def _write_tree(folder, seed=0):
    """Training mixtures of 0.2-0.3 s (at most ``CROP`` samples: padded,
    not cropped); validation and test ones of ``VALID_SAMPLES``."""
    recipe.write_synthetic_wsj0mix(folder, {"tr": TREE["tr"]}, (0.2, 0.3),
                                   seed)
    recipe.write_synthetic_wsj0mix(
        folder, {"cv": TREE["cv"], "tt": TREE["tt"]},
        (VALID_SAMPLES / 8000,) * 2, seed + 1)


def _policy(cls, samples):
    return cls(time_buckets=[samples], pad_batch_to=ROWS)


def _record(brain, out):
    fit_end, stage_end = brain.on_fit_batch_end, brain.on_stage_end

    def on_fit_batch_end(batch, outputs, loss, should_step):
        out["losses"].append(float(loss))
        out["lrs"].append(brain.lr)
        fit_end(batch, outputs, loss, should_step)

    def on_stage_end(stage, stage_loss, epoch=None):
        if stage.name != "TRAIN":
            out[stage.name].append(float(stage_loss))
        stage_end(stage, stage_loss, epoch)

    brain.on_fit_batch_end = on_fit_batch_end
    brain.on_stage_end = on_stage_end


def _rel_close(a, b, rtol):
    assert abs(a - b) <= rtol * max(1.0, abs(b)), (a, b)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsj0mix")
    data = str(root / "wsj")
    _write_tree(data)
    train = _load_path("wsj_train", SEPARATION / "train.py")

    # ---- the port
    overrides = dict(TOY, training_signal_len=CROP, number_of_epochs=2,
                     batch_size=ROWS)
    parts = recipe.build(data, str(root / "port"), overrides, RUN_OPTS)
    pb = parts["brain"]
    for key, samples in (("train_loader", CROP),
                         ("valid_loader", VALID_SAMPLES),
                         ("test_loader", VALID_SAMPLES)):
        policy = _policy(BatchShapePolicy, samples)
        parts[key].collate_fn = functools.partial(PaddedBatch,
                                                  shape_policy=policy)

    # ---- JAX: train.py's __main__ at the same widths
    yaml = "".join(f"{k}: {v}\n" for k, v in TOY.items()
                   if k != "conformer_kernel_size")
    with open(SEPARATION / "hparams" / "sepformer.yaml") as f:
        hp = load_hyperpyyaml(f, yaml + f"""
training_signal_len: {CROP}
number_of_epochs: 2
batch_size: {ROWS}
data_folder: {data}
output_folder: {root / 'jax'}
""")
    train.prepare_wsjmix(hp["data_folder"], hp["save_folder"], hp["num_spks"])
    manifests = {s: (json.load(open(Path(hp["save_folder"]) / f"wsj_{s}.json")),
                     json.load(open(Path(parts["hparams"]["save_folder"])
                                    / f"wsj_{s}.json")))
                 for s in ("tr", "cv", "tt")}
    datasets = train.dataio_prep(hp)

    class JaxSeparation(train.Separation):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            from speechbrain_tpu.parallel.mesh import make_mesh
            self.mesh = make_mesh(jax.devices()[:1])

        # the jitted loss (the recipe's eager one compiles op by op)
        evaluate_batch_full = train.Separation.evaluate_batch

    jb = JaxSeparation(
        modules=hp["modules"],
        opt_class=lambda lr: hp["opt_class"](learning_rate=lr), hparams=hp,
        run_opts={"loss_sync_interval": 1, "noprogressbar": True},
        checkpointer=JCheckpointer(hp["save_folder"]))
    params = bridge.to_jax_sepformer(pb.modules.state_dict(), "masknet.")
    _jax_initialize(jb, {"params": {"masknet": jax.tree_util.tree_map(
        jnp.asarray, params)}, "model_state": {}, "extra": {}})

    def loader(split, samples, shuffle=False):
        return JLoader(datasets[split], batch_size=ROWS, shuffle=shuffle,
                       collate_fn=lambda ex: JPaddedBatch(
                           ex, shape_policy=_policy(JPolicy, samples)))

    out = {name: {"losses": [], "lrs": [], "VALID": [], "TEST": []}
           for name in ("jax", "port")}
    _record(jb, out["jax"])
    _record(pb, out["port"])
    jb.fit(hp["epoch_counter"], loader("train", CROP, True),
           loader("valid", VALID_SAMPLES))
    jb.evaluate(loader("test", VALID_SAMPLES), min_key="si-snr")
    pb.fit(parts["epoch_counter"], parts["train_loader"],
           parts["valid_loader"])
    pb.evaluate(parts["test_loader"], min_key="si-snr")
    return dict(out, root=root, jb=jb, pb=pb, manifests=manifests)


def test_recipe_manifests_match_jax(fitted):
    """The same mixtures, files and durations (at 8 kHz, where JAX's
    fixed rate is right) in the same splits."""
    for split, (j, p) in fitted["manifests"].items():
        assert j == p and len(p) == TREE[split], split
        assert all(set(e) == {"mix_wav", "s1_wav", "s2_wav", "duration"}
                   for e in p.values())


def test_recipe_losses_and_rates_match_jax(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert len(p["losses"]) == len(j["losses"]) == 6  # 3 batches x 2 epochs
    for a, b in zip(p["losses"], j["losses"]):
        _rel_close(a, b, 2e-6)
    assert p["lrs"] == j["lrs"] and p["lrs"][0] == recipe.HPARAMS_SEPFORMER["lr"]
    assert fitted["pb"].lr == fitted["jb"].lr
    assert fitted["pb"].lr_scheduler.losses == pytest.approx(
        fitted["jb"].hparams.lr_scheduler.losses, rel=2e-6)


def test_recipe_validation_and_test_si_snr_match_jax(fitted):
    """The validation losses of both epochs and the test loss from the
    best checkpoint (the negative SI-SNR, dummy rows masked), and the
    log's lines up to the numbers."""
    j, p = fitted["jax"], fitted["port"]
    assert len(p["VALID"]) == len(j["VALID"]) == 2
    assert len(p["TEST"]) == len(j["TEST"]) == 1
    for a, b in zip(p["VALID"] + p["TEST"], j["VALID"] + j["TEST"]):
        _rel_close(a, b, 2e-6)
    pb = fitted["pb"]
    assert pb.stage_stats["TEST"]["si-snr"] == p["TEST"][0]
    best = min(c.meta["si-snr"] for c in pb.checkpointer.list_checkpoints())
    assert best == min(p["VALID"])

    def shape(path):
        return [re.sub(r"-?\d[\d.e+-]*", "#", line)
                for line in Path(path).read_text().splitlines()]

    root = fitted["root"]
    got = shape(root / "port" / "train_log.txt")
    assert got == shape(root / "jax" / "train_log.txt")
    assert len(got) == 2


def test_plateau_schedule_is_registered(fitted):
    """The port's checkpointer holds the plateau schedule; the JAX
    recipe's bare ``Checkpointer`` does not (a resumed JAX run restarts
    it: listed in ROADMAP as a fault)."""
    pb, jb = fitted["pb"], fitted["jb"]
    assert pb.checkpointer.recoverables["lr_scheduler"] is pb.lr_scheduler
    assert jb.hparams.lr_scheduler not in (
        jb.checkpointer.recoverables.values())


def test_crop_is_keyed_by_epoch_and_mixture(tmp_path):
    """``MixtureCrop`` cuts the mixture and its sources at one start, the
    same for a mixture and epoch whatever was cropped before it, and
    another at another epoch; JAX's pipeline, one generator for all,
    crops a mixture differently when the order of the reads changes (as
    on a resumed epoch or with loader threads)."""
    crop = recipe.MixtureCrop(samples=100, seed=7)
    sigs = [np.arange(1000.0), np.arange(1000.0) + 0.5, -np.arange(1000.0)]
    first = crop(sigs, "m1")
    assert all(len(s) == 100 for s in first)
    assert first[1][0] == first[0][0] + 0.5 and first[2][0] == -first[0][0]
    crop(sigs, "m2")
    assert np.array_equal(crop(sigs, "m1")[0], first[0])
    crop.set_epoch(2)
    assert not np.array_equal(crop(sigs, "m1")[0], first[0])
    # JAX's shared generator: the crop of "synth0001" depends on the reads
    data = str(tmp_path / "wsj")
    recipe.write_synthetic_wsj0mix(data, {"tr": 2, "cv": 1, "tt": 1},
                                   (0.5, 0.6), seed=3)
    train = _load_path("wsj_train_crop", SEPARATION / "train.py")
    train.prepare_wsjmix(data, str(tmp_path / "save"))
    hp = {"training_signal_len": 800, "limit_training_signal_len": True,
          "seed": 1234, **{f"{s}_data": str(tmp_path / "save" / f"wsj_{t}.json")
                           for s, t in (("train", "tr"), ("valid", "cv"),
                                        ("test", "tt"))}}
    a = train.dataio_prep(hp)["train"]
    b = train.dataio_prep(hp)["train"]
    in_order = a[1]["mix_sig"]
    b[0]  # another mixture read first
    assert not np.array_equal(b[1]["mix_sig"], in_order)
    ds, _ = recipe.dataio_prep(hp)
    port_first = ds["train"][1]["mix_sig"]
    ds["train"][0]
    assert np.array_equal(ds["train"][1]["mix_sig"], port_first)


def test_manifest_durations_follow_the_file_rate(tmp_path):
    """At 16 kHz the port's durations are the files' seconds; JAX's
    ``prepare_wsjmix`` divides by 8000 whatever the rate, doubling them
    (listed in ROADMAP as a fault)."""
    data = str(tmp_path / "wsj16k")
    recipe.write_synthetic_wsj0mix(data, {"tr": 2, "cv": 1, "tt": 1},
                                   (0.5, 0.6), seed=4, sample_rate=16000)
    train = _load_path("wsj_train_rate", SEPARATION / "train.py")
    train.prepare_wsjmix(data, str(tmp_path / "jax"))
    recipe.prepare_wsjmix(data, str(tmp_path / "port"))
    jm = json.load(open(tmp_path / "jax" / "wsj_tr.json"))
    pm = json.load(open(tmp_path / "port" / "wsj_tr.json"))
    for key, entry in pm.items():
        with wave.open(entry["mix_wav"]) as w:
            seconds = w.getnframes() / w.getframerate()
        assert entry["duration"] == round(seconds, 3)
        assert jm[key]["duration"] == round(2 * seconds, 3)


def test_recipe_resumed_epoch_equals_the_uninterrupted_one(tmp_path):
    """``run`` for 2 epochs (then the test pass), then a fresh Brain on a
    copy of its folder runs epoch 3 and ends where 3 uninterrupted epochs
    end, bit for bit: the modules, Adam's state, the rate, the plateau
    schedule's anchor, patience and losses, and the generator; with
    mixtures longer than the crop (cropped, keyed by epoch)."""
    data = str(tmp_path / "wsj")
    recipe.write_synthetic_wsj0mix(data, {"tr": 4, "cv": 2, "tt": 2},
                                   (0.3, 0.5), seed=5)
    hp = dict(TOY, training_signal_len=2000, batch_size=2)
    opts = dict(RUN_OPTS, loss_sync_interval=2)

    def fit(out, epochs):
        parts = recipe.build(data, out, dict(hp, number_of_epochs=epochs),
                             opts)
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    first = recipe.run(data, str(tmp_path / "first"),
                       dict(hp, number_of_epochs=2), opts)
    assert np.isfinite(first.stage_stats["TEST"]["si-snr"])
    shutil.copytree(tmp_path / "first", tmp_path / "resumed")
    resumed = fit(str(tmp_path / "resumed"), 3)
    whole = fit(str(tmp_path / "whole"), 3)
    a, b = resumed.modules.state_dict(), whole.modules.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = (resumed.optimizer.state_dict()["state"],
              whole.optimizer.state_dict()["state"])
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert resumed.lr == whole.lr
    ra, rb = resumed.lr_scheduler, whole.lr_scheduler
    assert (ra.anchor, ra.patience_counter, ra.losses) == (
        rb.anchor, rb.patience_counter, rb.losses)
    assert len(ra.losses) == 3  # a restarted schedule would hold one
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert resumed.hparams.crop.epoch == 3


@pytest.mark.parametrize("name", ["sepformer-conformerintra", "convtasnet"])
def test_other_yamls_train_through_run(name, tmp_path):
    """The conformer-intra and Conv-TasNet yamls through ``run`` at toy
    widths: one epoch, finite losses, the test pass from the best
    checkpoint."""
    data = str(tmp_path / "wsj")
    recipe.write_synthetic_wsj0mix(data, {"tr": 2, "cv": 1, "tt": 1},
                                   (0.2, 0.3), seed=6)
    hparams = (recipe.HPARAMS_SEPFORMER_CONFORMERINTRA
               if name.startswith("sepformer") else recipe.HPARAMS_CONVTASNET)
    brain = recipe.run(data, str(tmp_path / "out"),
                       dict(TOY, **TOY_TASNET, training_signal_len=2400,
                            number_of_epochs=1, batch_size=2), RUN_OPTS,
                       hparams=hparams)
    assert np.isfinite(brain.avg_train_loss)
    assert np.isfinite(brain.stage_stats["VALID"]["si-snr"])
    assert np.isfinite(brain.stage_stats["TEST"]["si-snr"])
