"""The port's checkpointer (``utils.checkpoints``), epoch counter and
the engine's ``fit``/``evaluate`` loop (``core.Brain``).

The checkpoint cases are those of ``tests/unittests/test_checkpoints.py``
(save/recover, custom hooks, keep best, find by key, partial load
refused, the end-of-epoch flag; averaging is not ported), with tensors
in place of JAX arrays; the port's ``CKPT.yaml`` is JSON, which the JAX
package's ``yaml.safe_load`` reads to the meta that the JAX
``Checkpointer`` writes for the same call.  The engine cases are the
port's counterparts of ``tests/unittests/test_core.py``'s fit tests
(resume of the epoch counter and of the train state in a fresh Brain,
staging that changes nothing but the schedule, the consumed position,
debug truncation, ``steps_per_execute``), and a mid-epoch checkpoint
that resumes with exactly the untrained batches, and
``optimizer_step_limit``.
"""

import time

import numpy as np
import pytest
import torch
import yaml

from speechbrain_tpu.utils.checkpoints import Checkpointer as JCheckpointer
from speechbrain_tpu_torch.core import INTRA_EPOCH_CKPT_FLAG, Brain
from speechbrain_tpu_torch.dataio.dataloader import SaveableDataLoader
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.schedulers import NoamScheduler
from speechbrain_tpu_torch.utils.checkpoints import (
    Checkpointer,
    Recoverable,
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter

from .test_torch_kernels import one_torch_thread  # noqa: F401


def test_save_recover_tensors(tmp_path):
    params = Recoverable({"w": torch.ones(2, 2), "b": torch.zeros(3)})
    ckptr = Checkpointer(tmp_path, {"params": params})
    ckptr.save_checkpoint(meta={"loss": 1.0})
    params.value = {"w": torch.zeros(2, 2), "b": torch.ones(3)}
    ckpt = ckptr.recover_if_possible()
    assert ckpt is not None
    assert float(params.value["w"].sum()) == 4.0
    assert float(params.value["b"].sum()) == 0.0


def test_custom_hooks(tmp_path):
    @register_checkpoint_hooks
    class Counter:
        def __init__(self):
            self.n = 0

        @mark_as_saver
        def _save(self, path):
            with open(path, "w") as f:
                f.write(str(self.n))

        @mark_as_loader
        def _load(self, path, end_of_epoch=True):
            with open(path) as f:
                self.n = int(f.read())

    c = Counter()
    c.n = 7
    ckptr = Checkpointer(tmp_path, {"counter": c})
    ckptr.save_checkpoint()
    c.n = 0
    ckptr.recover_if_possible()
    assert c.n == 7


def test_keep_best(tmp_path):
    obj = Recoverable({"x": torch.zeros(1)})
    ckptr = Checkpointer(tmp_path, {"obj": obj})
    for wer in (10.0, 5.0, 8.0):
        ckptr.save_and_keep_only(meta={"WER": wer}, min_keys=["WER"],
                                 keep_recent=False)
    ckpts = ckptr.list_checkpoints()
    assert len(ckpts) == 1
    assert ckpts[0].meta["WER"] == 5.0


def test_keep_best_and_recent(tmp_path):
    """The recipe's call (``keep_recent`` default): the best by WER and
    the most recent both survive."""
    obj = Recoverable({"x": torch.zeros(1)})
    ckptr = Checkpointer(tmp_path, {"obj": obj})
    for wer in (10.0, 5.0, 8.0):
        ckptr.save_and_keep_only(meta={"WER": wer}, min_keys=["WER"])
    assert sorted(c.meta["WER"] for c in ckptr.list_checkpoints()) == [5.0,
                                                                       8.0]
    assert ckptr.find_checkpoint(min_key="WER").meta["WER"] == 5.0


def test_find_by_key(tmp_path):
    obj = Recoverable({"x": torch.zeros(1)})
    ckptr = Checkpointer(tmp_path, {"obj": obj})
    for acc in (0.5, 0.9, 0.7):
        ckptr.save_checkpoint(meta={"acc": acc})
    assert ckptr.find_checkpoint(max_key="acc").meta["acc"] == 0.9
    assert [c.meta["acc"] for c in ckptr.find_checkpoints()] == [0.7, 0.9,
                                                                 0.5]


def test_partial_load_disallowed(tmp_path):
    obj = Recoverable({"x": torch.zeros(1)})
    ckptr = Checkpointer(tmp_path, {"obj": obj})
    ckptr.save_checkpoint()
    ckptr.add_recoverable("extra", Recoverable({"y": torch.ones(1)}))
    with pytest.raises(RuntimeError):
        ckptr.recover_if_possible()
    ckptr.allow_partial_load = True
    assert ckptr.recover_if_possible() is not None


def test_end_of_epoch_flag(tmp_path):
    counter = EpochCounter(10)
    next(counter)
    next(counter)  # current == 2
    ckptr = Checkpointer(tmp_path, {"epoch": counter})
    ckptr.save_checkpoint(end_of_epoch=False)  # mid-epoch save
    counter.current = 0
    ckptr.recover_if_possible()
    # mid-epoch: epoch 2 did not finish, so it runs again
    assert counter.current == 1


def test_ckpt_meta_reads_as_jax_yaml(tmp_path):
    """The port's ``CKPT.yaml`` (JSON) through JAX's ``yaml.safe_load``
    equals the meta that the JAX ``Checkpointer`` writes for the same
    call, apart from the save time; floats in exponent form stay floats."""
    meta = {"WER": 12.5, "loss": 1e-05, "big": 3e+20, "epoch": 3,
            "name": "x y", "flag": True, INTRA_EPOCH_CKPT_FLAG: True,
            "np": np.float32(0.25), "t": torch.tensor(7.0)}
    port = Checkpointer(tmp_path / "port").save_checkpoint(
        meta=meta, end_of_epoch=False)
    jax_meta = dict(meta, np=0.25, t=7.0)
    jax = JCheckpointer(tmp_path / "jax").save_checkpoint(
        meta=jax_meta, end_of_epoch=False)
    with open(port.path / "CKPT.yaml") as f:
        got = yaml.safe_load(f)
    with open(jax.path / "CKPT.yaml") as f:
        ref = yaml.safe_load(f)
    assert isinstance(got["loss"], float) and isinstance(got["big"], float)
    assert got.pop("unixtime") == pytest.approx(port.meta["unixtime"])
    ref.pop("unixtime")
    assert got == ref
    # and the port reads its own file back to the same values
    again = Checkpointer(tmp_path / "port").list_checkpoints()[0].meta
    assert again["loss"] == 1e-05 and again["end-of-epoch"] is False


def test_noam_checkpoint(tmp_path):
    s = NoamScheduler(lr_initial=1.0, n_warmup_steps=10, model_size=144)
    for _ in range(3):
        s()
    ckptr = Checkpointer(tmp_path, {"noam": s})
    ckptr.save_checkpoint()
    t = NoamScheduler(lr_initial=1.0, n_warmup_steps=10, model_size=144)
    Checkpointer(tmp_path, {"noam": t}).recover_if_possible()
    assert (t.n_steps, t.current_lr) == (3, s.current_lr)
    assert t() == s()
    assert t.normalize == 144 ** -0.5


# ------------------------------------------------------------------ engine


class Tiny(Brain):
    """Linear regression: ``lin(x)`` against ``y``; the TRAIN stage's
    losses are kept in ``self.stage_losses`` and, with a checkpointer,
    each epoch ends with a checkpoint (as the JAX tests' Brains)."""

    def compute_forward(self, batch, stage):
        return self.modules.lin(batch["x"])

    def compute_objectives(self, pred, batch, stage):
        return ((pred - batch["y"]) ** 2).mean()

    def on_stage_end(self, stage, loss, epoch=None):
        if stage.name == "TRAIN":
            self.stage_losses = getattr(self, "stage_losses", [])
            self.stage_losses.append(float(loss))
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(meta={"loss": float(loss)})


def _tiny(ckpt_dir=None, lr=0.05, **run_opts):
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 2)
    opts = {"device": "cpu", "seed": 0, "loss_sync_interval": 1,
            "noprogressbar": True}
    opts.update(run_opts)
    return Tiny({"lin": lin}, lambda p: torch.optim.SGD(p, lr=lr),
                {"lr": lr}, opts,
                checkpointer=None if ckpt_dir is None else Checkpointer(ckpt_dir))


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    data = {f"u{i}": {"x": rng.normal(size=(4, 8)).astype(np.float32),
                      "y": rng.normal(size=(4, 2)).astype(np.float32)}
            for i in range(n)}
    ds = DynamicItemDataset(data)
    ds.set_output_keys(["id", "x", "y"])
    return ds


def _record_losses(brain):
    losses = []
    orig = brain.on_fit_batch_end

    def hook(batch, outputs, loss, should_step):
        losses.append(float(np.ravel(torch.as_tensor(loss).numpy())[-1]))
        orig(batch, outputs, loss, should_step)

    brain.on_fit_batch_end = hook
    return losses


def _spy_epochs(brain):
    epochs = []
    orig = brain._fit_train

    def spy(train_set, epoch, progressbar):
        epochs.append(epoch)
        return orig(train_set, epoch, progressbar)

    brain._fit_train = spy
    return epochs


def test_fit_resume_recovers_epoch_counter(tmp_path):
    def loader():
        return SaveableDataLoader(
            [{"x": np.ones((2, 8), np.float32),
              "y": np.zeros((2, 2), np.float32)}],
            batch_size=1, collate_fn=lambda exs: exs[0])

    c1 = EpochCounter(2)
    _tiny(tmp_path).fit(c1, loader())
    assert c1.current == 2
    b2, c2 = _tiny(tmp_path), EpochCounter(2)
    epochs = _spy_epochs(b2)
    b2.fit(c2, loader())
    assert c2.current == 2 and epochs == []
    b3, c3 = _tiny(tmp_path), EpochCounter(4)
    epochs = _spy_epochs(b3)
    b3.fit(c3, loader())
    assert epochs == [3, 4]


def test_fresh_process_resume_recovers_train_state(tmp_path):
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": np.zeros((4, 2), np.float32)}

    def loader():
        return SaveableDataLoader([data], batch_size=1,
                                  collate_fn=lambda exs: exs[0])

    b1 = _tiny(tmp_path, lr=0.2)
    b1.fit(EpochCounter(6), loader())
    scratch, trained = b1.stage_losses[0], b1.stage_losses[-1]
    assert trained < 0.5 * scratch
    b2 = _tiny(tmp_path, lr=0.2)
    b2.fit(EpochCounter(8), loader())
    assert len(b2.stage_losses) == 2  # epochs 7 and 8 only
    assert b2.stage_losses[0] <= trained * 1.05
    assert b2.optimizer_step == 8


def test_resumed_state_is_bit_identical(tmp_path):
    """A fresh Brain's recovered module and optimizer state equal what
    was saved, bit for bit (AdamW: moments and step)."""
    def make():
        torch.manual_seed(0)
        return Tiny({"lin": torch.nn.Linear(8, 2)},
                    lambda p: torch.optim.AdamW(p, lr=0.01), {"lr": 0.01},
                    {"device": "cpu", "noprogressbar": True},
                    checkpointer=Checkpointer(tmp_path))

    b1 = make()
    b1.fit(EpochCounter(2), SaveableDataLoader(_dataset(6), batch_size=2))
    b2 = make()
    b2.checkpointer.recover_if_possible()
    for k, v in b1.modules.state_dict().items():
        assert torch.equal(v, b2.modules.state_dict()[k]), k
    s1, s2 = b1.optimizer.state_dict(), b2.optimizer.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["state"][i][k]), (i, k)
    assert (b2.optimizer_step, b2.lr, b2.step) == (b1.optimizer_step, b1.lr, 0)


@pytest.mark.parametrize("spe", [1, 2])
def test_staged_fit_matches_sync(spe):
    """Staging (a thread running ``prepare_batch`` ahead) only changes
    the schedule: the same losses bit for bit, also with fused windows."""
    def run(depth):
        brain = _tiny(staging_depth=depth, steps_per_execute=spe)
        losses = _record_losses(brain)
        brain.fit(EpochCounter(2), SaveableDataLoader(_dataset(12, 3),
                                                      batch_size=4))
        return losses, brain.modules.state_dict()

    (sync, sd0), (staged, sd1) = run(0), run(3)
    assert sync == staged and len(sync) > 0
    for k, v in sd0.items():
        assert torch.equal(v, sd1[k]), k


def test_staged_position_reflects_consumption(tmp_path):
    brain = _tiny(staging_depth=4)
    loader = SaveableDataLoader(_dataset(12, 5), batch_size=2)  # 6 batches
    staged = brain._staged_iter(iter(loader), loader)
    consumed = 0
    for _ in staged:
        consumed += 1
        if consumed == 2:
            time.sleep(0.3)  # let the stager run well ahead
            p = tmp_path / "pos.txt"
            loader._save(str(p))
            assert int(p.read_text()) == consumed
            raw = loader._speechbrain_iterator_position  # None: all read
            assert raw is None or raw > consumed
            break
    staged.close()
    assert loader._speechbrain_staged_position is None


def test_debug_mode_truncates():
    brain = _tiny(debug=True, debug_batches=2, debug_epochs=1)
    brain.fit(EpochCounter(10), SaveableDataLoader(_dataset(32),
                                                   batch_size=4))
    assert brain.optimizer_step == 2


def test_fit_with_steps_per_execute():
    brain = _tiny(steps_per_execute=3)
    windows = []
    orig = brain.fit_batches
    brain.fit_batches = lambda batches: (windows.append(len(batches)),
                                         orig(batches))[1]
    brain.fit(EpochCounter(1), SaveableDataLoader(_dataset(16),
                                                  batch_size=4))
    assert windows == [3, 1] and brain.optimizer_step == 4
    assert brain.avg_train_loss > 0


def test_optimizer_step_limit_stops_fit():
    brain = _tiny(optimizer_step_limit=5)
    epochs = _spy_epochs(brain)
    brain.fit(EpochCounter(10), SaveableDataLoader(_dataset(12),
                                                   batch_size=4))
    # 3 steps an epoch: the limit is reached in epoch 2, which finishes
    assert epochs == [1, 2] and brain.optimizer_step == 6


@pytest.mark.parametrize("depth", [0, 2])
def test_intra_epoch_checkpoint_resumes_untrained_batches(tmp_path, depth):
    """A checkpoint taken mid-epoch (``ckpt_interval_minutes``) resumes
    in a fresh Brain with exactly the batches not yet trained on; the
    resumed run ends with the uninterrupted run's parameters, bit for
    bit."""
    ds = _dataset(12, 7)

    def ids_seen(brain):
        seen = []
        orig = brain.fit_batch

        def fit_batch(batch):
            seen.append(float(brain.prepare_batch(batch)["x"][0, 0, 0]))
            return orig(batch)

        brain.fit_batch = fit_batch
        return seen

    ref = _tiny(staging_depth=depth)
    ref_seen = ids_seen(ref)
    ref.fit(EpochCounter(1), SaveableDataLoader(ds, batch_size=2,
                                                shuffle=True))

    class Killed(Exception):
        pass

    b1 = _tiny(tmp_path / "ck", staging_depth=depth, ckpt_interval_minutes=1)
    seen1 = ids_seen(b1)
    orig = b1._save_intra_epoch_ckpt

    def save_then_kill():
        orig()
        raise Killed

    b1._last_ckpt_time = float("-inf")  # due at the first check
    b1._save_intra_epoch_ckpt = save_then_kill
    with pytest.raises(Killed):
        b1.fit(EpochCounter(1), SaveableDataLoader(ds, batch_size=2,
                                                   shuffle=True))
    ckpt = b1.checkpointer.find_checkpoint()
    assert ckpt.meta[INTRA_EPOCH_CKPT_FLAG] and not ckpt.meta["end-of-epoch"]
    b2 = _tiny(tmp_path / "ck", staging_depth=depth)
    seen2 = ids_seen(b2)
    b2.fit(EpochCounter(1), SaveableDataLoader(ds, batch_size=2,
                                               shuffle=True))
    assert len(seen1) == 1 and seen1 + seen2 == ref_seen
    assert b2.optimizer_step == ref.optimizer_step == 6
    for k, v in ref.modules.state_dict().items():
        assert torch.equal(v, b2.modules.state_dict()[k]), k
