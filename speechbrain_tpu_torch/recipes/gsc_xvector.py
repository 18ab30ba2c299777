"""The Google Speech Commands x-vector keyword recipe end to end, on the
port.

Does what ``recipes/Google-speech-commands/train.py`` does with
``hparams/xvect.yaml``: a Speech Commands tree (one folder a word,
``validation_list.txt`` and ``testing_list.txt``) -> JSON manifests
(``prepare_gsc``: the 10 commands, the other words as ``_unknown_``) ->
``SpeakerBrain.fit`` (``TimeDomainSpecAugment`` in training -> ``Fbank``
(24 mels) -> ``Xvector`` over each row's frames -> ``Classifier`` ->
``nll_loss``; Adam at the NewBob-annealed rate on the validation loss;
checkpoints keep the best by validation accuracy) ->
``evaluate(max_key="acc")`` on the test set.  A killed run resumes from
its latest checkpoint when ``run`` is called again on the same output
folder.  The model runs no TPU kernel.

The yaml's values are ``HPARAMS`` (the yaml file itself is not read);
``overrides`` replace any of them, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import gsc_xvector
    brain = gsc_xvector.run("/data/GSC", "results/gsc_xvector",
                            run_opts={"device": "cpu"},
                            overrides={"tdnn_channels": (8,) * 5, ...})

As in the JAX recipe, ``prepare_gsc`` makes no ``_silence_`` rows (the
``_``-folders, such as ``_background_noise_``, are skipped), so the
12th class is never a target.  Two differences from the JAX recipe:
``TimeDomainSpecAugment``'s speed change gives lengths that follow the
resampled content (``processing/speech_augmentation.py``), and the Brain
registers the NewBob schedule with its checkpointer (``"lr_annealing"``),
which the JAX recipe does not.
"""

import json
import os
import wave

import numpy as np
import torch

from ..asr import _random_init
from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..lobes.augment import TimeDomainSpecAugment
from ..lobes.features import Fbank
from ..lobes.models.Xvector import Classifier, Xvector
from ..nnet.losses import nll_loss
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import AccuracyStats
from ..utils.train_logger import FileTrainLogger
from .common import NewBobBrain, recipe_hparams

__all__ = ["HPARAMS", "COMMANDS12", "prepare_gsc", "dataio_prep",
           "SpeakerBrain", "build", "run", "write_synthetic_gsc"]

SAMPLERATE = 16000

# recipes/Google-speech-commands/hparams/xvect.yaml (with the JAX
# Brain's defaults: clip 5, fp32)
HPARAMS = dict(
    seed=1986,
    number_of_commands=12,
    sample_rate=16000,
    n_mels=24,
    batch_size=32,
    number_of_epochs=20,
    lr=0.001,
    # TimeDomainSpecAugment's arguments (None: no augmentation)
    augmentation={"sample_rate": 16000, "speeds": [95, 100, 105]},
    tdnn_channels=(512, 512, 512, 512, 1500),
    lin_neurons=512,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
    precision="fp32",
)

COMMANDS12 = ["yes", "no", "up", "down", "left", "right", "on", "off",
              "stop", "go", "_unknown_", "_silence_"]


def prepare_gsc(data_folder, save_folder, n_commands=12):
    """Write ``<save_folder>/{train,valid,test}.json`` from a Speech
    Commands tree: every ``<word>/*.wav`` (folders starting with ``_``
    skipped), in ``validation_list.txt`` or ``testing_list.txt`` (paths
    ``<word>/<file>``) or else train; the label is the word if it is one
    of the 10 commands, else ``_unknown_``, and ``command_id`` its index
    in ``COMMANDS12``.  A copy of the JAX recipe's ``prepare_gsc``.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_gsc(d, {"train": 3, "valid": 1, "test": 1})
    >>> prepare_gsc(d, d + "/save")
    >>> sorted(len(json.load(open(f"{d}/save/{s}.json")))
    ...        for s in ("train", "valid", "test"))
    [1, 1, 3]
    """
    os.makedirs(save_folder, exist_ok=True)
    known = set(COMMANDS12[:10])
    val_list = test_list = set()
    for name, fname in (("valid", "validation_list.txt"),
                        ("test", "testing_list.txt")):
        p = os.path.join(data_folder, fname)
        if os.path.exists(p):
            with open(p) as f:
                lst = {line.strip() for line in f}
            if name == "valid":
                val_list = lst
            else:
                test_list = lst
    manifests = {"train": {}, "valid": {}, "test": {}}
    for cmd in os.listdir(data_folder):
        cmd_dir = os.path.join(data_folder, cmd)
        if not os.path.isdir(cmd_dir) or cmd.startswith("_"):
            continue
        label = cmd if cmd in known else "_unknown_"
        for wav in os.listdir(cmd_dir):
            if not wav.endswith(".wav"):
                continue
            rel = f"{cmd}/{wav}"
            split = ("valid" if rel in val_list
                     else "test" if rel in test_list else "train")
            manifests[split][rel.replace("/", "_")] = {
                "wav": os.path.join(cmd_dir, wav),
                "command": label,
                "command_id": COMMANDS12.index(label),
            }
    for split, data in manifests.items():
        with open(os.path.join(save_folder, f"{split}.json"), "w") as f:
            json.dump(data, f)


def dataio_prep(hparams):
    """The recipe's datasets (``train.py:115-124``): ``sig`` read from the
    manifests' files, with ``command_id``."""
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.set_output_keys(["id", "sig", "command_id"])
        datasets[split] = ds
    return datasets


def build_modules(hparams, seed=0):
    """The recipe's modules, with Lecun-normal weights from ``seed``:
    ``compute_features`` (``Fbank``, ``n_mels``), ``embedding_model``
    (``Xvector``) and ``classifier`` (``Classifier``)."""
    hp = dict(HPARAMS, **hparams)
    modules = {
        "compute_features": Fbank(sample_rate=hp["sample_rate"],
                                  n_mels=hp["n_mels"]),
        "embedding_model": Xvector(hp["n_mels"],
                                   tdnn_channels=hp["tdnn_channels"],
                                   lin_neurons=hp["lin_neurons"]),
        "classifier": Classifier(hp["lin_neurons"],
                                 out_neurons=hp["number_of_commands"],
                                 lin_neurons=hp["lin_neurons"]),
    }
    gen = torch.Generator().manual_seed(seed)
    for name in ("embedding_model", "classifier"):
        _random_init(modules[name], gen)
    return modules


class SpeakerBrain(NewBobBrain):
    """The Speech Commands recipe's ``SpeakerBrain``
    (``train.py:67-112``).

    ``compute_forward``: in training, ``TimeDomainSpecAugment``
    (``hparams["augmentation"]``'s arguments; None: off) on the
    waveforms and their lengths, with draws from ``self.generator`` ->
    ``Fbank`` -> cast to the activation dtype -> ``Xvector`` over each
    row's ``lengths`` -> ``Classifier`` of the (B, lin_neurons)
    embeddings -> log-probs.  ``compute_objectives``: ``nll_loss`` with
    ``length=batch_mask`` (dummy rows masked); outside training it also
    appends the real rows' predictions to ``self.acc_metric``, an
    ``AccuracyStats``.

    The optimizer is ``torch.optim.Adam`` (0.9, 0.999, eps 1e-8), optax's
    ``adam`` (its ``eps_root`` is 0), after the Brain's clip to a global
    norm of ``max_grad_norm``, at ``self.lr``: ``lr`` (1e-3), then what
    ``self.lr_annealing`` (``NewBobScheduler``: factor 0.8, threshold
    0.0025) gives the validation loss at each epoch's end.
    ``on_stage_end`` at VALID also writes the logger's line and, with a
    checkpointer, saves one with ``meta={"acc": acc}`` and keeps the best
    by accuracy.  The last stats of each stage are in
    ``self.stage_stats``; with a ``checkpointer`` the NewBob schedule is
    registered as ``"lr_annealing"``.  A batch is a dict of ``sig`` (B,
    samples), ``sig_lens`` (B,) relative and ``command_id`` (B,).

    Example
    -------
    >>> hp = {"tdnn_channels": (4,) * 5, "lin_neurons": 4, "n_mels": 8}
    >>> brain = SpeakerBrain(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(3, 8000)).astype(np.float32),
    ...     "sig_lens": np.array([1.0, 0.8, 0.9], np.float32),
    ...     "command_id": np.array([0, 3, 10])}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    metric = "acc"
    best = "max"
    anneal_on_loss = True

    def __init__(self, hparams=None, run_opts=None, checkpointer=None):
        hp = dict(HPARAMS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adam(params, lr=hp["lr"], betas=(0.9, 0.999),
                                    eps=1e-8)

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        aug = hp["augmentation"]
        self.augment = (None if aug is None
                        else TimeDomainSpecAugment(**aug).to(self.device))

    def compute_forward(self, batch, stage):
        """Returns the (B, number_of_commands) log-probs."""
        wavs, lens = batch["sig"], batch["sig_lens"]
        if stage == Stage.TRAIN and self.augment is not None:
            wavs, lens = self.augment(wavs, lens, self.generator)
        m = self.modules
        feats = m.compute_features(wavs).to(self.dtype)
        emb = m.embedding_model(feats, lengths=lens)
        return m.classifier(emb[:, 0])

    def compute_objectives(self, predictions, batch, stage):
        """``nll_loss`` over the real rows; outside training, accuracy."""
        loss = nll_loss(predictions, batch["command_id"],
                        length=batch["batch_mask"])
        if stage != Stage.TRAIN and hasattr(self, "acc_metric"):
            real = int(batch["batch_mask"].sum())
            self.acc_metric.append(predictions[:real, None, :],
                                   batch["command_id"][:real, None])
        return loss

    def on_stage_start(self, stage, epoch=None):
        """A new ``AccuracyStats`` outside training."""
        if stage != Stage.TRAIN:
            self.acc_metric = AccuracyStats()

    def summarize_metric(self):
        """The stage's accuracy (``train.py:97-112``)."""
        return self.acc_metric.summarize()


def build(data_folder, output_folder, overrides=None, run_opts=None):
    """Everything ``run`` trains with, built as the recipe's ``__main__``
    builds it (``train.py:127-164``): the manifests (written again every
    time, as ``prepare_gsc`` does), the datasets, the loaders (train
    shuffled, batches of ``batch_size``), an ``EpochCounter`` and a
    ``SpeakerBrain`` with a ``Checkpointer`` on ``<output_folder>/save``
    and a ``FileTrainLogger`` on ``<output_folder>/train_log.txt``.
    Arguments and the returned dict as in ``timit_ctc.build`` (no label
    encoder)."""
    hp = recipe_hparams(HPARAMS, data_folder, output_folder, overrides,
                        [(f"{s}_json", s) for s in ("train", "valid", "test")])
    run_on_main(prepare_gsc, kwargs={"data_folder": hp["data_folder"],
                                     "save_folder": hp["save_folder"]})
    datasets = dataio_prep(hp)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = SpeakerBrain(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
             epoch_counter=epoch_counter),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]))
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None):
    """The recipe's ``__main__`` (``train.py:127-170``): ``build``, then
    ``fit`` (resuming from the latest checkpoint), then ``evaluate`` on
    the test set from the checkpoint with the highest validation
    accuracy.  Returns the Brain (``brain.stage_stats`` holds the last
    VALID and TEST loss and accuracy)."""
    parts = build(data_folder, output_folder, overrides, run_opts)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], max_key="acc")
    return brain


def write_synthetic_gsc(folder, counts, seconds=(0.6, 1.0),
                        unknown_words=("bed", "bird"), seed=0):
    """Write a Speech Commands-shaped tree of synthetic clips, for trying
    the recipe without the corpus: ``counts`` maps "train", "valid" and
    "test" to their numbers of clips, dealt in turn to the 10 commands
    and the ``unknown_words``; each clip is a 16 kHz 16-bit WAV of noise
    and a word-dependent tone lasting ``seconds`` (uniform), named
    ``<word>/<8 hex>_nohash_<i>.wav``; the valid and test clips are
    listed in ``validation_list.txt`` and ``testing_list.txt``; a
    ``_background_noise_`` folder holds one clip, which the preparation
    skips.  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    words = COMMANDS12[:10] + list(unknown_words)
    lists = {"valid": [], "test": []}

    def write(path, samples, f0):
        t = np.arange(samples) / SAMPLERATE
        sig = (0.05 * rng.standard_normal(samples)
               + 0.3 * np.sin(2 * np.pi * f0 * t))
        pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLERATE)
            w.writeframes(pcm.tobytes())

    n = 0
    for split in ("train", "valid", "test"):
        for _ in range(counts.get(split, 0)):
            w = n % len(words)
            os.makedirs(os.path.join(folder, words[w]), exist_ok=True)
            rel = f"{words[w]}/{int(rng.integers(16 ** 8)):08x}_nohash_{n}.wav"
            write(os.path.join(folder, rel),
                  int(rng.uniform(*seconds) * SAMPLERATE),
                  200.0 + 150.0 * w + rng.uniform(-20, 20))
            if split in lists:
                lists[split].append(rel)
            n += 1
    for split, fname in (("valid", "validation_list.txt"),
                         ("test", "testing_list.txt")):
        with open(os.path.join(folder, fname), "w") as f:
            f.write("".join(rel + "\n" for rel in lists[split]))
    os.makedirs(os.path.join(folder, "_background_noise_"), exist_ok=True)
    write(os.path.join(folder, "_background_noise_", "noise.wav"),
          SAMPLERATE, 50.0)
