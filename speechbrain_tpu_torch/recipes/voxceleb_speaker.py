"""The VoxCeleb speaker recognition recipes end to end, on the port.

Does what ``recipes/VoxCeleb/SpeakerRec/`` does:

- ``train_speaker_embeddings.py`` with ``hparams/train_ecapa_tdnn.yaml``
  (``HPARAMS_ECAPA``) or ``hparams/train_x_vectors.yaml``
  (``HPARAMS_XVECTOR``): a VoxCeleb tree (``wav/<speaker>/<video>/
  <clip>.wav``) -> JSON manifests (``voxceleb_prepare.prepare_voxceleb``:
  90/10 per speaker) -> ``SpeakerBrain.fit`` (clips cropped to
  ``sentence_len`` -> ``TimeDomainSpecAugment`` in training -> ``Fbank``
  (80 mels) -> sentence mean normalization -> the embedding model ->
  the classifier -> ``LogSoftmaxWrapper(AdditiveAngularMargin(0.2, 30))``;
  Adam under ``CyclicLRScheduler``, stepped every optimizer step;
  checkpoints keep the best by validation loss) -> ``save_for_pretrained``
  of the best checkpoint's modules into ``<output_folder>/pretrained``;
- ``speaker_verification_cosine.py`` with ``verification_ecapa.yaml``
  (``verify_cosine``, ``HPARAMS_VERIFY_ECAPA``): the cosine of the
  length-normalised embeddings of each trial's two files, ``scores.txt``,
  EER and minDCF;
- ``speaker_verification_plda.py`` with
  ``verification_plda_xvector.yaml`` (``verify_plda``,
  ``HPARAMS_VERIFY_PLDA``): a PLDA (``processing/PLDA_LDA``) trained on
  the embeddings of up to ``plda_train_utts`` training files, then
  ``fast_PLDA_scoring`` of the trials, EER and minDCF.

The yamls' values are the ``HPARAMS_*`` dicts (the yaml files are not
read); ``overrides`` replace any of them, e.g. toy widths for the CPU::

    from speechbrain_tpu_torch.recipes import voxceleb_speaker as vox
    vox.write_synthetic_voxceleb("/tmp/vox")
    vox.run("/tmp/vox", "/tmp/out", run_opts={"device": "cpu"},
            overrides={"channels": (16,) * 4 + (48,), "lin_neurons": 8,
                       "attention_channels": 8, "res2net_scale": 4,
                       "se_channels": 8, "out_neurons": 8,
                       "number_of_epochs": 2, "batch_size": 8})
    vox.verify_cosine("/tmp/vox", "/tmp/verify", run_opts={"device": "cpu"},
                      overrides={...the same widths...,
                                 "pretrain_path": "/tmp/out/pretrained"})

Differences from the JAX recipes, each on purpose:

- the crop of a clip longer than ``sentence_len`` is drawn from a
  generator keyed by (seed, epoch, utterance id) (``RandomCrop``), not
  from one generator shared by the pipeline, so a resumed epoch crops as
  the uninterrupted one and the crops do not depend on the loader's
  threads;
- the trial paths are joined to ``voxceleb_prepare.wav_root`` (the
  corpus's ``wav/`` folder), where the JAX scripts join them to the
  corpus folder;
- the cyclic schedule is registered with the checkpointer
  (``"lr_annealing"``), so a resumed run continues it; the JAX recipe
  restarts it;
- ``TimeDomainSpecAugment``'s speed change gives lengths that follow the
  resampled content (``processing/speech_augmentation.py``);
- the JAX training script never writes ``embedding_model.ckpt``, which
  the verification yamls read from ``pretrain_path``; ``run`` writes it.

Copied from the JAX recipe, though it is a fault: ``train_x_vectors.yaml``
puts the x-vector ``Classifier`` (``cosine`` False: log-softmax outputs)
under ``AdditiveAngularMargin``, which expects cosines.  Neither model
runs a TPU kernel.
"""

import json
import os
import time
import wave
import zlib

import numpy as np
import torch

from ..asr import _random_init
from ..core import Brain, Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..dataio.encoder import CategoricalEncoder
from ..device import resolve_device
from ..lobes.augment import TimeDomainSpecAugment
from ..lobes.features import Fbank
from ..lobes.models import ECAPA_TDNN as ecapa
from ..lobes.models import Xvector as xvector
from ..nnet.losses import AdditiveAngularMargin, LogSoftmaxWrapper
from ..nnet.schedulers import CyclicLRScheduler
from ..pretrained.training import save_for_pretrained
from ..processing.PLDA_LDA import PLDA, Ndx, StatObject_SB, fast_PLDA_scoring
from ..processing.features import InputNormalization
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import EER, minDCF
from ..utils.train_logger import FileTrainLogger
from .common import recipe_hparams
from .voxceleb_prepare import prepare_trials, prepare_voxceleb, wav_root

__all__ = ["HPARAMS_ECAPA", "HPARAMS_XVECTOR", "HPARAMS_VERIFY_ECAPA",
           "HPARAMS_VERIFY_PLDA", "RandomCrop", "dataio_prep",
           "build_embedding_model", "SpeakerBrain", "build", "run",
           "compute_embeddings", "verify_cosine", "verify_plda",
           "write_synthetic_voxceleb"]

SAMPLERATE = 16000

_ECAPA_WIDTHS = dict(
    model="ECAPA_TDNN",
    channels=(1024, 1024, 1024, 1024, 3072),
    kernel_sizes=(5, 3, 3, 3, 1),
    dilations=(1, 2, 3, 4, 1),
    attention_channels=128,
    res2net_scale=8,  # the JAX module's defaults, which the yaml keeps
    se_channels=128,
    lin_neurons=192,
)
_XVECTOR_WIDTHS = dict(
    model="Xvector",
    tdnn_channels=(512, 512, 512, 512, 1500),
    lin_neurons=512,
)
_TRAINING = dict(
    seed=1986,
    sample_rate=16000,
    n_mels=80,
    sentence_len=3.0,  # seconds cropped per utterance
    batch_size=32,
    number_of_epochs=10,
    lr=0.001,
    lr_final=0.0001,
    out_neurons=7205,  # VoxCeleb 1+2 speakers
    # TimeDomainSpecAugment's arguments (None: no augmentation)
    augmentation={"sample_rate": 16000, "speeds": [95, 100, 105]},
    margin=0.2,
    scale=30,
    step_size=65000,
    # the JAX Brain's defaults
    max_grad_norm=5.0,
    precision="fp32",
)
# recipes/VoxCeleb/SpeakerRec/hparams/train_ecapa_tdnn.yaml
HPARAMS_ECAPA = dict(_TRAINING, **_ECAPA_WIDTHS)
# recipes/VoxCeleb/SpeakerRec/hparams/train_x_vectors.yaml
HPARAMS_XVECTOR = dict(_TRAINING, **_XVECTOR_WIDTHS)
_VERIFICATION = dict(seed=1234, sample_rate=16000, n_mels=80,
                     pretrain_path=None)
# hparams/verification_ecapa.yaml
HPARAMS_VERIFY_ECAPA = dict(_VERIFICATION, **_ECAPA_WIDTHS)
# hparams/verification_plda_xvector.yaml
HPARAMS_VERIFY_PLDA = dict(_VERIFICATION, **_XVECTOR_WIDTHS, rank_f=100,
                           plda_train_utts=5000)


class RandomCrop:
    """A clip longer than ``samples`` cut to ``samples`` from a start drawn
    uniformly in ``[0, len - samples)``, as the JAX pipeline draws it, but
    from ``np.random.default_rng((seed, epoch, crc32(utt_id)))``: the
    crop of an utterance depends on the epoch (``set_epoch``) and its id
    alone, not on how many clips were drawn before it.  Shorter clips
    pass unchanged.

    Example
    -------
    >>> crop = RandomCrop(samples=4, seed=0)
    >>> sig = np.arange(10.0)
    >>> a = crop(sig, "spk--a"); crop.set_epoch(1); b = crop(sig, "spk--a")
    >>> len(a), bool((crop(sig, "spk--a") == b).all()), len(crop(sig[:3], "x"))
    (4, True, 3)
    """

    def __init__(self, samples, seed):
        self.samples = int(samples)
        self.seed = int(seed)
        self.epoch = 0

    def set_epoch(self, epoch):
        """The epoch whose crops the next calls draw."""
        self.epoch = int(epoch)

    def __call__(self, sig, utt_id):
        if len(sig) <= self.samples:
            return sig
        key = (self.seed, self.epoch, zlib.crc32(utt_id.encode()))
        start = int(np.random.default_rng(key).integers(
            0, len(sig) - self.samples))
        return sig[start:start + self.samples]


def dataio_prep(hparams):
    """The recipe's datasets (``train_speaker_embeddings.py:49-83``):
    ``sig`` read from the manifests' files and cropped by a
    ``RandomCrop`` of ``sentence_len`` seconds, and ``spk_id_encoded``
    from a ``CategoricalEncoder`` filled from the training set.  Returns
    ``(datasets, label_encoder, crop)``."""
    label_encoder = CategoricalEncoder()
    crop = RandomCrop(hparams["sentence_len"] * hparams["sample_rate"],
                      hparams["seed"])
    datasets = {}
    for split in ("train", "valid"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(lambda wav, utt_id: crop(read_audio(wav), utt_id),
                            takes=["wav", "id"], provides="sig")
        ds.add_dynamic_item(label_encoder.encode_label, takes="spk_id",
                            provides="spk_id_encoded")
        ds.set_output_keys(["id", "sig", "spk_id_encoded"])
        datasets[split] = ds
    label_encoder.update_from_didataset(datasets["train"], "spk_id")
    return datasets, label_encoder, crop


def build_embedding_model(hparams):
    """``hparams["model"]``'s embedding model over ``n_mels`` features:
    ``ECAPA_TDNN`` or ``Xvector``."""
    hp = hparams
    if hp["model"] == "ECAPA_TDNN":
        return ecapa.ECAPA_TDNN(
            hp["n_mels"], lin_neurons=hp["lin_neurons"],
            channels=tuple(hp["channels"]),
            kernel_sizes=tuple(hp["kernel_sizes"]),
            dilations=tuple(hp["dilations"]),
            attention_channels=hp["attention_channels"],
            res2net_scale=hp["res2net_scale"], se_channels=hp["se_channels"])
    if hp["model"] == "Xvector":
        return xvector.Xvector(hp["n_mels"],
                               tdnn_channels=tuple(hp["tdnn_channels"]),
                               lin_neurons=hp["lin_neurons"])
    raise ValueError(f"Unknown model {hp['model']}")


def build_modules(hparams, seed=0):
    """The recipe's modules, with Lecun-normal weights from ``seed``:
    ``compute_features`` (``Fbank``), ``embedding_model`` and
    ``classifier`` (the ECAPA cosine head, or the x-vector's log-softmax
    ``Classifier``, as the yamls have them)."""
    hp = hparams
    lin = hp["lin_neurons"]
    if hp["model"] == "ECAPA_TDNN":
        classifier = ecapa.Classifier(lin, hp["out_neurons"], lin_neurons=lin)
    else:
        classifier = xvector.Classifier(lin, hp["out_neurons"],
                                        lin_neurons=lin)
    modules = {"compute_features": Fbank(sample_rate=hp["sample_rate"],
                                         n_mels=hp["n_mels"]),
               "embedding_model": build_embedding_model(hp),
               "classifier": classifier}
    gen = torch.Generator().manual_seed(seed)
    for name in ("embedding_model", "classifier"):
        _random_init(modules[name], gen)
    return modules


class SpeakerBrain(Brain):
    """The VoxCeleb recipe's ``SpeakerBrain``
    (``train_speaker_embeddings.py:18-46``), for either yaml
    (``hparams["model"]``; missing keys from ``HPARAMS_ECAPA``).

    ``compute_forward``: in training, ``TimeDomainSpecAugment``
    (``hparams["augmentation"]``'s arguments; None: off) of the waveforms
    and their lengths, with draws from ``self.generator`` -> ``Fbank`` ->
    cast to the activation dtype -> ``InputNormalization(norm_type=
    "sentence", std_norm=False)`` with the (augmented) lengths -> the
    embedding model with the lengths -> the classifier, (B, 1,
    out_neurons).  ``compute_objectives``: ``self.aam_loss``,
    ``LogSoftmaxWrapper(AdditiveAngularMargin(margin, scale))``, at
    ``spk_id_encoded``: the mean over the batch, every row counted (as
    in JAX).

    The optimizer is ``torch.optim.Adam`` (0.9, 0.999, eps 1e-8), optax's
    ``adam``, behind the Brain's clip to ``max_grad_norm``, at
    ``self.lr``: ``lr`` for the first step (the JAX Brain's start), then
    what ``self.lr_annealing`` (``CyclicLRScheduler(lr_final, lr,
    step_size)``) returns, called after every optimizer step.  With a
    ``checkpointer`` the schedule is registered as ``"lr_annealing"``;
    ``on_stage_end`` at VALID saves a checkpoint with ``meta={"loss":
    loss}``, keeps the best by loss and writes the line of
    ``hparams["train_logger"]``.  ``hparams["crop"]`` (a ``RandomCrop``,
    optional) is told each stage's epoch.  The stages' losses are in
    ``self.stage_stats``.  A batch is a dict of ``sig`` (B, samples),
    ``sig_lens`` (B,) relative and ``spk_id_encoded`` (B,).

    Example
    -------
    >>> hp = {"channels": (8,) * 4 + (24,), "lin_neurons": 4,
    ...       "attention_channels": 4, "res2net_scale": 4, "se_channels": 4,
    ...       "n_mels": 8, "out_neurons": 5}
    >>> brain = SpeakerBrain(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(3, 8000)).astype(np.float32),
    ...     "sig_lens": np.array([1.0, 0.8, 0.9], np.float32),
    ...     "spk_id_encoded": np.array([0, 3, 4])}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch)))), brain.lr
    (True, 0.00010001384615384608)
    """

    def __init__(self, hparams=None, run_opts=None, checkpointer=None):
        hp = dict(HPARAMS_ECAPA, **(hparams or {}))
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
        self.normalize = InputNormalization(norm_type="sentence",
                                            std_norm=False)
        self.aam_loss = LogSoftmaxWrapper(
            AdditiveAngularMargin(margin=hp["margin"], scale=hp["scale"]))
        self.lr_annealing = CyclicLRScheduler(
            base_lr=hp["lr_final"], max_lr=hp["lr"], step_size=hp["step_size"])
        if (checkpointer is not None
                and "lr_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("lr_annealing", self.lr_annealing)
        self.stage_stats = {}

    def compute_forward(self, batch, stage):
        """Returns the (B, 1, out_neurons) classifier outputs."""
        wavs, lens = batch["sig"], batch["sig_lens"]
        if stage == Stage.TRAIN and self.augment is not None:
            wavs, lens = self.augment(wavs, lens, self.generator)
        m = self.modules
        feats = self.normalize(m.compute_features(wavs).to(self.dtype), lens)
        return m.classifier(m.embedding_model(feats, lengths=lens))

    def compute_objectives(self, predictions, batch, stage):
        """The AAM-softmax loss."""
        return self.aam_loss(predictions, batch["spk_id_encoded"])

    def on_stage_start(self, stage, epoch=None):
        """The crop draws the epoch's crops."""
        crop = getattr(self.hparams, "crop", None)
        if crop is not None and epoch is not None:
            crop.set_epoch(epoch)

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """One step of the cyclic schedule per optimizer step."""
        if should_step:
            _, self.lr = self.lr_annealing()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """At VALID: the keep-best checkpoint and the log line."""
        if stage == Stage.TRAIN:
            return
        self.stage_stats[stage.name] = {"loss": stage_loss}
        if stage == Stage.VALID and self.checkpointer is not None:
            self.checkpointer.save_and_keep_only(meta={"loss": stage_loss},
                                                 min_keys=["loss"])
            train_logger = getattr(self.hparams, "train_logger", None)
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats={"loss": stage_loss})


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_ECAPA):
    """Everything ``run`` trains with, built as the training script's
    ``__main__`` builds it (``train_speaker_embeddings.py:86-124``):
    ``hparams`` (``HPARAMS_ECAPA`` or ``HPARAMS_XVECTOR``) with the
    folders and ``overrides``; the manifests and ``trials.json`` from
    ``verification_file`` (default ``<data_folder>/veri_test2.txt``),
    the datasets and the label encoder, the loaders (train shuffled,
    batches of ``batch_size``), an
    ``EpochCounter`` and a ``SpeakerBrain`` with a ``Checkpointer`` on
    ``<output_folder>/save``, a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt`` and the crop.  Returns a dict of
    them (``brain``, ``epoch_counter``, ``train_loader``,
    ``valid_loader``, ``label_encoder``, ``hparams``)."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                        [("train_json", "train"), ("valid_json", "valid")])
    hp.setdefault("verification_file",
                  os.path.join(data_folder, "veri_test2.txt"))
    run_on_main(prepare_voxceleb, kwargs={
        "data_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "seed": hp["seed"],
        "verification_pairs_file": hp["verification_file"]})
    datasets, label_encoder, crop = dataio_prep(hp)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = SpeakerBrain(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
             epoch_counter=epoch_counter, crop=crop),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]))
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "label_encoder": label_encoder, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_ECAPA):
    """The training script end to end: ``build``, ``fit`` (resuming from
    the latest checkpoint), then the checkpoint with the least validation
    loss recovered and its ``embedding_model`` and ``classifier`` written
    by ``save_for_pretrained`` into ``<output_folder>/pretrained``, the
    ``pretrain_path`` of the verification functions.  Returns the
    Brain."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.checkpointer.recover_if_possible(min_key="loss")
    save_for_pretrained(brain, os.path.join(output_folder, "pretrained"),
                        module_names=["embedding_model", "classifier"],
                        hparams=parts["hparams"])
    return brain


# ------------------------------------------------------------ verification


def _verification_setup(defaults, data_folder, output_folder, overrides,
                        run_opts):
    """The verification scripts' common start: hparams, the trials (paths
    under ``wav_root``), the embedding model in eval mode on the device
    (random weights from seed 0, then ``<pretrain_path>/
    embedding_model.ckpt`` where it exists), its ``Fbank`` and the
    sentence normalization."""
    hp = recipe_hparams(defaults, data_folder, output_folder, overrides)
    hp.setdefault("verification_file",
                  os.path.join(data_folder, "veri_test2.txt"))
    device = resolve_device((run_opts or {}).get("device"))
    trials_json = os.path.join(hp["save_folder"], "trials.json")
    prepare_trials(hp["verification_file"], wav_root(data_folder),
                   trials_json)
    with open(trials_json) as f:
        trials = json.load(f)
    model = build_embedding_model(hp)
    _random_init(model, torch.Generator().manual_seed(0))
    path = os.path.join(hp["pretrain_path"] or "", "embedding_model.ckpt")
    if hp["pretrain_path"] and os.path.exists(path):
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
    modules = {"embedding_model": model.to(device).eval(),
               "compute_features": Fbank(sample_rate=hp["sample_rate"],
                                         n_mels=hp["n_mels"]).to(device),
               "normalize": InputNormalization(norm_type="sentence",
                                               std_norm=False)}
    return hp, trials, modules, device


@torch.no_grad()
def compute_embeddings(modules, paths, device):
    """Each file's embedding, one file a forward as the JAX scripts run
    them: ``Fbank`` -> sentence normalization over every frame -> the
    embedding model in eval mode without lengths -> divided by its L2
    norm (floored at 1e-8).  Returns ``{path: (lin_neurons,) tensor on
    device}``."""
    out = {}
    for path in paths:
        if path in out:
            continue
        wav = torch.from_numpy(np.ascontiguousarray(read_audio(path)))
        feats = modules["compute_features"](wav[None].to(device))
        feats = modules["normalize"](feats, torch.ones(1, device=device))
        emb = modules["embedding_model"](feats).reshape(-1)
        out[path] = emb / torch.linalg.vector_norm(emb).clamp(min=1e-8)
    return out


def _metrics_line(hp, positive, negative):
    eer, _ = EER(np.asarray(positive), np.asarray(negative))
    dcf, _ = minDCF(np.asarray(positive), np.asarray(negative))
    line = f"EER: {eer * 100:.3f}%  minDCF: {dcf:.4f}"
    with open(os.path.join(hp["output_folder"], "train_log.txt"), "a") as f:
        f.write(line + "\n")
    return eer, dcf, line


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def verify_cosine(data_folder, output_folder, overrides=None, run_opts=None):
    """``speaker_verification_cosine.py``: the embeddings of every file of
    the trials (sorted), then each trial's score, the dot product of its
    two unit embeddings, written to ``<output_folder>/scores.txt`` as
    ``<enrol> <test> <score>``; EER and minDCF over the positive
    (label 1) and negative scores, and the line ``EER: x%  minDCF: y``
    appended to ``<output_folder>/train_log.txt``.  Returns a dict:
    ``scores`` (a list, in trial order), ``labels``, ``eer``,
    ``min_dcf``, ``line``, ``embed_s`` and ``score_s`` (seconds)."""
    hp, trials, modules, device = _verification_setup(
        HPARAMS_VERIFY_ECAPA, data_folder, output_folder, overrides, run_opts)
    paths = sorted({t["enrol"] for t in trials} | {t["test"] for t in trials})
    t0 = time.perf_counter()
    cache = compute_embeddings(modules, paths, device)
    _sync(device)
    t1 = time.perf_counter()
    row = {p: i for i, p in enumerate(paths)}
    emb = torch.stack([cache[p] for p in paths])
    enrol = torch.as_tensor([row[t["enrol"]] for t in trials], device=device)
    test = torch.as_tensor([row[t["test"]] for t in trials], device=device)
    scores = (emb[enrol] * emb[test]).sum(-1).tolist()
    labels = [t["label"] for t in trials]
    with open(os.path.join(hp["output_folder"], "scores.txt"), "w") as f:
        for t, score in zip(trials, scores):
            f.write(f"{t['enrol']} {t['test']} {score}\n")
    eer, dcf, line = _metrics_line(
        hp, [s for s, lab in zip(scores, labels) if lab == 1],
        [s for s, lab in zip(scores, labels) if lab != 1])
    return {"scores": scores, "labels": labels, "eer": eer, "min_dcf": dcf,
            "line": line, "embed_s": t1 - t0,
            "score_s": time.perf_counter() - t1}


def _stat_object(ids, spk_ids, embeddings):
    n = len(ids)
    return StatObject_SB(modelset=spk_ids, segset=ids,
                         start=np.array([None] * n), stop=np.array([None] * n),
                         stat0=torch.ones(n, 1), stat1=torch.stack(
                             embeddings).to(torch.float64))


def verify_plda(data_folder, output_folder, overrides=None, run_opts=None):
    """``speaker_verification_plda.py``: the manifests
    (``prepare_voxceleb`` with ``seed``), the embeddings of the first
    ``plda_train_utts`` training utterances by id, a ``PLDA(rank_f)``
    fitted on them by speaker (float64 on the device), then
    ``fast_PLDA_scoring`` of the trials' enrol and test embeddings; EER
    and minDCF as ``verify_cosine``.  Returns a dict: ``scores``,
    ``labels``, ``eer``, ``min_dcf``, ``line``, ``embed_s`` (both sets of
    embeddings), ``plda_s`` (the fit) and ``score_s``."""
    hp, trials, modules, device = _verification_setup(
        HPARAMS_VERIFY_PLDA, data_folder, output_folder, overrides, run_opts)
    run_on_main(prepare_voxceleb, kwargs={
        "data_folder": data_folder, "save_folder": hp["save_folder"],
        "seed": hp["seed"]})
    with open(os.path.join(hp["save_folder"], "train.json")) as f:
        items = sorted(json.load(f).items())[:hp["plda_train_utts"]]
    t0 = time.perf_counter()
    cache = compute_embeddings(modules, [v["wav"] for _, v in items], device)
    train_stat = _stat_object([k for k, _ in items],
                              [v["spk_id"] for _, v in items],
                              [cache[v["wav"]] for _, v in items])
    paths = sorted({t["enrol"] for t in trials} | {t["test"] for t in trials})
    cache = compute_embeddings(modules, paths, device)
    _sync(device)
    t1 = time.perf_counter()
    plda = PLDA(rank_f=hp["rank_f"]).plda(train_stat)
    _sync(device)
    t2 = time.perf_counter()
    enrol_ids = sorted({t["enrol"] for t in trials})
    test_ids = sorted({t["test"] for t in trials})
    ndx = Ndx(models=[t["enrol"] for t in trials],
              testsegs=[t["test"] for t in trials])
    result = fast_PLDA_scoring(
        _stat_object(enrol_ids, enrol_ids, [cache[p] for p in enrol_ids]),
        _stat_object(test_ids, test_ids, [cache[p] for p in test_ids]),
        ndx, plda.mean, plda.F, plda.Sigma)
    model_idx = {m: i for i, m in enumerate(result.modelset)}
    seg_idx = {s: i for i, s in enumerate(result.segset)}
    mat = result.scoremat.cpu().numpy()
    scores = [float(mat[model_idx[t["enrol"]], seg_idx[t["test"]]])
              for t in trials]
    labels = [t["label"] for t in trials]
    eer, dcf, line = _metrics_line(
        hp, [s for s, lab in zip(scores, labels) if lab == 1],
        [s for s, lab in zip(scores, labels) if lab != 1])
    return {"scores": scores, "labels": labels, "eer": eer, "min_dcf": dcf,
            "line": line, "embed_s": t1 - t0, "plda_s": t2 - t1,
            "score_s": time.perf_counter() - t2, "plda": plda}


# ------------------------------------------------------------ synthetic data


def write_synthetic_voxceleb(folder, speakers=8, clips=8, seconds=(2.0, 5.0),
                             videos=2, trials_per_speaker=4, seed=0):
    """Write a VoxCeleb-shaped tree of synthetic clips, for trying the
    recipes without the corpus: ``<folder>/wav/id1{s:04d}/<video>/
    {n:05d}.wav`` for ``speakers`` speakers of ``clips`` 16 kHz 16-bit
    WAVs each, lasting ``seconds`` (uniform), dealt in turn to
    ``videos`` folders named like YouTube video ids; each clip is noise and a
    speaker-dependent pair of tones.  ``<folder>/veri_test2.txt`` holds
    ``trials_per_speaker`` positive trials (``1 <enrol> <test>``, two
    clips of the speaker, paths relative to ``wav/``) and as many
    negative ones (``0``, a clip of another speaker) for each speaker.
    Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    rels = {}
    for s in range(speakers):
        spk = f"id1{s:04d}"
        video_ids = [
            "".join(rng.choice(list("abcdefghijkLMNOPQRstuvwXYZ_-"), 11))
            for _ in range(videos)]
        f0 = 110.0 + 23.0 * s
        for n in range(clips):
            rel = f"{spk}/{video_ids[n % videos]}/{n + 1:05d}.wav"
            path = os.path.join(folder, "wav", rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            samples = int(rng.uniform(*seconds) * SAMPLERATE)
            t = np.arange(samples) / SAMPLERATE
            sig = (0.05 * rng.standard_normal(samples)
                   + 0.2 * np.sin(2 * np.pi * f0 * t)
                   + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t + rng.uniform(0, 6)))
            pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLERATE)
                w.writeframes(pcm.tobytes())
            rels.setdefault(spk, []).append(rel)
    lines = []
    names = sorted(rels)
    for i, spk in enumerate(names):
        for k in range(trials_per_speaker):
            a, b = rng.choice(len(rels[spk]), 2, replace=False)
            lines.append(f"1 {rels[spk][a]} {rels[spk][b]}")
            other = names[(i + 1 + int(rng.integers(len(names) - 1)))
                          % len(names)]
            lines.append(f"0 {rels[spk][a]} "
                         f"{rels[other][int(rng.integers(len(rels[other])))]}")
    with open(os.path.join(folder, "veri_test2.txt"), "w") as f:
        f.write("".join(line + "\n" for line in lines))
