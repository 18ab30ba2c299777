"""The TIMIT CRDNN + CTC phoneme recipe end to end, on the port.

Does what ``recipes/TIMIT/ASR/CTC/train.py`` does with
``hparams/train.yaml``: a TIMIT tree -> JSON manifests (``prepare_timit``,
a copy of ``recipes/TIMIT/timit_prepare.py``: the standard dev and core
test speakers, the SA sentences skipped, NIST SPHERE audio read at load
time) -> a ``CTCTextEncoder`` of the train set's phones with the blank at
index 0 (``dataio_prep``) -> ``CTCBrain.fit`` (Fbank with deltas ->
global ``InputNormalization`` -> ``CRDNN`` with a bidirectional LiGRU ->
``Linear`` -> ``log_softmax`` -> CTC on the kernels K3/K4; Adadelta at
the NewBob-annealed rate; the validation's phone error rate from the
greedy decode; checkpoints keep the best by PER) ->
``evaluate(min_key="PER")`` on the test set.  A killed run resumes from
its latest checkpoint when ``run`` is called again on the same output
folder.

The yaml's values are ``HPARAMS`` (the yaml file itself is not read);
``overrides`` replace any of them, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import timit_ctc
    brain = timit_ctc.run("/data/TIMIT", "results/timit_ctc",
                          run_opts={"device": "cpu"},
                          overrides={"cnn_channels": (4, 4), ...})

Two differences from the JAX recipe:

- The 39-phone folding.  The JAX ``_folding_map(39)`` looks each phone up
  once in ``fold48`` updated with the 39-set entries, so ``ax-h`` folds
  to ``ax`` (not ``ah``) and ``ax`` stays: 40 labels over the 61 phones,
  41 with the blank, one more than ``output_neurons`` (40).  ``FOLD39``
  here is the standard Lee and Hon table: 39 phones, 40 labels with the
  blank.
- The Brain registers the NewBob schedule with its checkpointer
  (``"lr_annealing"``), as the port's other recipes register their
  schedules; the JAX recipe registers none, so a resumed JAX run starts
  the annealing again from the yaml's rate.
"""

import json
import logging
import os

import numpy as np
import torch

from ..asr import _random_init
from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..dataio.encoder import CTCTextEncoder
from ..decoders.ctc import ctc_greedy_decode
from ..lobes.features import Fbank
from ..lobes.models.CRDNN import CRDNN
from ..nnet.linear import Linear
from ..nnet.losses import ctc_loss
from ..processing.features import InputNormalization
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from .common import NewBobBrain, recipe_hparams

logger = logging.getLogger(__name__)

__all__ = ["HPARAMS", "TIMIT_PHONES", "FOLD39", "prepare_timit",
           "dataio_prep", "CTCBrain", "build", "run", "write_synthetic_timit"]

SAMPLERATE = 16000

# recipes/TIMIT/ASR/CTC/hparams/train.yaml (with the JAX recipe's
# phn_set 39 and its Brain's defaults: clip 5, fp32)
HPARAMS = dict(
    seed=1234,
    sample_rate=16000,
    n_mels=40,
    deltas=True,
    batch_size=8,
    number_of_epochs=50,
    lr=1.0,
    blank_index=0,
    output_neurons=40,  # 39 phonemes + blank
    phn_set=39,
    update_until_epoch=3,
    cnn_blocks=2,
    cnn_channels=(128, 256),
    inter_layer_pooling_size=(2, 2),
    rnn_layers=4,
    rnn_neurons=512,
    rnn_bidirectional=True,
    dnn_blocks=2,
    dnn_neurons=512,
    dropout=0.15,
    rho=0.95,
    eps=1e-8,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
    precision="fp32",
)

# Standard 50-speaker development set (Halberstadt & Glass).
DEV_SPK = {
    "faks0", "fdac1", "fjem0", "mgwt0", "mjar0", "mmdb1", "mmdm2",
    "mpdf0", "fcmh0", "fkms0", "mbdg0", "mbwm0", "mcsh0", "fadg0",
    "fdms0", "fedw0", "mgjf0", "mglb0", "mrtk0", "mtaa0", "mtdt0",
    "mthc0", "mwjg0", "fnmr0", "frew0", "fsem0", "mbns0", "mmjr0",
    "mdls0", "mdlf0", "mdvc0", "mers0", "fmah0", "fdrw0", "mrcs0",
    "mrjm4", "fcal1", "mmwh0", "fjsj0", "majc0", "mjsw0", "mreb0",
    "fgjd0", "fjmg0", "mroa0", "mteb0", "mjfc0", "mrjr0", "fmml0",
    "mrws1",
}

# 24-speaker core test set.
TEST_SPK = {
    "mdab0", "mwbt0", "felc0", "mtas1", "mwew0", "fpas0", "mjmp0",
    "mlnt0", "fpkt0", "mlll0", "mtls0", "fjlm0", "mbpm0", "mklt0",
    "fnlp0", "mcmj0", "mjdh0", "fmgd0", "mgrt0", "mnjm0", "fdhc0",
    "mjln0", "mpam0", "fmld0",
}

# the 61 phones of TIMIT's .PHN files
TIMIT_PHONES = (
    "aa", "ae", "ah", "ao", "aw", "ax", "ax-h", "axr", "ay", "b", "bcl",
    "ch", "d", "dcl", "dh", "dx", "eh", "el", "em", "en", "eng", "epi",
    "er", "ey", "f", "g", "gcl", "h#", "hh", "hv", "ih", "ix", "iy", "jh",
    "k", "kcl", "l", "m", "n", "ng", "nx", "ow", "oy", "p", "pau", "pcl",
    "q", "r", "s", "sh", "t", "tcl", "th", "uh", "uw", "ux", "v", "w", "y",
    "z", "zh",
)

# recipes/TIMIT/timit_prepare.py's 48-phone folding, as it is
FOLD48 = {
    "ao": "aa", "ax-h": "ax", "axr": "er", "hv": "hh", "ix": "ih",
    "el": "l", "em": "m", "en": "n", "nx": "n", "eng": "ng",
    "zh": "sh", "ux": "uw", "pcl": "cl", "tcl": "cl", "kcl": "cl",
    "qcl": "cl", "bcl": "vcl", "dcl": "vcl", "gcl": "vcl",
    "h#": "sil", "#h": "sil", "pau": "sil", "q": "",
}

# The standard 39-phone folding (Lee and Hon): each phone is looked up
# once and "" drops it.  Over TIMIT_PHONES it gives 39 labels.
FOLD39 = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n", "eng": "ng",
    "zh": "sh", "ux": "uw",
    "pcl": "sil", "tcl": "sil", "kcl": "sil", "qcl": "sil", "bcl": "sil",
    "dcl": "sil", "gcl": "sil", "cl": "sil", "vcl": "sil", "epi": "sil",
    "h#": "sil", "#h": "sil", "pau": "sil",
    "q": "",
}


def _folding_map(phn_set):
    """None (60: the raw labels), ``FOLD48`` or ``FOLD39``."""
    if phn_set == 60:
        return None
    if phn_set == 48:
        return FOLD48
    if phn_set == 39:
        return FOLD39
    raise ValueError(f"phn_set must be 60/48/39, got {phn_set}")


def _find_dir(base, name):
    for cand in (name, name.upper(), name.lower()):
        p = os.path.join(base, cand)
        if os.path.isdir(p):
            return p
    raise FileNotFoundError(f"Missing {name} under {base}")


def _read_phn(path):
    """(phones, end frames) of a .PHN file; the ends are 10 ms frame
    indices (end_sample // 160)."""
    phones, ends = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                phones.append(parts[2])
                ends.append(int(parts[1]) // 160)
    return phones, ends


def _collect(split_dir, keep_spk=None):
    """(utt_id, wav_path, phn_path, spk_id) of each utterance under a
    TRAIN/TEST dir with a .PHN file, the SA sentences skipped."""
    for root, _, files in os.walk(split_dir):
        spk = os.path.basename(root).lower()
        if keep_spk is not None and spk not in keep_spk:
            continue
        for fn in files:
            stem, ext = os.path.splitext(fn)
            if ext.lower() != ".wav" or stem.lower().startswith("sa"):
                continue
            phn = None
            for cand in (stem + ".PHN", stem + ".phn"):
                p = os.path.join(root, cand)
                if os.path.exists(p):
                    phn = p
                    break
            if phn is None:
                continue
            yield f"{spk}_{stem.lower()}", os.path.join(root, fn), phn, spk


def prepare_timit(data_folder, save_json_train, save_json_valid,
                  save_json_test, phn_set=60, skip_prep=False):
    """Write the train/dev/test JSON manifests of a TIMIT tree (``TRAIN``
    and ``TEST``, any case): train from TRAIN, dev and test from TEST by
    ``DEV_SPK`` and ``TEST_SPK``; each entry has ``wav``, ``duration``,
    ``spk_id``, ``phn`` (the phones folded to ``phn_set``: 60 keeps
    them, 48 is the JAX package's table, 39 ``FOLD39``; a phone folded
    to "" is dropped) and ``phn_ends``.  Manifests that all exist are
    kept.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_timit(d, {"train": 2, "dev": 1, "test": 1},
    ...                       seconds=(0.5, 0.6))
    >>> prepare_timit(d, d + "/tr.json", d + "/dev.json", d + "/te.json", 39)
    >>> len(json.load(open(d + "/tr.json")))
    2
    """
    if skip_prep:
        return
    if all(os.path.exists(p)
           for p in (save_json_train, save_json_valid, save_json_test)):
        logger.info("TIMIT manifests exist, skipping preparation")
        return
    train_dir = _find_dir(data_folder, "train")
    test_dir = _find_dir(data_folder, "test")
    fold = _folding_map(phn_set)
    jobs = [
        (save_json_train, _collect(train_dir)),
        (save_json_valid, _collect(test_dir, keep_spk=DEV_SPK)),
        (save_json_test, _collect(test_dir, keep_spk=TEST_SPK)),
    ]
    for save_path, items in jobs:
        manifest = {}
        for utt_id, wav, phn_path, spk in items:
            audio = read_audio(wav)
            phones, ends = _read_phn(phn_path)
            if fold is not None:
                folded = [(fold.get(p, p), e) for p, e in zip(phones, ends)]
                folded = [(p, e) for p, e in folded if p]
                phones = [p for p, _ in folded]
                ends = [e for _, e in folded]
            manifest[utt_id] = {
                "wav": wav,
                "duration": round(len(audio) / 16000.0, 3),
                "spk_id": spk,
                "phn": " ".join(phones),
                "phn_ends": " ".join(str(e) for e in ends),
            }
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info(f"Prepared {save_path} ({len(manifest)} utterances)")


def dataio_prep(hparams, seq2seq=False):
    """The recipe's datasets (``train.py:87-115``): ``sig`` read from the
    manifests' files, ``phn_encoded`` the phones through a
    ``CTCTextEncoder`` that is loaded from ``<save_folder>/
    label_encoder.txt`` or made from the train set with ``<blank>`` at
    index 0 and saved there.  With ``seq2seq`` (the seq2seq recipes'
    ``dataio_prep``, ``seq2seq/train.py:162-206``) the encoder also holds
    ``<bos>`` at ``bos_index`` and ``<eos>`` at ``eos_index`` (the yamls'
    1 and 2: the phones that held them move to the end) and the datasets
    also give ``phn_encoded_bos`` ([bos_index] + phones) and
    ``phn_encoded_eos`` (phones + [eos_index]).  The JAX recipes append
    ``<bos>`` and ``<eos>`` after the phones instead, so their bos 1 and
    eos 2 are phones.  Returns ``(datasets, label_encoder)``."""
    label_encoder = CTCTextEncoder()
    datasets = {}
    keys = ["id", "sig", "phn_encoded"]
    if seq2seq:
        keys += ["phn_encoded_bos", "phn_encoded_eos"]
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(lambda p: p.split(), takes="phn",
                            provides="phn_list")
        ds.add_dynamic_item(
            lambda pl: np.asarray(label_encoder.encode_sequence(pl), np.int64),
            takes="phn_list", provides="phn_encoded")
        if seq2seq:
            ds.add_dynamic_item(
                lambda t: (np.concatenate([[hparams["bos_index"]], t])
                           .astype(np.int64),
                           np.concatenate([t, [hparams["eos_index"]]])
                           .astype(np.int64)),
                takes="phn_encoded",
                provides=["phn_encoded_bos", "phn_encoded_eos"])
        ds.set_output_keys(keys)
        datasets[split] = ds
    path = os.path.join(hparams["save_folder"], "label_encoder.txt")
    label_encoder.load_or_create(
        path=path,
        from_didatasets=[datasets["train"]],
        output_key="phn_list",
        sequence_input=True,
        special_labels={"blank_label": "<blank>"},
    )
    if seq2seq and "<bos>" not in label_encoder.lab2ind:
        label_encoder.insert_bos_eos("<bos>", "<eos>", hparams["bos_index"],
                                     hparams["eos_index"])
        label_encoder.save(path)
    return datasets, label_encoder


def build_modules(hparams, seed=0):
    """The recipe's modules, with Lecun-normal weights from ``seed``:
    ``compute_features`` (``Fbank``, deltas on: 3 n_mels features),
    ``normalize`` (global ``InputNormalization``), ``model`` (``CRDNN``)
    and ``output_lin`` (``Linear`` to ``output_neurons``)."""
    hp = dict(HPARAMS, **hparams)
    n_feats = hp["n_mels"] * (3 if hp["deltas"] else 1)
    modules = {
        "compute_features": Fbank(sample_rate=hp["sample_rate"],
                                  n_mels=hp["n_mels"], deltas=hp["deltas"]),
        "normalize": InputNormalization(
            n_feats, update_until_epoch=hp["update_until_epoch"]),
        "model": CRDNN(
            input_size=n_feats, cnn_blocks=hp["cnn_blocks"],
            cnn_channels=hp["cnn_channels"],
            inter_layer_pooling_size=hp["inter_layer_pooling_size"],
            rnn_class="ligru", rnn_layers=hp["rnn_layers"],
            rnn_neurons=hp["rnn_neurons"],
            rnn_bidirectional=hp["rnn_bidirectional"],
            dnn_blocks=hp["dnn_blocks"], dnn_neurons=hp["dnn_neurons"],
            dropout=hp["dropout"]),
    }
    modules["output_lin"] = Linear(modules["model"].output_size,
                                   hp["output_neurons"])
    gen = torch.Generator().manual_seed(seed)
    for name in ("model", "output_lin"):
        _random_init(modules[name], gen)
    return modules


class CTCBrain(NewBobBrain):
    """The TIMIT recipe's ``CTCBrain`` (``train.py:21-84``).

    ``compute_forward``: ``Fbank`` with deltas -> ``InputNormalization``
    (its global statistics updated in training until
    ``update_until_epoch``, the epoch counter's epoch) -> cast to the
    activation dtype -> ``CRDNN`` -> ``output_lin`` -> float32
    ``log_softmax``.  ``compute_objectives``: ``ctc_loss`` (``mean``) with
    the lengths ``sig_lens * batch_mask`` and ``phn_encoded_lens *
    batch_mask``, on K3/K4 on the card; outside training it also
    appends the greedy decode of the real rows, as phones through
    ``label_encoder.decode_ndim``, to ``self.per_metrics``.

    The optimizer is ``torch.optim.Adadelta(rho, eps, weight_decay=0)``,
    optax's ``adadelta`` (``E[g^2]``, then ``sqrt(E[dx^2] + eps) /
    sqrt(E[g^2] + eps) g``, then ``E[dx^2]``, scaled by the rate), after
    the Brain's clip to a global norm of ``max_grad_norm``, at
    ``self.lr``: ``lr`` (1.0), then what ``self.lr_annealing``
    (``NewBobScheduler``: factor 0.8, threshold 0.0025, patient 0) gives
    the validation PER at each epoch's end.  ``on_stage_end`` at VALID
    also writes the logger's line (``hparams["train_logger"]`` when
    given) and, with a checkpointer, saves one with ``meta={"PER": per}``
    and keeps the best by PER.  The last stats of each stage are in
    ``self.stage_stats``.

    With a ``checkpointer`` the Brain registers the NewBob schedule as
    ``"lr_annealing"`` (the JAX recipe does not).  A batch is a dict of
    ``sig`` (B, samples), ``sig_lens`` (B,) relative, ``phn_encoded``
    (B, U) and ``phn_encoded_lens`` (B,) relative.

    Example
    -------
    >>> hp = {"cnn_channels": (2, 2), "rnn_layers": 1, "rnn_neurons": 4,
    ...       "dnn_neurons": 4, "n_mels": 8, "output_neurons": 5}
    >>> brain = CTCBrain(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(2, 4000)).astype(np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "phn_encoded": np.array([[1, 2], [3, 0]]),
    ...     "phn_encoded_lens": np.array([1.0, 0.5], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    metric = "PER"
    best = "min"

    def __init__(self, hparams=None, run_opts=None, checkpointer=None,
                 label_encoder=None):
        hp = dict(HPARAMS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adadelta(params, lr=hp["lr"], rho=hp["rho"],
                                        eps=hp["eps"], weight_decay=0)

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        self.label_encoder = label_encoder
        self.epoch = 0
        self.use_kernels = True

    def set_kernels(self, flag=True):
        """Run the CTC loss on the kernels (True) or on its plain
        recursions (False)."""
        self.use_kernels = bool(flag)
        return self

    def compute_forward(self, batch, stage):
        """Returns the (B, T, output_neurons) float32 log-probs."""
        m = self.modules
        feats = m.compute_features(batch["sig"])
        feats = m.normalize(feats, batch["sig_lens"], epoch=self.epoch)
        out = m.model(feats.to(self.dtype), lengths=batch["sig_lens"])
        return torch.log_softmax(m.output_lin(out).float(), -1)

    def compute_objectives(self, predictions, batch, stage):
        """The CTC loss; outside training, the greedy decode's PER."""
        mask = batch["batch_mask"]
        loss = ctc_loss(
            predictions, batch["phn_encoded"], batch["sig_lens"] * mask,
            batch["phn_encoded_lens"] * mask,
            blank_index=self.hparams.blank_index,
            use_kernels=self.use_kernels)
        if stage != Stage.TRAIN and hasattr(self, "per_metrics"):
            real = int(mask.sum())
            hyps = ctc_greedy_decode(predictions, batch["sig_lens"],
                                     blank_id=self.hparams.blank_index)[:real]
            self.per_metrics.append(
                [str(i) for i in range(real)], hyps,
                batch["phn_encoded"][:real].cpu().numpy().tolist(),
                target_len=batch["phn_encoded_lens"][:real].cpu().numpy(),
                ind2lab=self.label_encoder.decode_ndim)
        return loss

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch; a new ``ErrorRateStats`` outside
        training."""
        if epoch is not None:
            self.epoch = epoch
        if stage != Stage.TRAIN:
            self.per_metrics = ErrorRateStats()

    def summarize_metric(self):
        """The stage's PER (``train.py:70-84``)."""
        return self.per_metrics.summarize("error_rate")


def build(data_folder, output_folder, overrides=None, run_opts=None):
    """Everything ``run`` trains with, built as the recipe's ``__main__``
    builds it (``train.py:118-161``): the manifests (prepared unless
    they exist, folded to ``phn_set``), the datasets and label encoder,
    the loaders (train shuffled, batches of ``batch_size``), an
    ``EpochCounter`` and a ``CTCBrain`` with a ``Checkpointer`` on
    ``<output_folder>/save`` and a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt``.

    ``overrides`` replace values of ``HPARAMS``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for
    the CPU; ``debug``, ``staging_depth``, ...).  Returns a dict with
    ``brain``, ``epoch_counter``, ``train_loader``, ``valid_loader``,
    ``test_loader``, ``label_encoder`` and ``hparams``."""
    hp = recipe_hparams(HPARAMS, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev"),
        ("test_json", "test")))
    run_on_main(prepare_timit, kwargs={
        "data_folder": hp["data_folder"],
        "save_json_train": hp["train_json"],
        "save_json_valid": hp["valid_json"],
        "save_json_test": hp["test_json"],
        "phn_set": hp["phn_set"],
    })
    datasets, label_encoder = dataio_prep(hp)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = CTCBrain(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
             epoch_counter=epoch_counter),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]),
        label_encoder=label_encoder)
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "label_encoder": label_encoder, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None):
    """The recipe's ``__main__`` (``train.py:118-167``): ``build``, then
    ``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` on the test set from the checkpoint with
    the lowest validation PER.  Arguments as for ``build``.  Returns the
    Brain (``brain.stage_stats`` holds the last VALID and TEST loss and
    PER)."""
    parts = build(data_folder, output_folder, overrides, run_opts)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="PER")
    return brain


def _write_sphere(path, pcm):
    """A 16 kHz mono 16-bit little-endian NIST SPHERE file."""
    fields = ["NIST_1A", "   1024", "sample_count -i %d" % len(pcm),
              "sample_rate -i 16000", "channel_count -i 1",
              "sample_n_bytes -i 2", "sample_byte_format -s2 01",
              "sample_coding -s3 pcm", "end_head"]
    header = ("\n".join(fields) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)))
        f.write(pcm.astype("<i2").tobytes())


def write_synthetic_timit(folder, counts, seconds=(1.5, 6.0), max_phones=40,
                          seed=0):
    """Write a TIMIT-shaped tree of synthetic utterances, for trying the
    recipe without the corpus: ``counts`` maps "train", "dev" and "test"
    to their numbers of utterances (train speakers under ``TRAIN/DR1``,
    dev and test speakers, taken from ``DEV_SPK`` and ``TEST_SPK``,
    under ``TEST/DR1``), 4 a speaker, each a SPHERE ``.WAV`` of noise and
    tones lasting ``seconds`` (uniform) with a ``.PHN`` file of at most
    ``max_phones`` phones (10 a second at most) over equal spans: an
    ``h#`` at each end and, between them, the next phones of a stream of
    shuffled passes over the other 60 of ``TIMIT_PHONES``, so that the
    train split holds every phone once it has 60 of them; every speaker
    also gets an ``SA1`` sentence (its phones drawn apart from the
    stream), which the preparation skips.
    Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    speakers = {"train": [f"mtrn{i}" for i in range(1000)],
                "dev": sorted(DEV_SPK), "test": sorted(TEST_SPK)}
    inner = [p for p in TIMIT_PHONES if p != "h#"]
    stream = []

    def next_phones(k):
        while len(stream) < k:
            stream.extend(rng.permutation(inner).tolist())
        out = stream[:k]
        del stream[:k]
        return out

    for split in ("train", "dev", "test"):
        top = "TRAIN" if split == "train" else "TEST"
        n = counts.get(split, 0)
        for i in range(n + (-n) % 4):
            spk = speakers[split][i // 4].upper()
            spk_dir = os.path.join(folder, top, "DR1", spk)
            os.makedirs(spk_dir, exist_ok=True)
            stems = ([f"SX{i % 4 + 1}"] if i < n else []) + (
                ["SA1"] if i % 4 == 0 else [])
            for stem in stems:
                samples = int(rng.uniform(*seconds) * SAMPLERATE)
                t = np.arange(samples) / SAMPLERATE
                f1, f2 = rng.uniform(100, 3000, 2)
                sig = (0.05 * rng.standard_normal(samples)
                       + 0.2 * np.sin(2 * np.pi * f1 * t)
                       + 0.1 * np.sin(2 * np.pi * f2 * t))
                _write_sphere(os.path.join(spk_dir, stem + ".WAV"),
                              np.clip(sig, -1, 1) * 32767)
                k = int(rng.integers(max_phones // 2, max_phones + 1))
                k = max(1, min(k, samples // 1600) - 2)
                inner_phones = (next_phones(k) if stem != "SA1"
                                else rng.choice(inner, k).tolist())
                phones = ["h#"] + inner_phones + ["h#"]
                bounds = np.linspace(0, samples, len(phones) + 1).astype(int)
                with open(os.path.join(spk_dir, stem + ".PHN"), "w") as f:
                    for j, p in enumerate(phones):
                        f.write(f"{bounds[j]} {bounds[j + 1]} {p}\n")
