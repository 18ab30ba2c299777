"""The WSJ0-2mix separation recipe end to end, on the port.

Does what ``recipes/WSJ0Mix/separation/train.py`` does with its seven
hparams files: ``sepformer.yaml`` (``HPARAMS_SEPFORMER``),
``sepformer-conformerintra.yaml`` (``HPARAMS_SEPFORMER_CONFORMERINTRA``),
``sepformer-customdataset.yaml`` (``HPARAMS_SEPFORMER_CUSTOMDATASET``),
``convtasnet.yaml`` (``HPARAMS_CONVTASNET``), ``dprnn.yaml``
(``HPARAMS_DPRNN``), ``skim.yaml`` (``HPARAMS_SKIM``) and
``resepformer.yaml`` (``HPARAMS_RESEPFORMER``): a wsj0-mix tree
(``<data_folder>/{tr,cv,tt}/{mix,s1,s2}/<name>.wav``) -> JSON manifests
(``prepare_wsjmix``) -> ``Separation.fit`` (training mixtures cut or
zero-padded to ``training_signal_len`` samples; the model's (B, T, 2)
estimates against the two sources under the permutation-invariant
negative SI-SNR, each example's loss capped at ``loss_upper_lim`` and
the batch's dummy rows weighted 0; Adam at ``lr`` behind a clip to
``max_grad_norm``; ``ReduceLROnPlateau`` once an epoch on the
validation loss; checkpoints keep the best by ``si-snr``) ->
``evaluate`` on the test set with the best checkpoint.  The loss is the
negative SI-SNR in dB, so ``-loss`` is the SI-SNR.

The yamls' values are the ``HPARAMS_*`` dicts (the yaml files are not
read); ``overrides`` replace any of them, e.g. toy widths for the CPU::

    from speechbrain_tpu_torch.recipes import wsj0mix_separation as sep
    sep.write_synthetic_wsj0mix("/tmp/wsj")
    sep.run("/tmp/wsj", "/tmp/out", run_opts={"device": "cpu"},
            overrides={"encoder_out_nchannels": 16, "masknet_chunksize": 10,
                       "masknet_numlayers": 1, "intra_numlayers": 1,
                       "inter_numlayers": 1, "intra_nhead": 4,
                       "inter_nhead": 4, "intra_dffn": 32, "inter_dffn": 32,
                       "training_signal_len": 4000, "number_of_epochs": 2})

Differences from the JAX recipe, each on purpose:

- the crop of a training mixture longer than ``training_signal_len`` is
  drawn from a generator keyed by (seed, epoch, mixture id)
  (``MixtureCrop``), not from one generator shared by the pipeline, so a
  resumed epoch crops as the uninterrupted one and the crops do not
  depend on the loader's threads;
- ``ReduceLROnPlateau`` is registered with the checkpointer
  (``"lr_scheduler"``), and the Brain's rate is in its own checkpoint, so
  a resumed run continues the schedule; the JAX recipe restarts it;
- ``prepare_wsjmix`` writes each file's duration at its own sample rate;
  the JAX recipe divides by 8000 whatever the rate (the same manifests
  at 8 kHz).

The conformer-intra yaml's intra blocks run the depthwise convolution
kernels (K1 forward and input gradient, K2 weight gradient) on CUDA
tensors, at (B x S chunks, K, 256) with 31 taps.  The DPRNN's, SkiM's
and the RE-SepFormer's recurrences are ``torch.nn.LSTM``s (cuDNN on the
card), as JAX runs them as ``lax.scan``s with no kernel of its own.
"""

import json
import os
import wave
import zlib

import numpy as np
import torch

from ..asr import _random_init, _set_kernels
from ..core import Brain, Stage
from ..dataio.dataio import _load_audio_any, read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..lobes.models.conv_tasnet import BinauralConvTasNet, ConvTasNet
from ..lobes.models.dual_path import SepformerWrapper
from ..lobes.models.resepformer import SkiMSeparator
from ..lobes.models.transformer.TransformerSE import (CNNTransformerSE,
                                                      SpectralMaskWrapper)
from ..nnet.activations import PReLU
from ..nnet.losses import PitWrapper, cal_si_snr
from ..nnet.schedulers import ReduceLROnPlateau
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import recipe_hparams

__all__ = ["HPARAMS_SEPFORMER", "HPARAMS_SEPFORMER_CONFORMERINTRA",
           "HPARAMS_SEPFORMER_CUSTOMDATASET", "HPARAMS_CONVTASNET",
           "HPARAMS_DPRNN", "HPARAMS_SKIM", "HPARAMS_RESEPFORMER",
           "prepare_wsjmix", "write_manifest", "MixtureCrop",
           "dataio_prep", "build_model", "Separation", "build", "assemble",
           "fit_and_test", "run", "harmonic_sources", "pcm16", "write_wav",
           "write_synthetic_wsj0mix"]

SPLITS = ("tr", "cv", "tt")

_TRAINING = dict(
    seed=1234,
    sample_rate=8000,
    num_spks=2,
    training_signal_len=32000,  # 4 s crops
    batch_size=1,
    number_of_epochs=200,
    lr=0.00015,
    max_grad_norm=5.0,
    loss_upper_lim=999999,
    limit_training_signal_len=True,
    # ReduceLROnPlateau's arguments
    lr_factor=0.5,
    lr_patience=2,
    dont_halve_until_epoch=85,
    precision="fp32",
)
_SEPFORMER = dict(
    model="SepformerWrapper",
    encoder_kernel_size=16,
    encoder_out_nchannels=256,
    masknet_chunksize=250,
    masknet_numlayers=2,
    intra_numlayers=8,
    inter_numlayers=8,
    intra_nhead=8,
    inter_nhead=8,
    intra_dffn=1024,
    inter_dffn=1024,
    intra_block="transformer",
    conformer_kernel_size=31,
    use_rnn=False,
)
# recipes/WSJ0Mix/separation/hparams/sepformer.yaml
HPARAMS_SEPFORMER = dict(_TRAINING, **_SEPFORMER)
# hparams/sepformer-customdataset.yaml: sepformer.yaml with another output
# folder (``build``'s argument here)
HPARAMS_SEPFORMER_CUSTOMDATASET = dict(HPARAMS_SEPFORMER)
# hparams/sepformer-conformerintra.yaml
HPARAMS_SEPFORMER_CONFORMERINTRA = dict(HPARAMS_SEPFORMER,
                                        intra_block="conformer")
# hparams/dprnn.yaml: the SepformerWrapper with BiLSTM blocks of 128 units
# a direction (its intra/inter counts, heads and widths unused)
HPARAMS_DPRNN = dict(HPARAMS_SEPFORMER, masknet_numlayers=6, use_rnn=True)
# hparams/convtasnet.yaml
HPARAMS_CONVTASNET = dict(
    _TRAINING, model="ConvTasNet", N=256, B=256, H=512, P=3, X=6, R=4, L=16,
    norm_type="gLN", causal=False, mask_nonlinear="relu")
# hparams/skim.yaml (``unit`` is its ``rnn_latent_size``)
HPARAMS_SKIM = dict(
    _TRAINING, model="SkiMSeparator", encoder_kernel_size=16,
    encoder_out_nchannels=128, segment_size=150, num_blocks=4, unit=256,
    causal=False, mem_type="hc")
# hparams/resepformer.yaml (``unit`` is its ``rnn_unit``, which the "av"
# pipeline never reads)
HPARAMS_RESEPFORMER = dict(HPARAMS_SKIM, model="ResepformerWrapper",
                           num_blocks=2, mem_type="av")


def prepare_wsjmix(data_folder, save_folder, num_spks=2, name="wsj"):
    """``<save_folder>/<name>_{tr,cv,tt}.json`` from a wsj0-mix tree: one
    entry per ``<split>/mix/*.wav`` (sorted), keyed by its name without
    ``.wav``: ``mix_wav``, ``duration`` (seconds at the file's own rate,
    to 3 decimals) and ``s{i}_wav`` for each source.  A manifest that
    exists is kept."""
    os.makedirs(save_folder, exist_ok=True)
    for split in SPLITS:
        write_manifest(os.path.join(save_folder, f"{name}_{split}.json"),
                       os.path.join(data_folder, split, "mix"),
                       {f"s{i}_wav": os.path.join(data_folder, split, f"s{i}")
                        for i in range(1, num_spks + 1)})


def write_manifest(out, mix_dir, others):
    """Write the JSON manifest ``out`` of the WAVs in ``mix_dir`` (sorted),
    unless it exists: each keyed by its name without ``.wav``, with
    ``mix_wav``, ``duration`` (seconds at the file's own rate, to 3
    decimals) and, for each ``key: folder`` of ``others``, the file of the
    same name there."""
    if os.path.exists(out):
        return
    if not os.path.isdir(mix_dir):
        raise FileNotFoundError(f"Missing {mix_dir}")
    manifest = {}
    for fn in sorted(os.listdir(mix_dir)):
        if not fn.endswith(".wav"):
            continue
        audio, rate = _load_audio_any(os.path.join(mix_dir, fn))
        entry = {"mix_wav": os.path.join(mix_dir, fn),
                 "duration": round(len(audio) / rate, 3)}
        entry.update({k: os.path.join(d, fn) for k, d in others.items()})
        manifest[os.path.splitext(fn)[0]] = entry
    with open(out, "w") as f:
        json.dump(manifest, f, indent=2)


class MixtureCrop:
    """Cuts a mixture and its sources to the same ``samples`` samples:
    longer ones from a start drawn uniformly in ``[0, len - samples)``
    (as the JAX pipeline draws it) from ``np.random.default_rng((seed,
    epoch, crc32(mixture id)))``, so a mixture's crop depends on the
    epoch (``set_epoch``) and its id alone; shorter ones zero-padded at
    the end.  Signals are (time,) or (time, channels).

    Example
    -------
    >>> crop = MixtureCrop(samples=4, seed=0)
    >>> a, b = crop([np.arange(10.0), np.arange(10.0)], "m1")
    >>> len(a), bool((a == b).all()), len(crop([np.ones(3)], "m2")[0])
    (4, True, 4)
    """

    def __init__(self, samples, seed):
        self.samples = int(samples)
        self.seed = int(seed)
        self.epoch = 0

    def set_epoch(self, epoch):
        """The epoch whose crops the next calls draw."""
        self.epoch = int(epoch)

    def __call__(self, signals, mix_id):
        n = len(signals[0])
        if n <= self.samples:
            pad = [(0, self.samples - n)]
            return [np.pad(s, pad + [(0, 0)] * (s.ndim - 1)) for s in signals]
        key = (self.seed, self.epoch, zlib.crc32(mix_id.encode()))
        start = int(np.random.default_rng(key).integers(0, n - self.samples))
        return [s[start:start + self.samples] for s in signals]


def dataio_prep(hparams, read=read_audio, eval_crop=False):
    """The datasets of ``train.py:99``: ``mix_sig`` and ``s1_sig`` ...
    ``s{num_spks}_sig`` read by ``read`` from the manifests' files and cut
    to their common length; the training ones cropped by a
    ``MixtureCrop`` of ``training_signal_len`` samples when
    ``limit_training_signal_len``, and with ``eval_crop`` the validation
    and test ones by another, whose epoch stays 0 (the same crops every
    epoch).  Returns ``(datasets, crop)``, ``crop`` the training one."""
    crop = MixtureCrop(hparams["training_signal_len"], hparams["seed"])
    fixed = (MixtureCrop(hparams["training_signal_len"], hparams["seed"])
             if eval_crop else None)
    spks = range(1, hparams.get("num_spks", 2) + 1)
    keys, sigs = [f"s{i}_wav" for i in spks], [f"s{i}_sig" for i in spks]
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_data"])
        cut = (crop if hparams["limit_training_signal_len"] else None
               ) if split == "train" else fixed

        def audio_pipeline(mix_wav, *rest, cut=cut):
            *paths, mix_id = rest
            signals = [read(p) for p in (mix_wav, *paths)]
            n = min(len(x) for x in signals)
            signals = [x[:n] for x in signals]
            if cut is not None:
                signals = cut(signals, mix_id)
            return tuple(signals)

        ds.add_dynamic_item(audio_pipeline, takes=["mix_wav"] + keys + ["id"],
                            provides=["mix_sig"] + sigs)
        ds.set_output_keys(["id", "mix_sig"] + sigs)
        datasets[split] = ds
    return datasets, crop


def _random_biases(model, gen):
    """Every bias of a layer with weights (and the conformer convolutions'
    ``depthwise_bias``) drawn uniformly in +-1/sqrt(fan_in), and each
    recurrence's input bias ``bias_ih_l0[_reverse]`` in +-1/sqrt(H),
    PyTorch's defaults; the norms' biases stay zero, and so do the LSTMs'
    ``bias_hh`` buffers (JAX has no recurrent bias)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.RNNBase):
                for name, p in m.named_parameters():
                    if name.startswith("bias_ih"):
                        bound = m.hidden_size ** -0.5
                        p.uniform_(-bound, bound, generator=gen)
                continue
            weight = getattr(m, "weight", None)
            if (isinstance(getattr(m, "bias", None), torch.nn.Parameter)
                    and weight is not None and weight.dim() >= 2):
                bound = weight[0].numel() ** -0.5
                m.bias.uniform_(-bound, bound, generator=gen)
            if isinstance(getattr(m, "depthwise_bias", None),
                          torch.nn.Parameter):
                bound = m.depthwise_kernel.shape[0] ** -0.5
                m.depthwise_bias.uniform_(-bound, bound, generator=gen)


def build_model(hparams, seed=0):
    """``hparams["model"]``'s separator (``SepformerWrapper``,
    ``SkiMSeparator``, ``ResepformerWrapper`` (the same class),
    ``ConvTasNet``, ``BinauralConvTasNet`` (``mode``) or
    ``SpectralMaskWrapper`` over a ``CNNTransformerSE`` (``n_fft``,
    ``d_model``, ``nhead``, ``num_layers``, ``d_ffn``, ``causal``,
    ``dropout``, ``output_activation``)), with Lecun-normal weights from
    ``seed``
    (``asr._random_init``: norms' scales one and biases zero), each PReLU's
    slope at its initial value, and the other biases drawn from the same
    generator (``_random_biases``).  Not zero, as Flax starts them: the
    conformer-intra SepFormer pads the latent sequence into chunks, a
    chunk of padding alone stays exactly zero through the intra blocks
    when every bias is zero (no absolute position is added), and each of
    their LayerNorms then multiplies the gradient by 1/sqrt(eps): 1e36 and
    more at the first step, for the yaml's 4 s crops (T' 3999: the last
    chunk is padding).  The DPRNN's first intra BiLSTM gives that chunk
    exact zeros too at zero biases, and its LayerNorm puts gradients of
    ~180 on that LSTM's biases (a global norm of 1056 at the yaml's
    widths, 453 with the input biases drawn; the other gradients' largest
    entries have a median of 0.27)."""
    hp = hparams
    if hp["model"] == "SepformerWrapper":
        model = SepformerWrapper(
            encoder_kernel_size=hp["encoder_kernel_size"],
            encoder_out_nchannels=hp["encoder_out_nchannels"],
            masknet_chunksize=hp["masknet_chunksize"],
            masknet_numlayers=hp["masknet_numlayers"],
            masknet_numspks=hp["num_spks"],
            intra_numlayers=hp["intra_numlayers"],
            inter_numlayers=hp["inter_numlayers"],
            intra_nhead=hp["intra_nhead"], inter_nhead=hp["inter_nhead"],
            intra_dffn=hp["intra_dffn"], inter_dffn=hp["inter_dffn"],
            intra_block=hp["intra_block"],
            conformer_kernel_size=hp["conformer_kernel_size"],
            use_rnn=hp.get("use_rnn", False))
    elif hp["model"] in ("SkiMSeparator", "ResepformerWrapper"):
        model = SkiMSeparator(
            encoder_kernel_size=hp["encoder_kernel_size"],
            encoder_out_nchannels=hp["encoder_out_nchannels"],
            num_spks=hp["num_spks"], causal=hp["causal"], unit=hp["unit"],
            segment_size=hp["segment_size"], num_blocks=hp["num_blocks"],
            mem_type=hp["mem_type"])
    elif hp["model"] == "ConvTasNet":
        model = ConvTasNet(
            N=hp["N"], B=hp["B"], H=hp["H"], P=hp["P"], X=hp["X"], R=hp["R"],
            C=hp["num_spks"], L=hp["L"], norm_type=hp["norm_type"],
            causal=hp["causal"], mask_nonlinear=hp["mask_nonlinear"])
    elif hp["model"] == "BinauralConvTasNet":
        model = BinauralConvTasNet(
            mode=hp["mode"], N=hp["N"], B=hp["B"], H=hp["H"], P=hp["P"],
            X=hp["X"], R=hp["R"], C=hp["num_spks"], L=hp["L"],
            norm_type=hp["norm_type"], causal=hp["causal"],
            mask_nonlinear=hp["mask_nonlinear"],
            sample_rate=hp["sample_rate"])
    elif hp["model"] == "SpectralMaskWrapper":
        masker = CNNTransformerSE(
            d_model=hp["d_model"], output_size=hp["n_fft"] // 2 + 1,
            output_activation=hp["output_activation"], nhead=hp["nhead"],
            num_layers=hp["num_layers"], d_ffn=hp["d_ffn"],
            dropout=hp["dropout"], causal=hp["causal"])
        model = SpectralMaskWrapper(masker, sample_rate=hp["sample_rate"],
                                    n_fft=hp["n_fft"])
    else:
        raise ValueError(f"Unknown model {hp['model']}")
    gen = torch.Generator().manual_seed(seed)
    _random_init(model, gen)
    _random_biases(model, gen)
    for m in model.modules():
        if isinstance(m, PReLU):
            m.reset_parameters()
    return model


class Separation(Brain):
    """The WSJ0-2mix recipe's ``Separation`` Brain (``train.py:24``), for
    any of the seven yamls (missing keys from ``HPARAMS_SEPFORMER``).

    ``compute_forward``: ``masknet`` (the separator) on ``mix_sig``, (B,
    T, num_spks).  ``compute_objectives``: the permutation-invariant
    negative SI-SNR (``get_si_snr_with_pitwrapper``'s, through the
    Brain's own ``PitWrapper``, whose permutation table is copied to the
    device once) of the stacked ``s1_sig``/``s2_sig`` against the
    estimates, capped at ``loss_upper_lim``, averaged over the rows of
    ``batch_mask``.  The
    optimizer is ``torch.optim.Adam`` (0.9, 0.999, eps 1e-8), optax's
    ``adam``, at ``self.lr``.  ``on_stage_end`` at VALID: ``self.lr``
    from ``self.lr_scheduler`` (``ReduceLROnPlateau(factor=lr_factor,
    patience=lr_patience, dont_halve_until_epoch)``) on the stage's loss,
    the line of ``hparams["train_logger"]`` (when given) and, with a
    checkpointer, a checkpoint with ``meta={"si-snr": loss}`` keeping the
    least; with a checkpointer the schedule is registered as
    ``"lr_scheduler"``.  ``hparams["crop"]`` (a ``MixtureCrop``,
    optional) is told each stage's epoch.  The VALID and TEST losses are
    in ``self.stage_stats``.

    Example
    -------
    >>> hp = {"encoder_out_nchannels": 8, "masknet_chunksize": 10,
    ...       "masknet_numlayers": 1, "intra_numlayers": 1,
    ...       "inter_numlayers": 1, "intra_nhead": 2, "inter_nhead": 2,
    ...       "intra_dffn": 16, "inter_dffn": 16}
    >>> brain = Separation(hp, run_opts={"device": "cpu"})
    >>> rng = np.random.default_rng(0)
    >>> s = rng.normal(size=(2, 2, 800)).astype(np.float32)
    >>> batch = {"mix_sig": s.sum(0), "s1_sig": s[0], "s2_sig": s[1]}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    def __init__(self, hparams=None, run_opts=None, checkpointer=None):
        hp = dict(HPARAMS_SEPFORMER, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adam(params, lr=hp["lr"], betas=(0.9, 0.999),
                                    eps=1e-8)

        super().__init__({"masknet": build_model(hp, run_opts["seed"])},
                         opt_class, hp, run_opts, checkpointer)
        self.lr_scheduler = ReduceLROnPlateau(
            factor=hp["lr_factor"], patience=hp["lr_patience"],
            dont_halve_until_epoch=hp["dont_halve_until_epoch"])
        self.pit_si_snr = PitWrapper(cal_si_snr)
        if (checkpointer is not None
                and "lr_scheduler" not in checkpointer.recoverables):
            checkpointer.add_recoverable("lr_scheduler", self.lr_scheduler)
        self.stage_stats = {}

    def set_kernels(self, flag=True):
        """Route the depthwise convolutions of the conformer blocks to the
        CUDA kernels (True) or to their plain versions (False)."""
        _set_kernels(self.modules, flag)
        return self

    def compute_forward(self, batch, stage):
        """(B, T, num_spks) estimates of the sources."""
        return self.modules.masknet(batch["mix_sig"].to(self.dtype))

    def targets(self, batch):
        """The sources stacked on a last axis."""
        return torch.stack([batch[f"s{i}_sig"] for i in
                            range(1, self.hparams.num_spks + 1)], dim=-1)

    def compute_objectives(self, predictions, batch, stage):
        """The capped PIT negative SI-SNR, averaged over the real rows."""
        targets = self.targets(batch)
        mask = batch["batch_mask"]
        per_ex = self.pit_si_snr(targets, predictions.float())[0]
        per_ex = per_ex.clamp(max=self.hparams.loss_upper_lim)
        return (per_ex * mask).sum() / mask.sum().clamp(min=1.0)

    def on_stage_start(self, stage, epoch=None):
        """The crop draws the epoch's crops."""
        crop = getattr(self.hparams, "crop", None)
        if crop is not None and epoch is not None:
            crop.set_epoch(epoch)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """At VALID: the plateau schedule, the log line and the keep-best
        checkpoint."""
        if stage == Stage.TRAIN:
            return
        self.stage_stats[stage.name] = {"si-snr": stage_loss}
        if stage != Stage.VALID:
            return
        _, self.lr = self.lr_scheduler(self.lr, current_epoch=epoch,
                                       current_loss=stage_loss)
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            train_logger.log_stats(
                {"epoch": epoch, "lr": self.lr},
                train_stats={"si-snr": self.avg_train_loss},
                valid_stats={"si-snr": stage_loss})
        if self.checkpointer is not None:
            self.checkpointer.save_and_keep_only(meta={"si-snr": stage_loss},
                                                 min_keys=["si-snr"])


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_SEPFORMER):
    """Everything ``run`` trains with, built as ``train.py``'s
    ``__main__`` builds it: ``hparams`` (one of the ``HPARAMS_*``) with
    the folders and ``overrides``; the manifests, the datasets, the
    loaders (``batch_size`` rows; training shuffled), an ``EpochCounter``
    and a ``Separation`` Brain with a ``Checkpointer`` on
    ``<output_folder>/save``, a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt`` and the crop.  Returns a dict of
    them (``brain``, ``epoch_counter``, ``train_loader``, ``valid_loader``,
    ``test_loader``, ``hparams``)."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                        [("train_data", "wsj_tr"), ("valid_data", "wsj_cv"),
                         ("test_data", "wsj_tt")])
    run_on_main(prepare_wsjmix, kwargs={
        "data_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "num_spks": hp["num_spks"]})
    datasets, crop = dataio_prep(hp)
    return assemble(hp, datasets, crop, run_opts)


def assemble(hp, datasets, crop, run_opts, brain_class=Separation):
    """The parts of a separation recipe's ``build`` over its
    ``datasets``: an ``EpochCounter``, a ``brain_class`` Brain (a
    ``Checkpointer`` on ``save_folder``, a ``FileTrainLogger`` on
    ``train_log``, ``crop`` in its hparams: a ``MixtureCrop`` or anything
    with ``set_epoch``) and the loaders (``batch_size`` rows; training
    shuffled), with ``hp`` as ``hparams``."""
    brain = brain_class(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]), crop=crop),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]))
    bs = hp["batch_size"]
    return {"brain": brain,
            "epoch_counter": EpochCounter(hp["number_of_epochs"]),
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "hparams": hp}


def fit_and_test(parts, min_key="si-snr"):
    """``fit`` (resuming from the latest checkpoint), then ``evaluate`` on
    the test set with the checkpoint of the least ``min_key``.  Returns
    the Brain."""
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key=min_key)
    return brain


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_SEPFORMER):
    """``train.py`` end to end: ``build``, ``fit`` (resuming from the
    latest checkpoint), then ``evaluate`` on the test set with the
    checkpoint of the least validation loss.  Returns the Brain; its
    ``stage_stats["TEST"]["si-snr"]`` is the test loss (the negative
    SI-SNR in dB)."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams))


def harmonic_sources(rng, count, samples, sample_rate, peak=0.4):
    """``count`` synthetic sources of ``samples`` samples: harmonic tones
    (random f0 in 90-300 Hz, four partials with random weights and
    phases) under random smooth envelopes, at most ``peak``."""
    t = np.arange(samples) / sample_rate
    out = []
    for _ in range(count):
        f0 = rng.uniform(90.0, 300.0)
        tone = sum(rng.uniform(0.2, 1.0) * np.sin(
            2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
            for k in range(1, 5))
        env = np.interp(t, np.linspace(0, t[-1], 6), rng.uniform(0.1, 1.0, 6))
        out.append(peak * env * tone / np.abs(tone).max())
    return out


def pcm16(signal):
    """Float samples in [-1, 1] -> int32 16-bit PCM values (rounded)."""
    return np.round(np.asarray(signal) * 32767).astype(np.int32)


def write_wav(path, pcm, sample_rate):
    """Write 16-bit PCM values, (time,) or (time, channels), as a WAV."""
    pcm = np.clip(pcm, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def write_synthetic_wsj0mix(folder, n=None, seconds=(2.0, 5.0), seed=0,
                            sample_rate=8000):
    """Write a wsj0-mix-shaped tree of synthetic mixtures, for trying the
    recipe without the corpus: for each split of ``n`` (default
    ``{"tr": 24, "cv": 6, "tt": 6}``) that many 16-bit WAVs at
    ``sample_rate`` in ``<folder>/<split>/{s1,s2,mix}/``, lasting
    ``seconds`` (uniform): two ``harmonic_sources``; the mixture is the
    sum of the two stored sources, sample for sample.  Everything comes
    from ``seed``."""
    n = n or {"tr": 24, "cv": 6, "tt": 6}
    rng = np.random.default_rng(seed)
    for split, count in n.items():
        for sub in ("s1", "s2", "mix"):
            os.makedirs(os.path.join(folder, split, sub), exist_ok=True)
        for i in range(count):
            samples = int(rng.uniform(*seconds) * sample_rate)
            pcm = [pcm16(x) for x in harmonic_sources(rng, 2, samples,
                                                      sample_rate)]
            name = f"synth{i:04d}.wav"
            for sub, data in (("s1", pcm[0]), ("s2", pcm[1]),
                              ("mix", pcm[0] + pcm[1])):
                write_wav(os.path.join(folder, split, sub, name), data,
                          sample_rate)
