"""The WHAM!/WHAMR! separation and enhancement recipes end to end, on the
port.

Does what ``recipes/WHAMandWHAMR/separation/train.py`` and
``recipes/WHAMandWHAMR/enhancement/train.py`` (the same script) do with
their twelve hparams files (two and ten), each a dict here (``YAMLS``
maps the yaml files, relative to ``recipes/WHAMandWHAMR/``, to them): a WHAM!/WHAMR!
tree (``<data_folder>/wav8k/min/{tr,cv,tt}/{mix_both,s1,s2,noise}/``, or
``wav16k`` at 16 kHz) -> JSON manifests (``prepare_wham``) -> the
``Separation`` Brain of ``wsj0mix_separation`` with ``num_spks`` sources
(1: enhancement, the noisy mixture against its clean source) ->
``evaluate`` on the test set with the best checkpoint.  With
``dynamic_mixing`` every training example is mixed anew each epoch
(``DynamicMix``); the validation and test sets never are.

``overrides`` replace any value, e.g. toy widths for the CPU::

    from speechbrain_tpu_torch.recipes import wham_separation as wham
    wham.write_synthetic_wham("/tmp/wham")
    wham.run("/tmp/wham", "/tmp/out", run_opts={"device": "cpu"},
             hparams=wham.HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM,
             overrides={"d_model": 16, "nhead": 2, "num_layers": 1,
                        "d_ffn": 32, "training_signal_len": 4000,
                        "number_of_epochs": 2})

Differences from the JAX recipe, each on purpose:

- the training crops and every draw of the dynamic mixing (the sources,
  their gains, their crops and the noise's) come from a generator keyed
  by (seed, epoch, mixture id), not from one generator shared by the
  pipeline, so a resumed epoch mixes what the uninterrupted one would,
  whatever the loader's threads do;
- ``ReduceLROnPlateau`` is registered with the checkpointer, so a resumed
  run continues it (the JAX recipe's bare ``Checkpointer`` restarts it);
- ``prepare_wham`` writes each file's duration at the file's own rate.
"""

import json
import os
import zlib

import numpy as np

from ..dataio.dataio import read_audio
from ..dataio.dataset import DynamicItemDataset
from ..utils.distributed import run_on_main
from .common import recipe_hparams
from .wsj0mix_separation import (_SEPFORMER, _TRAINING, HPARAMS_CONVTASNET,
                                 HPARAMS_DPRNN, SPLITS, assemble, dataio_prep,
                                 fit_and_test, harmonic_sources, pcm16,
                                 write_manifest, write_wav)

__all__ = ["HPARAMS_SEPARATION_SEPFORMER_WHAM",
           "HPARAMS_SEPARATION_SEPFORMER_WHAMR",
           "HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAM_DM",
           "HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM",
           "HPARAMS_ENHANCEMENT_CONVTASNET_WHAMR_DM",
           "HPARAMS_ENHANCEMENT_DPRNN_WHAMR_DM",
           "HPARAMS_ENHANCEMENT_SEPFORMER_ENHANCEMENT",
           "HPARAMS_ENHANCEMENT_SEPFORMER_WHAM",
           "HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR",
           "HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_DM",
           "HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K",
           "HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K_DM", "YAMLS",
           "prepare_wham", "DynamicMix", "wham_dataio_prep", "build", "run",
           "write_synthetic_wham"]

_WHAM = dict(_TRAINING, dynamic_mixing=False)
_SEP = dict(_WHAM, **_SEPFORMER)
# separation/hparams/sepformer-wham.yaml (3 s crops) and -whamr.yaml
HPARAMS_SEPARATION_SEPFORMER_WHAM = dict(_SEP, training_signal_len=24000)
HPARAMS_SEPARATION_SEPFORMER_WHAMR = dict(_SEP)
_ENH = dict(_SEP, num_spks=1)
# enhancement/hparams/cnntransformer-{wham,whamr}-DM.yaml (the same values)
HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAM_DM = dict(
    _WHAM, num_spks=1, dynamic_mixing=True, model="SpectralMaskWrapper",
    n_fft=512, d_model=256, output_activation="sigmoid", num_layers=8,
    d_ffn=512, nhead=16, causal=False, dropout=0.1)
HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM = dict(
    HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAM_DM)
# enhancement/hparams/convtasnet-whamr-DM.yaml and dprnn-whamr-DM.yaml
HPARAMS_ENHANCEMENT_CONVTASNET_WHAMR_DM = dict(
    HPARAMS_CONVTASNET, num_spks=1, dynamic_mixing=True)
HPARAMS_ENHANCEMENT_DPRNN_WHAMR_DM = dict(
    HPARAMS_DPRNN, num_spks=1, dynamic_mixing=True)
# enhancement/hparams/sepformer-*.yaml
HPARAMS_ENHANCEMENT_SEPFORMER_ENHANCEMENT = dict(_ENH,
                                                 training_signal_len=24000)
HPARAMS_ENHANCEMENT_SEPFORMER_WHAM = dict(_ENH)
HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR = dict(_ENH)
HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_DM = dict(_ENH, dynamic_mixing=True)
HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K = dict(
    _ENH, sample_rate=16000, training_signal_len=64000)
HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K_DM = dict(
    HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K, dynamic_mixing=True)

YAMLS = {
    "separation/hparams/sepformer-wham.yaml":
        HPARAMS_SEPARATION_SEPFORMER_WHAM,
    "separation/hparams/sepformer-whamr.yaml":
        HPARAMS_SEPARATION_SEPFORMER_WHAMR,
    "enhancement/hparams/cnntransformer-wham-DM.yaml":
        HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAM_DM,
    "enhancement/hparams/cnntransformer-whamr-DM.yaml":
        HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM,
    "enhancement/hparams/convtasnet-whamr-DM.yaml":
        HPARAMS_ENHANCEMENT_CONVTASNET_WHAMR_DM,
    "enhancement/hparams/dprnn-whamr-DM.yaml":
        HPARAMS_ENHANCEMENT_DPRNN_WHAMR_DM,
    "enhancement/hparams/sepformer-enhancement.yaml":
        HPARAMS_ENHANCEMENT_SEPFORMER_ENHANCEMENT,
    "enhancement/hparams/sepformer-wham.yaml":
        HPARAMS_ENHANCEMENT_SEPFORMER_WHAM,
    "enhancement/hparams/sepformer-whamr.yaml":
        HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR,
    "enhancement/hparams/sepformer-whamr-DM.yaml":
        HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_DM,
    "enhancement/hparams/sepformer-whamr-16k.yaml":
        HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K,
    "enhancement/hparams/sepformer-whamr-16k-DM.yaml":
        HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K_DM,
}


def _root(data_folder, sample_rate):
    return os.path.join(data_folder,
                        "wav8k" if sample_rate == 8000 else "wav16k", "min")


def prepare_wham(data_folder, save_folder, num_spks=2, sample_rate=8000):
    """``<save_folder>/wham_{tr,cv,tt}.json`` from a WHAM!/WHAMR! tree
    (``<data_folder>/wav8k/min/<split>/``, ``wav16k`` for any other rate):
    one entry per ``mix_both/*.wav`` (sorted) with ``mix_wav``,
    ``duration`` (at the file's own rate), ``noise_wav`` and ``s{i}_wav``.
    A manifest that exists is kept."""
    os.makedirs(save_folder, exist_ok=True)
    root = _root(data_folder, sample_rate)
    for split in SPLITS:
        d = os.path.join(root, split)
        write_manifest(
            os.path.join(save_folder, f"wham_{split}.json"),
            os.path.join(d, "mix_both"),
            {"noise_wav": os.path.join(d, "noise"),
             **{f"s{i}_wav": os.path.join(d, f"s{i}")
                for i in range(1, num_spks + 1)}})


class DynamicMix:
    """Dynamic mixing of a training example (the JAX recipe's
    ``_dynamic_mix_pipeline``): ``num_spks`` sources drawn from
    ``sources`` (every ``s{i}_wav`` of the training manifest), each cut
    (from a uniform start) or zero-padded to ``samples`` and scaled by a
    gain uniform in +-5 dB, plus the example's own noise cut the same
    way; the mixture and the scaled sources all scaled by min(1, 0.9 /
    the mixture's peak).  The draws, in JAX's order (a source's index,
    its crop start, its gain; the noise's crop start), come from
    ``np.random.default_rng((seed, epoch, crc32(mixture id)))``, so an
    example's mixture depends on the epoch (``set_epoch``) and its id
    alone.  Returns float32 ``(mix, s1, ..., s{num_spks})``."""

    def __init__(self, sources, samples, seed, num_spks):
        self.sources = list(sources)
        self.samples, self.seed = int(samples), int(seed)
        self.num_spks = int(num_spks)
        self.epoch = 0

    def set_epoch(self, epoch):
        """The epoch whose mixtures the next calls draw."""
        self.epoch = int(epoch)

    def __call__(self, noise_wav, mix_id):
        rng = np.random.default_rng(
            (self.seed, self.epoch, zlib.crc32(mix_id.encode())))

        def fixed_crop(sig):
            n = len(sig)
            if n > self.samples:
                start = int(rng.integers(0, n - self.samples))
                return sig[start:start + self.samples]
            return np.pad(sig, (0, self.samples - n))

        sources = []
        for _ in range(self.num_spks):
            path = self.sources[int(rng.integers(len(self.sources)))]
            s = fixed_crop(read_audio(path))
            sources.append(s * 10.0 ** (float(rng.uniform(-5.0, 5.0)) / 20.0))
        mix = np.sum(sources, axis=0) + fixed_crop(read_audio(noise_wav))
        scale = min(1.0, 0.9 / max(float(np.abs(mix).max()), 1e-6))
        return tuple((x * scale).astype(np.float32) for x in [mix] + sources)


def wham_dataio_prep(hparams):
    """The datasets of ``dataio_prep`` (``train.py:150``); with
    ``dynamic_mixing`` the training set's examples come from a
    ``DynamicMix`` over the training manifest's sources instead.  Returns
    ``(datasets, crop)``: the ``MixtureCrop`` or the ``DynamicMix``,
    whichever the training set draws from."""
    datasets, crop = dataio_prep(hparams)
    if not hparams.get("dynamic_mixing", False):
        return datasets, crop
    with open(hparams["train_data"]) as f:
        manifest = json.load(f)
    spks = range(1, hparams["num_spks"] + 1)
    keys = [f"s{i}_wav" for i in spks]
    mix = DynamicMix([e[k] for e in manifest.values() for k in keys if k in e],
                     hparams["training_signal_len"], hparams["seed"],
                     hparams["num_spks"])
    ds = DynamicItemDataset.from_json(hparams["train_data"])
    sigs = [f"s{i}_sig" for i in spks]
    ds.add_dynamic_item(mix, takes=["noise_wav", "id"],
                        provides=["mix_sig"] + sigs)
    ds.set_output_keys(["id", "mix_sig"] + sigs)
    datasets["train"] = ds
    return datasets, mix


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM):
    """As ``wsj0mix_separation.build``, over ``prepare_wham``'s manifests
    and ``wham_dataio_prep``'s datasets."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                        [("train_data", "wham_tr"), ("valid_data", "wham_cv"),
                         ("test_data", "wham_tt")])
    run_on_main(prepare_wham, kwargs={
        "data_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "num_spks": hp["num_spks"], "sample_rate": hp["sample_rate"]})
    datasets, crop = wham_dataio_prep(hp)
    return assemble(hp, datasets, crop, run_opts)


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM):
    """``train.py`` end to end (``build``, ``fit``, ``evaluate`` with the
    best checkpoint).  Returns the Brain; ``stage_stats["TEST"]["si-snr"]``
    is the test loss (the negative SI-SNR in dB)."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams))


def write_synthetic_wham(folder, n=None, seconds=(2.0, 5.0), seed=0,
                         sample_rate=8000, num_spks=2):
    """Write a WHAM!-shaped tree of synthetic mixtures, for trying the
    recipes without the corpus: for each split of ``n`` (default
    ``{"tr": 12, "cv": 3, "tt": 3}``) that many 16-bit WAVs at
    ``sample_rate`` (``wav8k`` or ``wav16k``) in
    ``<folder>/wav{8,16}k/min/<split>/{s1..,noise,mix_both}/``, lasting
    ``seconds`` (uniform): ``num_spks`` harmonic sources (peaks 0.8 /
    ``num_spks``), white noise at 0.05 and their sum, sample for sample.
    Everything comes from ``seed``."""
    n = n or {"tr": 12, "cv": 3, "tt": 3}
    rng = np.random.default_rng(seed)
    subs = [f"s{i}" for i in range(1, num_spks + 1)] + ["noise", "mix_both"]
    for split, count in n.items():
        d = os.path.join(_root(folder, sample_rate), split)
        for sub in subs:
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(count):
            samples = int(rng.uniform(*seconds) * sample_rate)
            pcm = [pcm16(x) for x in harmonic_sources(
                rng, num_spks, samples, sample_rate, 0.8 / num_spks)]
            pcm.append(pcm16(0.05 * rng.standard_normal(samples)))
            pcm.append(sum(pcm))
            for sub, data in zip(subs, pcm):
                write_wav(os.path.join(d, sub, f"synth{i:04d}.wav"), data,
                          sample_rate)
