"""The LibriMix and Aishell1Mix separation recipes end to end, on the
port.

Does what ``recipes/LibriMix/separation/train.py`` (three hparams files)
and ``recipes/Aishell1Mix/separation/train.py`` (five) do: the two
scripts differ only in their prepare step.  Each yaml is a dict here
(``YAMLS`` maps the yaml files, relative to ``recipes/``, to them): a
LibriMix-layout tree (``<data_folder>/wav8k/min/<split>/{mix_clean,
mix_both,s1,s2,s3}/``, ``wav16k`` at 16 kHz; ``use_wham_noise`` reads the
noisy ``mix_both``) -> JSON manifests (``prepare_librimix``:
``libri{n}mix_{train,dev,test}.json`` from the first of ``train-360``,
``train-100``, ``train``; ``prepare_aishell1mix``:
``aishell1mix{n}_*.json`` from ``train`` or ``train-100``) -> the
``Separation`` Brain of ``wsj0mix_separation`` with ``num_spks`` (2 or
3) sources -> ``evaluate`` with the best checkpoint.

Differences from the JAX recipes, each on purpose:

- the training crops are keyed by (seed, epoch, mixture id)
  (``MixtureCrop``), not drawn from one shared generator;
- ``ReduceLROnPlateau`` is registered with the checkpointer (a bare
  ``Checkpointer`` in JAX restarts it on resume);
- each duration is at its file's own rate;
- the manifests are named from ``num_spks``: the JAX 3-mix yamls
  (``sepformer-libri3mix.yaml``, ``sepformer-aishell1mix3*.yaml``) read
  the 2-mix names, which their own prepare step does not write.

Toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import librimix_separation as lm
    lm.write_synthetic_librimix("/tmp/libri3", num_spks=3)
    lm.run("/tmp/libri3", "/tmp/out", run_opts={"device": "cpu"},
           hparams=lm.HPARAMS_LIBRI3MIX,
           overrides={"encoder_out_nchannels": 16, "masknet_chunksize": 10,
                      "masknet_numlayers": 1, "intra_numlayers": 1,
                      "inter_numlayers": 1, "intra_nhead": 4,
                      "inter_nhead": 4, "intra_dffn": 32, "inter_dffn": 32,
                      "training_signal_len": 4000, "number_of_epochs": 1})
"""

import os

import numpy as np

from ..utils.distributed import run_on_main
from .common import recipe_hparams
from .wham_separation import _root
from .wsj0mix_separation import (_SEPFORMER, _TRAINING, assemble, dataio_prep,
                                 fit_and_test, harmonic_sources, pcm16,
                                 write_manifest, write_wav)

__all__ = ["HPARAMS_LIBRIMIX", "HPARAMS_LIBRI2MIX", "HPARAMS_LIBRI3MIX",
           "HPARAMS_AISHELL1MIX", "HPARAMS_AISHELL1MIX2",
           "HPARAMS_AISHELL1MIX2_WHAM", "HPARAMS_AISHELL1MIX3",
           "HPARAMS_AISHELL1MIX3_WHAM", "YAMLS", "prepare_librimix",
           "prepare_aishell1mix", "build", "run", "write_synthetic_librimix"]

_BASE = dict(_TRAINING, **_SEPFORMER, training_signal_len=24000,
             use_wham_noise=False)
# LibriMix/separation/hparams/sepformer{,-libri2mix,-libri3mix}.yaml
HPARAMS_LIBRIMIX = dict(_BASE, corpus="librimix")
HPARAMS_LIBRI2MIX = dict(HPARAMS_LIBRIMIX)
HPARAMS_LIBRI3MIX = dict(HPARAMS_LIBRIMIX, num_spks=3)
# Aishell1Mix/separation/hparams/sepformer{,-aishell1mix{2,3}{,-wham}}.yaml
HPARAMS_AISHELL1MIX = dict(_BASE, corpus="aishell1mix")
HPARAMS_AISHELL1MIX2 = dict(HPARAMS_AISHELL1MIX)
HPARAMS_AISHELL1MIX2_WHAM = dict(HPARAMS_AISHELL1MIX, use_wham_noise=True)
HPARAMS_AISHELL1MIX3 = dict(HPARAMS_AISHELL1MIX, num_spks=3)
HPARAMS_AISHELL1MIX3_WHAM = dict(HPARAMS_AISHELL1MIX3, use_wham_noise=True)

YAMLS = {
    "LibriMix/separation/hparams/sepformer.yaml": HPARAMS_LIBRIMIX,
    "LibriMix/separation/hparams/sepformer-libri2mix.yaml": HPARAMS_LIBRI2MIX,
    "LibriMix/separation/hparams/sepformer-libri3mix.yaml": HPARAMS_LIBRI3MIX,
    "Aishell1Mix/separation/hparams/sepformer.yaml": HPARAMS_AISHELL1MIX,
    "Aishell1Mix/separation/hparams/sepformer-aishell1mix2.yaml":
        HPARAMS_AISHELL1MIX2,
    "Aishell1Mix/separation/hparams/sepformer-aishell1mix2-wham.yaml":
        HPARAMS_AISHELL1MIX2_WHAM,
    "Aishell1Mix/separation/hparams/sepformer-aishell1mix3.yaml":
        HPARAMS_AISHELL1MIX3,
    "Aishell1Mix/separation/hparams/sepformer-aishell1mix3-wham.yaml":
        HPARAMS_AISHELL1MIX3_WHAM,
}

_TRAIN_DIRS = {"librimix": ("train-360", "train-100", "train"),
               "aishell1mix": ("train", "train-100")}


def _manifest_name(corpus, num_spks, split):
    if corpus == "librimix":
        return f"libri{num_spks}mix_{split}"
    return f"aishell1mix{num_spks}_{split}"


def _prepare(corpus, data_folder, save_folder, num_spks, use_wham_noise,
             sample_rate):
    os.makedirs(save_folder, exist_ok=True)
    root = _root(data_folder, sample_rate)
    train = next((d for d in _TRAIN_DIRS[corpus]
                  if os.path.isdir(os.path.join(root, d))), None)
    if train is None:
        raise FileNotFoundError(f"No train-* split under {root}")
    mix = "mix_both" if use_wham_noise else "mix_clean"
    for split, dirname in (("train", train), ("dev", "dev"), ("test", "test")):
        d = os.path.join(root, dirname)
        write_manifest(
            os.path.join(save_folder,
                         f"{_manifest_name(corpus, num_spks, split)}.json"),
            os.path.join(d, mix),
            {f"s{i}_wav": os.path.join(d, f"s{i}")
             for i in range(1, num_spks + 1)})


def prepare_librimix(data_folder, save_folder, num_spks=2,
                     use_wham_noise=False, sample_rate=8000):
    """``<save_folder>/libri{num_spks}mix_{train,dev,test}.json`` from a
    LibriMix tree (``<data_folder>/wav8k/min/``, ``wav16k`` for any other
    rate; the training split the first of ``train-360``, ``train-100``,
    ``train``): one entry per ``mix_clean/*.wav`` (``mix_both`` with
    ``use_wham_noise``) with ``mix_wav``, ``duration`` (at the file's own
    rate) and ``s{i}_wav``.  A manifest that exists is kept."""
    _prepare("librimix", data_folder, save_folder, num_spks, use_wham_noise,
             sample_rate)


def prepare_aishell1mix(data_folder, save_folder, num_spks=2,
                        use_wham_noise=False, sample_rate=8000):
    """As ``prepare_librimix`` for an Aishell1Mix tree: the training split
    ``train`` (or ``train-100``), the manifests
    ``aishell1mix{num_spks}_{train,dev,test}.json``."""
    _prepare("aishell1mix", data_folder, save_folder, num_spks,
             use_wham_noise, sample_rate)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_LIBRI2MIX):
    """As ``wsj0mix_separation.build``, over the prepare step of
    ``hparams["corpus"]`` ("librimix" or "aishell1mix")."""
    merged = dict(hparams, **(overrides or {}))
    corpus, n = merged["corpus"], merged["num_spks"]
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, [
        (f"{key}_data", _manifest_name(corpus, n, split))
        for key, split in (("train", "train"), ("valid", "dev"),
                           ("test", "test"))])
    prepare = (prepare_librimix if corpus == "librimix"
               else prepare_aishell1mix)
    run_on_main(prepare, kwargs={
        "data_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "num_spks": n, "use_wham_noise": hp["use_wham_noise"],
        "sample_rate": hp["sample_rate"]})
    datasets, crop = dataio_prep(hp)
    return assemble(hp, datasets, crop, run_opts)


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_LIBRI2MIX):
    """``train.py`` end to end (``build``, ``fit``, ``evaluate`` with the
    best checkpoint).  Returns the Brain."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams))


def write_synthetic_librimix(folder, n=None, seconds=(2.0, 5.0), seed=0,
                             sample_rate=8000, num_spks=2, train="train-100"):
    """Write a LibriMix-shaped tree of synthetic mixtures: for each split
    of ``n`` (default ``{train: 12, "dev": 3, "test": 3}``, ``train`` the
    training folder's name) that many 16-bit WAVs in
    ``<folder>/wav{8,16}k/min/<split>/{s1..,noise,mix_clean,mix_both}/``:
    ``num_spks`` harmonic sources (peaks 0.8 / ``num_spks``), white noise
    at 0.05, their clean and noisy sums, sample for sample.  Everything
    comes from ``seed``."""
    n = n or {train: 12, "dev": 3, "test": 3}
    rng = np.random.default_rng(seed)
    subs = ([f"s{i}" for i in range(1, num_spks + 1)]
            + ["noise", "mix_clean", "mix_both"])
    for split, count in n.items():
        d = os.path.join(_root(folder, sample_rate), split)
        for sub in subs:
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(count):
            samples = int(rng.uniform(*seconds) * sample_rate)
            pcm = [pcm16(x) for x in harmonic_sources(
                rng, num_spks, samples, sample_rate, 0.8 / num_spks)]
            noise = pcm16(0.05 * rng.standard_normal(samples))
            pcm += [noise, sum(pcm), sum(pcm) + noise]
            for sub, data in zip(subs, pcm):
                write_wav(os.path.join(d, sub, f"synth{i:04d}.wav"), data,
                          sample_rate)
