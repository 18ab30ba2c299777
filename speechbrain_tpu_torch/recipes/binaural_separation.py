"""The binaural WSJ0-2mix separation recipe end to end, on the port.

Does what ``recipes/BinauralWSJ0Mix/separation/train.py`` does with its
five hparams files (``YAMLS`` maps them, relative to
``recipes/BinauralWSJ0Mix/separation/``, to the dicts here): a
binaural-wsj0mix tree (``<data_folder>/{tr,cv,tt}/{mix,s1,s2}/*.wav``,
stereo) -> JSON manifests (``prepare_binaural_wsjmix``:
``binaural_{tr,cv,tt}.json``) -> ``BinauralSeparation`` -> ``evaluate``
with the best checkpoint.  ``convtasnet-independent.yaml`` runs the mono
``ConvTasNet`` on each ear (``binaural_model`` False); the other four run
``BinauralConvTasNet`` in the mode ``mode`` ("parallel" in three,
"cross" in one).  The loss folds the two ears into time, so an example
takes one permutation for both.

Differences from the JAX recipe, each on purpose: the crops are keyed by
(seed, epoch, mixture id) (``MixtureCrop``); ``ReduceLROnPlateau`` is
registered with the checkpointer; each duration is read at its file's
own rate (JAX divides by 8000).

Toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import binaural_separation as bi
    bi.write_synthetic_binaural("/tmp/bi")
    bi.run("/tmp/bi", "/tmp/out", run_opts={"device": "cpu"},
           hparams=bi.HPARAMS_CROSS,
           overrides={"N": 16, "B": 8, "H": 16, "X": 2, "R": 1,
                      "training_signal_len": 4000, "number_of_epochs": 1})
"""

import os

import numpy as np

from ..dataio.dataio import read_audio_multichannel
from ..utils.distributed import run_on_main
from .common import recipe_hparams
from .wsj0mix_separation import (_TRAINING, Separation, assemble, dataio_prep,
                                 fit_and_test, harmonic_sources, pcm16,
                                 prepare_wsjmix, write_wav)

__all__ = ["HPARAMS_CROSS", "HPARAMS_INDEPENDENT", "HPARAMS_PARALLEL",
           "HPARAMS_PARALLEL_NOISE", "HPARAMS_PARALLEL_REVERB", "YAMLS",
           "prepare_binaural_wsjmix", "BinauralSeparation", "build", "run",
           "write_synthetic_binaural"]

_BASE = dict(_TRAINING, training_signal_len=24000, number_of_epochs=100,
             dont_halve_until_epoch=50, N=256, B=128, H=256, P=3, X=6, R=2,
             L=16, norm_type="gLN", causal=False, mask_nonlinear="relu")
# hparams/convtasnet-*.yaml
HPARAMS_CROSS = dict(_BASE, model="BinauralConvTasNet", mode="cross",
                     binaural_model=True)
HPARAMS_PARALLEL = dict(HPARAMS_CROSS, mode="parallel")
HPARAMS_PARALLEL_NOISE = dict(HPARAMS_PARALLEL)
HPARAMS_PARALLEL_REVERB = dict(HPARAMS_PARALLEL)
HPARAMS_INDEPENDENT = dict(_BASE, model="ConvTasNet", binaural_model=False)

YAMLS = {
    "hparams/convtasnet-cross.yaml": HPARAMS_CROSS,
    "hparams/convtasnet-independent.yaml": HPARAMS_INDEPENDENT,
    "hparams/convtasnet-parallel.yaml": HPARAMS_PARALLEL,
    "hparams/convtasnet-parallel-noise.yaml": HPARAMS_PARALLEL_NOISE,
    "hparams/convtasnet-parallel-reverb.yaml": HPARAMS_PARALLEL_REVERB,
}


def prepare_binaural_wsjmix(data_folder, save_folder, num_spks=2):
    """``<save_folder>/binaural_{tr,cv,tt}.json`` from a binaural-wsj0mix
    tree, as ``prepare_wsjmix`` writes them (durations at each file's own
    rate)."""
    prepare_wsjmix(data_folder, save_folder, num_spks, name="binaural")


class BinauralSeparation(Separation):
    """The binaural recipe's Brain: ``Separation`` on (B, T, 2) mixtures.
    ``compute_forward``: with ``binaural_model`` the ``masknet`` on the
    stereo mixture, else the mono model on each ear (the ears folded into
    the batch), (B, T, 2, num_spks) either way.  ``compute_objectives``:
    ``Separation``'s PIT loss with the ears folded into time, targets (B,
    T, 2, num_spks) and estimates alike -> (B, 2 T, num_spks), one
    permutation an example."""

    def compute_forward(self, batch, stage):
        mix = batch["mix_sig"].to(self.dtype)
        if self.hparams.binaural_model:
            return self.modules.masknet(mix)
        B, T, C = mix.shape
        est = self.modules.masknet(mix.transpose(1, 2).reshape(B * C, T))
        return est.reshape(B, C, T, -1).transpose(1, 2)

    def targets(self, batch):
        t = super().targets(batch)
        return t.reshape(t.shape[0], -1, t.shape[-1])

    def compute_objectives(self, predictions, batch, stage):
        return super().compute_objectives(
            predictions.reshape(predictions.shape[0], -1,
                                predictions.shape[-1]), batch, stage)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_PARALLEL):
    """As ``wsj0mix_separation.build``, over ``prepare_binaural_wsjmix``'s
    manifests, stereo reads and a ``BinauralSeparation`` Brain."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                        [("train_data", "binaural_tr"),
                         ("valid_data", "binaural_cv"),
                         ("test_data", "binaural_tt")])
    run_on_main(prepare_binaural_wsjmix, kwargs={
        "data_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "num_spks": hp["num_spks"]})
    datasets, crop = dataio_prep(hp, read=read_audio_multichannel)
    return assemble(hp, datasets, crop, run_opts, BinauralSeparation)


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_PARALLEL):
    """``train.py`` end to end (``build``, ``fit``, ``evaluate`` with the
    best checkpoint).  Returns the Brain."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams))


def write_synthetic_binaural(folder, n=None, seconds=(2.0, 5.0), seed=0,
                             sample_rate=8000):
    """Write a binaural-wsj0mix-shaped tree: for each split of ``n``
    (default ``{"tr": 12, "cv": 3, "tt": 3}``) that many stereo 16-bit
    WAVs in ``<folder>/<split>/{s1,s2,mix}/``: two harmonic sources, each
    reaching the right ear with a gain (0.3-1) and a delay (0-8 samples)
    of its own, and their sum, sample for sample.  Everything comes from
    ``seed``."""
    n = n or {"tr": 12, "cv": 3, "tt": 3}
    rng = np.random.default_rng(seed)
    for split, count in n.items():
        for sub in ("s1", "s2", "mix"):
            os.makedirs(os.path.join(folder, split, sub), exist_ok=True)
        for i in range(count):
            samples = int(rng.uniform(*seconds) * sample_rate)
            ears = []
            for src in harmonic_sources(rng, 2, samples, sample_rate):
                delay = int(rng.integers(0, 9))
                right = rng.uniform(0.3, 1.0) * np.roll(src, delay)
                ears.append(pcm16(np.stack([src, right], -1)))
            for sub, data in (("s1", ears[0]), ("s2", ears[1]),
                              ("mix", ears[0] + ears[1])):
                write_wav(os.path.join(folder, split, sub,
                                       f"synth{i:04d}.wav"), data, sample_rate)
