"""VoxCeleb data preparation: train/valid JSON manifests and the trial
list.

A copy of the JAX recipe's ``recipes/VoxCeleb/voxceleb_prepare.py``
(``prepare_voxceleb``, ``prepare_trials``), with one repair: the trial
paths of ``veri_test2.txt`` are relative to the corpus's ``wav/`` folder,
and ``wav_root`` resolves that folder for both functions.  The JAX
verification scripts pass the corpus folder itself to ``prepare_trials``
(``speaker_verification_cosine.py:80-82``,
``speaker_verification_plda.py:71-73``), so on VoxCeleb's own layout
(``<data_folder>/wav/idXXXXX/<video>/<nnnnn>.wav``) their trial paths
point at nothing.
"""

import json
import logging
import os
import random

from ..dataio.dataio import read_audio

__all__ = ["wav_root", "prepare_voxceleb", "prepare_trials"]

logger = logging.getLogger(__name__)


def wav_root(data_folder):
    """``<data_folder>/wav`` where it is a folder, else ``data_folder``."""
    root = os.path.join(data_folder, "wav")
    return root if os.path.isdir(root) else data_folder


def prepare_voxceleb(data_folder, save_folder, splits=("train", "valid"),
                     split_ratio=(90, 10), seg_dur=3.0,
                     verification_pairs_file=None, skip_prep=False,
                     seed=1234):
    """Write ``<save_folder>/{train,valid}.json`` from the WAVs under
    ``wav_root(data_folder)``, each entry ``{"wav": path, "duration": s,
    "spk_id": speaker}`` under the id ``<speaker>--<relative path without
    .wav, / as -->`` (so the speaker appears twice, as in JAX).  The
    speaker is the first folder below the root.  Each speaker's files,
    sorted then shuffled by one ``random.Random(seed)`` taken in speaker
    order, give ``max(1, round(n x 10 %))`` to valid when the speaker
    has two or more.  Skipped when every manifest exists.  With
    ``verification_pairs_file``, also ``trials.json``
    (``prepare_trials``).

    Example
    -------
    >>> import tempfile
    >>> from speechbrain_tpu_torch.recipes.voxceleb_speaker import (
    ...     write_synthetic_voxceleb)
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_voxceleb(d, speakers=2, clips=3, seconds=(0.2, 0.3))
    >>> prepare_voxceleb(d, d + "/save")
    >>> [len(json.load(open(f"{d}/save/{s}.json"))) for s in ("train", "valid")]
    [4, 2]
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    out_paths = {s: os.path.join(save_folder, f"{s}.json") for s in splits}
    if all(os.path.exists(p) for p in out_paths.values()):
        logger.info("VoxCeleb manifests exist, skipping preparation")
        return
    root = wav_root(data_folder)
    by_spk = {}
    for folder, _, files in os.walk(root):
        for fn in files:
            if not fn.lower().endswith(".wav"):
                continue
            path = os.path.join(folder, fn)
            spk = os.path.relpath(path, root).split(os.sep)[0]
            by_spk.setdefault(spk, []).append(path)
    if not by_spk:
        raise FileNotFoundError(f"No wav files under {root}")
    rng = random.Random(seed)
    manifests = {s: {} for s in splits}
    frac_valid = split_ratio[1] / sum(split_ratio)
    for spk, paths in sorted(by_spk.items()):
        paths = sorted(paths)
        rng.shuffle(paths)
        n_valid = (max(1, int(round(len(paths) * frac_valid)))
                   if "valid" in splits and len(paths) > 1 else 0)
        for i, path in enumerate(paths):
            split = "valid" if i < n_valid and "valid" in splits else "train"
            if split not in manifests:
                continue
            utt_id = spk + "--" + os.path.splitext(
                os.path.relpath(path, root))[0].replace(os.sep, "--")
            manifests[split][utt_id] = {
                "wav": path,
                "duration": round(len(read_audio(path)) / 16000.0, 3),
                "spk_id": spk,
            }
    for split, manifest in manifests.items():
        with open(out_paths[split], "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info(f"Prepared {out_paths[split]} ({len(manifest)} utterances)")
    if verification_pairs_file:
        prepare_trials(verification_pairs_file, root,
                       os.path.join(save_folder, "trials.json"))


def prepare_trials(pairs_file, root, save_path):
    """Write ``save_path``, a JSON list of ``{"label", "enrol", "test"}``
    from the ``<label> <enrol> <test>`` lines of ``pairs_file``, the two
    paths joined to ``root`` (pass ``wav_root(data_folder)``); other
    lines are skipped."""
    trials = []
    with open(pairs_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            label, enrol, test = parts
            trials.append({"label": int(label),
                           "enrol": os.path.join(root, enrol),
                           "test": os.path.join(root, test)})
    with open(save_path, "w") as f:
        json.dump(trials, f, indent=2)
    logger.info(f"Prepared {save_path} ({len(trials)} trials)")
