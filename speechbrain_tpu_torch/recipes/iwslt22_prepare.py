"""IWSLT 2022 low-resource speech translation (Tamasheq -> French): the
manifests of its recipe, and a synthetic corpus in its layout.

``data_proc`` is a copy of ``recipes/IWSLT22_lowresource/
prepare_iwslt22.py``: a corpus folder's ``<split>.yaml`` (one
``{duration: d, offset: o, speaker_id: s, wav: path}`` line a segment,
``wav`` relative to the folder) and ``<split>.fra`` (the French
translations, a line each, in the same order) become
``<output_folder>/<split>.json`` (``{id: {wav, duration, trans}}``) for
the splits train, valid and test; a manifest that exists is kept.  As in
the JAX script, a row's id is its wav's basename, so two rows naming one
wav (two segments of one recording, at two offsets) collapse into the
last of them, and the offset is not read: a row is its whole file.
``write_synthetic_iwslt22`` writes such a folder from a seed.
"""

import json
import logging
import os
import re
import wave

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["data_proc", "write_synthetic_iwslt22"]

SAMPLERATE = 16000
SPLITS = ("train", "valid", "test")


def data_proc(dataset_folder, output_folder):
    """Write ``{train,valid,test}.json`` from the corpus's index files.

    Example
    -------
    >>> import tempfile
    >>> root = tempfile.mkdtemp()
    >>> write_synthetic_iwslt22(root + "/iwslt", {"train": 3, "valid": 1,
    ...                         "test": 1}, seconds=(0.2, 0.3), shared=1)
    >>> data_proc(root + "/iwslt", root + "/save")
    >>> len(json.load(open(root + "/save/train.json")))
    3
    """
    os.makedirs(output_folder, exist_ok=True)
    for split in SPLITS:
        out = os.path.join(output_folder, split + ".json")
        if os.path.exists(out):
            continue
        index_path = os.path.join(dataset_folder, split + ".yaml")
        fra_path = os.path.join(dataset_folder, split + ".fra")
        with open(index_path, encoding="utf-8") as f:
            entries = [line for line in f if line.strip()]
        with open(fra_path, encoding="utf-8") as f:
            translations = [line.strip() for line in f if line.strip()]
        assert len(entries) == len(translations), (
            f"{index_path} and {fra_path} disagree in length")
        rows = {}
        for entry, trans in zip(entries, translations):
            wav = entry.split(", wav: ")[1].split("}")[0].strip()
            duration = float(
                re.search(r"duration:\s*([0-9.]+)", entry).group(1))
            utt_id = os.path.splitext(os.path.basename(wav))[0]
            rows[utt_id] = {
                "wav": os.path.join(dataset_folder, wav),
                "duration": duration,
                "trans": trans,
            }
        with open(out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=2, ensure_ascii=False)
        logger.info("%s: %d utterances", out, len(rows))


_FRENCH = ("le", "la", "les", "un", "une", "de", "des", "et", "à", "il",
           "elle", "nous", "vous", "ils", "est", "sont", "a", "ont", "dans",
           "pour", "avec", "sur", "pas", "très", "été", "fait", "dit",
           "eau", "désert", "troupeau", "chameaux", "puits", "village",
           "marché", "école", "enfants", "famille", "pluie", "année",
           "aujourd'hui", "demain", "hier", "beaucoup", "où", "ça", "même")


def write_synthetic_iwslt22(folder, counts, seconds=(2.0, 8.0),
                            n_words=(4, 14), shared=0, seed=0):
    """Write a corpus folder of synthetic segments, for trying the recipe
    without the corpus: ``counts`` maps 'train', 'valid' and 'test' to
    their numbers of recordings, each a 16 kHz 16-bit PCM WAV under
    ``wav/<split>/`` (noise plus two tones lasting ``seconds``, uniform)
    listed in ``<split>.yaml`` at offset 0 with a translation of
    ``n_words`` (uniform) French words in ``<split>.fra``.  Each split
    lists ``shared`` more segments of its last recordings, at an offset
    of half their duration (the preparation keeps one row a recording).
    Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    for split in SPLITS:
        os.makedirs(os.path.join(folder, "wav", split), exist_ok=True)
        index, fra = [], []
        recordings = []
        for i in range(counts.get(split, 0)):
            rel = f"wav/{split}/{split}_{i:05d}.wav"
            samples = int(rng.uniform(*seconds) * SAMPLERATE)
            t = np.arange(samples) / SAMPLERATE
            f1, f2 = rng.uniform(100, 3000, 2)
            sig = (0.05 * rng.standard_normal(samples)
                   + 0.2 * np.sin(2 * np.pi * f1 * t)
                   + 0.1 * np.sin(2 * np.pi * f2 * t))
            pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
            with wave.open(os.path.join(folder, rel), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLERATE)
                w.writeframes(pcm.tobytes())
            recordings.append((rel, samples / SAMPLERATE, 0.0))
        for rel, duration, _ in recordings[len(recordings) - shared:]:
            recordings.append((rel, duration / 2, duration / 2))
        for rel, duration, offset in recordings:
            spk = f"spk{int(rng.integers(1, 5))}"
            index.append(f"- {{duration: {duration:.6f}, offset: "
                         f"{offset:.6f}, speaker_id: {spk}, wav: {rel}}}")
            fra.append(" ".join(rng.choice(_FRENCH, int(rng.integers(
                n_words[0], n_words[1] + 1)))))
        with open(os.path.join(folder, f"{split}.yaml"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(index) + "\n")
        with open(os.path.join(folder, f"{split}.fra"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(fra) + "\n")
