"""DVoice (African low-resource languages): the manifests of its wav2vec
recipe, and a synthetic corpus in its layout.

``prepare_dvoice`` is a copy of ``recipes/DVoice/dvoice_prepare.py``: one
language's ``<data_folder>/texts/{train,dev,test}.csv`` (tab-separated,
with ``wav`` and ``words`` columns) and its audio under
``<data_folder>/wavs/`` become ``<save_folder>/{train,dev,test}.json``
(``{<split>_<row>: {wav, duration, words}}``, the duration from the WAV
header rounded to 3 decimals; a row whose file is missing is left out;
nothing is written when all three exist).  ``write_synthetic_dvoice``
writes such a folder from a seed.
"""

import csv
import json
import logging
import os
import wave

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["prepare_dvoice", "write_synthetic_dvoice"]

SAMPLERATE = 16000
SPLITS = ("train", "dev", "test")


def prepare_dvoice(data_folder, save_folder, skip_prep=False):
    """Write the train, dev and test manifests of one DVoice language.

    Example
    -------
    >>> import tempfile
    >>> root = tempfile.mkdtemp()
    >>> write_synthetic_dvoice(root + "/darija", {"train": 2, "dev": 1,
    ...                        "test": 1}, seconds=(0.2, 0.3))
    >>> prepare_dvoice(root + "/darija", root + "/save")
    >>> import json
    >>> len(json.load(open(root + "/save/train.json")))
    2
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    outs = {s: os.path.join(save_folder, f"{s}.json") for s in SPLITS}
    if all(os.path.exists(p) for p in outs.values()):
        logger.info("Skipping preparation, completed in previous run.")
        return
    for split, out in outs.items():
        csv_path = os.path.join(data_folder, "texts", f"{split}.csv")
        rows = {}
        with open(csv_path, newline="", encoding="utf-8") as f:
            for i, row in enumerate(csv.DictReader(f, delimiter="\t")):
                wav = os.path.join(data_folder, "wavs", row["wav"])
                if not os.path.exists(wav):
                    continue
                with wave.open(wav, "rb") as w:
                    duration = w.getnframes() / w.getframerate()
                rows[f"{split}_{i}"] = {
                    "wav": wav,
                    "duration": round(duration, 3),
                    "words": row["words"],
                }
        with open(out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=2, ensure_ascii=False)
        logger.info("%s: %d utterances", out, len(rows))


# Latin letters with some of the accented ones DVoice's transcripts hold
_LETTERS = "abcdefghijklmnopqrstuvwxyzéèàɛɔŋ"


def write_synthetic_dvoice(folder, counts, seconds=(1.0, 3.0),
                           n_words=(2, 6), lexicon_size=40, missing=0,
                           seed=0):
    """Write one DVoice language's folder of synthetic utterances, for
    trying the recipes without the corpus: ``counts`` maps 'train', 'dev'
    and 'test' to their numbers of rows of ``texts/<split>.csv``, each a
    16 kHz 16-bit PCM WAV under ``wavs/`` (noise plus two tones lasting
    ``seconds``, uniform) with ``n_words`` words (uniform) from a lexicon
    of ``lexicon_size`` lowercase words.  Each split's table also lists
    ``missing`` files that are not written.  Everything comes from
    ``seed``."""
    rng = np.random.default_rng(seed)
    lexicon = ["".join(rng.choice(list(_LETTERS), rng.integers(2, 8)))
               for _ in range(lexicon_size)]
    os.makedirs(os.path.join(folder, "wavs"), exist_ok=True)
    os.makedirs(os.path.join(folder, "texts"), exist_ok=True)
    for split in SPLITS:
        rows = []
        for i in range(counts.get(split, 0) + missing):
            name = f"{split}_{i:05d}.wav"
            words = " ".join(rng.choice(lexicon, rng.integers(
                n_words[0], n_words[1] + 1)))
            rows.append((name, words))
            if i >= counts.get(split, 0):
                continue
            samples = int(rng.uniform(*seconds) * SAMPLERATE)
            t = np.arange(samples) / SAMPLERATE
            f1, f2 = rng.uniform(100, 3000, 2)
            sig = (0.05 * rng.standard_normal(samples)
                   + 0.2 * np.sin(2 * np.pi * f1 * t)
                   + 0.1 * np.sin(2 * np.pi * f2 * t))
            pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
            with wave.open(os.path.join(folder, "wavs", name), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLERATE)
                w.writeframes(pcm.tobytes())
        with open(os.path.join(folder, "texts", f"{split}.csv"), "w",
                  newline="", encoding="utf-8") as f:
            writer = csv.writer(f, delimiter="\t")
            writer.writerow(["wav", "words"])
            writer.writerows(rows)
