"""Taigi (Taiwanese Hokkien) speech to Mandarin text: the manifests of the
speech translation recipes, and a synthetic corpus in the layout.

``prepare_taigi`` is a copy of ``recipes/Taigi/taigi_prepare.py``: the
corpus's ``data/text_mandarin`` (``<wav_id> <mandarin translation ...>``
a line; a line without a translation, or naming no ``wav/<wav_id>.wav``,
is left out) becomes ``<save_folder>/{train,dev,test}.json``
(``{id: {wav, duration, translation}}``: the words joined by single
spaces, the duration from the WAV header).  The rows are shuffled by
``random.Random(seed)`` and split 360000/72000/72000 (100 h/20 h/20 h),
or 80/10/10 when the corpus is smaller than those three together (dev
and test never empty).  Manifests that all exist are kept.
``write_synthetic_taigi`` writes such a corpus from a seed.
"""

import json
import logging
import os
import random
import wave

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["prepare_taigi", "write_synthetic_taigi", "TRAIN_SPLIT",
           "DEV_SPLIT", "TEST_SPLIT"]

SAMPLERATE = 16000
TRAIN_SPLIT = 360000
DEV_SPLIT = 72000
TEST_SPLIT = 72000


def prepare_taigi(dataset_folder, save_folder, seed=8886, skip_prep=False):
    """Write the train, dev and test manifests of the corpus at
    ``dataset_folder`` (which holds ``wav/`` and ``data/text_mandarin``),
    the split drawn from ``seed``.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_taigi(d, 10, seconds=(0.2, 0.3))
    >>> prepare_taigi(d, d + "/save")
    >>> [len(json.load(open(f"{d}/save/{s}.json")))
    ...  for s in ("train", "dev", "test")]
    [8, 1, 1]
    """
    if skip_prep:
        return
    wav_folder = os.path.join(dataset_folder, "wav")
    data_folder = os.path.join(dataset_folder, "data")
    if not (os.path.exists(wav_folder) and os.path.exists(data_folder)):
        logger.error("the folder wav or data does not exist (it is expected "
                     "in the Taigi dataset)")
    os.makedirs(save_folder, exist_ok=True)
    if all(os.path.exists(os.path.join(save_folder, s + ".json"))
           for s in ("train", "dev", "test")):
        logger.info("Taigi preparation already done, skipping.")
        return
    data = _extract_data(os.path.join(data_folder, "text_mandarin"),
                         wav_folder)
    random.Random(seed).shuffle(data)
    n_train, n_dev = TRAIN_SPLIT, DEV_SPLIT
    if len(data) < TRAIN_SPLIT + DEV_SPLIT + TEST_SPLIT:
        # smaller than the published splits (a subset): 80/10/10
        n_train = max(1, int(len(data) * 0.8))
        n_dev = max(1, int(len(data) * 0.1))
    splits = {
        "train": data[:n_train],
        "dev": data[n_train : n_train + n_dev],
        "test": data[n_train + n_dev :][:TEST_SPLIT],
    }
    for split, rows in splits.items():
        path = os.path.join(save_folder, split + ".json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({row_id: row for row_id, row in rows}, f, indent=2,
                      ensure_ascii=False)
        logger.info("%s: %d utterances", path, len(rows))


def _wav_duration_seconds(path):
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def _extract_data(text_path, wav_folder):
    """The index's rows ``(wav_id, {wav, duration, translation})``."""
    rows = []
    with open(text_path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            wav_id, translation = parts[0], " ".join(parts[1:])
            wav_path = os.path.join(wav_folder, wav_id + ".wav")
            if not os.path.exists(wav_path):
                continue
            rows.append((wav_id, {
                "wav": wav_path,
                "duration": _wav_duration_seconds(wav_path),
                "translation": translation,
            }))
    return rows


def write_synthetic_taigi(folder, count, seconds=(2.0, 6.0),
                          n_chars=(4, 20), n_distinct=300, seed=0):
    """Write a Taigi-shaped corpus of ``count`` synthetic utterances, for
    trying the recipes without it: ``wav/<id>.wav`` (16 kHz 16-bit PCM,
    noise plus two tones lasting ``seconds``, uniform) and
    ``data/text_mandarin``, whose translations are ``n_chars`` (uniform)
    of ``n_distinct`` CJK characters, a third of them cut into words by
    single or double spaces, plus one line without a translation and one
    naming a WAV that does not exist (``prepare_taigi`` leaves both out).
    Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    chars = [chr(0x4E00 + int(c))
             for c in rng.choice(20000, n_distinct, replace=False)]
    wav_dir = os.path.join(folder, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(os.path.join(folder, "data"), exist_ok=True)
    lines = []
    for i in range(count):
        utt = f"TAT-{i // 100:02d}-{i:05d}"
        samples = int(rng.uniform(*seconds) * SAMPLERATE)
        t = np.arange(samples) / SAMPLERATE
        f1, f2 = rng.uniform(100, 3000, 2)
        sig = (0.05 * rng.standard_normal(samples)
               + 0.2 * np.sin(2 * np.pi * f1 * t)
               + 0.1 * np.sin(2 * np.pi * f2 * t))
        pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
        with wave.open(os.path.join(wav_dir, utt + ".wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLERATE)
            w.writeframes(pcm.tobytes())
        text = "".join(rng.choice(chars, rng.integers(n_chars[0],
                                                     n_chars[1] + 1)))
        if i % 3 == 0 and len(text) > 2:
            cuts = sorted(rng.choice(np.arange(1, len(text)), 2,
                                     replace=False))
            text = (text[:cuts[0]] + " " + text[cuts[0]:cuts[1]]
                    + " " * int(rng.integers(1, 3)) + text[cuts[1]:])
        lines.append(f"{utt} {text}")
    lines.insert(count // 2, "TAT-99-untranslated")
    lines.append(f"TAT-99-missing {chars[0]}{chars[1]}")
    with open(os.path.join(folder, "data", "text_mandarin"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
