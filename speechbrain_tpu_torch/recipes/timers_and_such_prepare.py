"""Timers and Such: the manifests of its recipes, and a synthetic corpus
in its layout.

``prepare_TAS`` is a copy of ``recipes/timers-and-such/prepare.py``: the
corpus's per-split CSVs (``{train-synth,train-real,dev-real,test-real,
dev-synth,test-synth}.csv`` with ``path``, ``transcription`` and
``semantics`` columns) become JSON manifests ``<split>.json`` (ids
``<split>_<row>``: ``wav``, ``semantics`` with its commas swapped for
``|``, ``transcript``), and the splits of ``train_splits`` are merged
into ``train.json``.  The LM recipe reads the transcripts; the spoken
language understanding recipes read the rest.
"""

import csv
import json
import logging
import os
import wave

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ALL_SPLITS", "prepare_TAS", "write_synthetic_tas"]

ALL_SPLITS = (
    "train-synth", "train-real",
    "dev-synth", "dev-real",
    "test-synth", "test-real",
)


def prepare_TAS(data_folder, save_folder, train_splits, skip_prep=False):
    """Write ``<save_folder>/<split>.json`` for each split whose CSV is in
    ``data_folder`` (a missing one is skipped with a warning) and
    ``train.json``, the ``train_splits`` merged; nothing when
    ``train.json`` exists.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_tas(d, {"train-synth": 2, "dev-real": 1},
    ...                     seconds=(0.2, 0.3))
    >>> prepare_TAS(d, d + "/save", ["train-synth", "train-real"])
    >>> m = json.load(open(d + "/save/train.json"))
    >>> sorted(m), "," in m["train-synth_0"]["semantics"]
    (['train-synth_0', 'train-synth_1'], False)
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    train_out = os.path.join(save_folder, "train.json")
    if os.path.exists(train_out):
        logger.info("Skipping preparation, completed in previous run.")
        return
    split_rows = {}
    for split in ALL_SPLITS:
        csv_path = os.path.join(data_folder, split + ".csv")
        if not os.path.exists(csv_path):
            logger.warning("%s missing, skipping split", csv_path)
            continue
        rows = {}
        with open(csv_path, newline="", encoding="utf-8") as f:
            for i, row in enumerate(csv.DictReader(f)):
                rows[f"{split}_{i}"] = {
                    "wav": os.path.join(data_folder, row["path"]),
                    "semantics": row["semantics"].replace(",", "|"),
                    "transcript": row["transcription"],
                }
        split_rows[split] = rows
        out = os.path.join(save_folder, split + ".json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=2)
        logger.info("%s: %d utterances", out, len(rows))
    train = {}
    for split in train_splits:
        train.update(split_rows.get(split, {}))
    with open(train_out, "w", encoding="utf-8") as f:
        json.dump(train, f, indent=2)
    logger.info("%s: %d utterances", train_out, len(train))


_NUMBERS = ("one", "two", "three", "four", "five", "six", "seven", "eight",
            "nine", "ten", "eleven", "twelve", "fifteen", "twenty", "thirty")
_UNITS = ("minutes", "seconds", "hours")
_INTENTS = (
    ("SetTimer", "set a timer for {n} {u}"),
    ("SetAlarm", "set an alarm for {n} {ampm}"),
    ("SimpleMath", "what is {n} plus {m}"),
    ("UnitConversion", "how many {u} are in {n} hours"),
)


def _command(rng):
    """A transcript and its semantics (the corpus's python-dict string)."""
    i = int(rng.integers(len(_INTENTS)))
    intent, template = _INTENTS[i]
    n, m = (str(x) for x in rng.choice(_NUMBERS, 2))
    u = str(rng.choice(_UNITS))
    ampm = str(rng.choice(("am", "pm")))
    text = template.format(n=n, m=m, u=u, ampm=ampm)
    slots = {"SetTimer": {"number": n, "unit": u},
             "SetAlarm": {"number": n, "am_or_pm": ampm},
             "SimpleMath": {"number1": n, "number2": m, "op": "plus"},
             "UnitConversion": {"unit1": u, "unit2": "hours", "number": n},
             }[intent]
    return text, str({"intent": intent, "slots": slots})


def write_synthetic_tas(folder, counts, seconds=(1.0, 3.0), sample_rate=16000,
                        seed=0):
    """Write a Timers-and-Such-shaped corpus of synthetic commands, for
    trying the recipes without it: ``counts`` maps a split of
    ``ALL_SPLITS`` to its number of rows; each row is a 16-bit PCM WAV
    (noise and a tone lasting ``seconds``, uniform) under
    ``<split>/``, and a line of ``<split>.csv`` (``ID``, ``path``
    relative to ``folder``, ``semantics``, ``transcription``,
    ``speakerId``): one of four intents with numbers and units drawn
    from small word lists.  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    for split, n in sorted(counts.items()):
        os.makedirs(os.path.join(folder, split), exist_ok=True)
        with open(os.path.join(folder, split + ".csv"), "w", newline="",
                  encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["ID", "path", "semantics", "transcription",
                             "speakerId"])
            for i in range(n):
                path = f"{split}/{split}-{i:04d}.wav"
                samples = int(rng.uniform(*seconds) * sample_rate)
                t = np.arange(samples) / sample_rate
                sig = (0.05 * rng.standard_normal(samples)
                       + 0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t))
                pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
                with wave.open(os.path.join(folder, path), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sample_rate)
                    w.writeframes(pcm.tobytes())
                text, semantics = _command(rng)
                writer.writerow([i, path, semantics, text, f"spk{i % 4}"])
