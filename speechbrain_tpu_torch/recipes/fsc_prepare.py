"""Fluent Speech Commands: the manifests of its recipes, and a synthetic
corpus in its layout.

``prepare_FSC`` is a copy of ``recipes/fluent-speech-commands/
prepare.py``: ``<data_folder>/data/{train,valid,test}_data.csv``
(``path``, ``transcription``, ``action``, ``object``, ``location``)
become ``<save_folder>/<split>.json`` (ids ``<split>_<row>``: ``wav``,
``semantics``, ``transcript``).  The semantics string is the JAX
script's, colon inside the first quote included (``{'action:' '...'|
'object': '...'| 'location': '...'}``, ``prepare.py:38-41``): the
tokenizer learns it as it is.
"""

import csv
import json
import logging
import os
import wave

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["prepare_FSC", "write_synthetic_fsc", "INTENTS"]


def prepare_FSC(data_folder, save_folder, skip_prep=False):
    """Write the train, valid and test manifests of the corpus at
    ``data_folder``; nothing when all three exist.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_fsc(d, {"train": 1, "valid": 1, "test": 1},
    ...                     seconds=(0.2, 0.3))
    >>> prepare_FSC(d, d + "/save")
    >>> row = json.load(open(d + "/save/train.json"))["train_0"]
    >>> row["semantics"].startswith("{'action:' '")
    True
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    outs = {s: os.path.join(save_folder, f"{s}.json")
            for s in ("train", "valid", "test")}
    if all(os.path.exists(p) for p in outs.values()):
        logger.info("Skipping preparation, completed in previous run.")
        return
    for split, out in outs.items():
        csv_path = os.path.join(data_folder, "data", f"{split}_data.csv")
        rows = {}
        with open(csv_path, newline="", encoding="utf-8") as f:
            for i, row in enumerate(csv.DictReader(f)):
                semantics = (
                    "{'action:' '%s'| 'object': '%s'| 'location': '%s'}"
                    % (row["action"], row["object"], row["location"]))
                rows[f"{split}_{i}"] = {
                    "wav": os.path.join(data_folder, row["path"]),
                    "semantics": semantics,
                    "transcript": row["transcription"],
                }
        with open(out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=2)
        logger.info("%s: %d utterances", out, len(rows))


# (action, object, location, transcription) of the corpus's kind
INTENTS = (
    ("activate", "lights", "kitchen", "Turn on the lights in the kitchen"),
    ("deactivate", "lights", "bedroom", "Switch off the bedroom lights"),
    ("increase", "volume", "none", "Turn the volume up"),
    ("decrease", "heat", "washroom", "Lower the heat in the washroom"),
    ("change language", "Chinese", "none", "Set my device to Chinese"),
    ("bring", "newspaper", "none", "Bring me the newspaper"),
    ("activate", "music", "none", "Play the music"),
    ("deactivate", "lamp", "none", "Lamp off"),
    ("bring", "juice", "none", "Get me some juice"),
    ("increase", "heat", "kitchen", "Make it warmer in the kitchen"),
)


def write_synthetic_fsc(folder, counts, seconds=(1.0, 3.0),
                        sample_rate=16000, seed=0):
    """Write a Fluent-Speech-Commands-shaped corpus of synthetic commands,
    for trying the recipes without it: ``counts`` maps 'train', 'valid'
    and 'test' to their numbers of rows of ``data/<split>_data.csv``
    (the corpus's columns: an unnamed index, ``path``, ``speakerId``,
    ``transcription``, ``action``, ``object``, ``location``), each a
    16-bit PCM WAV (noise and a tone lasting ``seconds``, uniform) under
    ``wavs/speakers/<speaker>/`` and one of ``INTENTS``.  Everything comes
    from ``seed``."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(folder, "data"), exist_ok=True)
    n = 0
    for split in ("train", "valid", "test"):
        with open(os.path.join(folder, "data", f"{split}_data.csv"), "w",
                  newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["", "path", "speakerId", "transcription",
                             "action", "object", "location"])
            for i in range(counts.get(split, 0)):
                speaker = f"spk{n % 4}"
                rel = f"wavs/speakers/{speaker}/utt{n:05d}.wav"
                os.makedirs(os.path.join(folder, os.path.dirname(rel)),
                            exist_ok=True)
                samples = int(rng.uniform(*seconds) * sample_rate)
                t = np.arange(samples) / sample_rate
                sig = (0.05 * rng.standard_normal(samples)
                       + 0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t))
                pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
                with wave.open(os.path.join(folder, rel), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sample_rate)
                    w.writeframes(pcm.tobytes())
                action, obj, location, text = INTENTS[
                    int(rng.integers(len(INTENTS)))]
                writer.writerow([i, rel, speaker, text, action, obj,
                                 location])
                n += 1
