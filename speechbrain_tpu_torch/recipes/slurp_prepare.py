"""SLURP: the manifests of its recipes, and a synthetic corpus in its
layout.

``prepare_SLURP`` is a copy of ``recipes/SLURP/prepare.py``: the
annotation files ``<data_folder>/<split>.jsonl`` (one utterance a line:
``sentence``, ``sentence_annotation`` with ``[type : filler]`` spans,
``scenario``, ``action``, ``recordings``) become
``<save_folder>/{train,devel,test}.json`` (one row a recording found
under ``slurp_real/``, or ``slurp_synth/`` for a split named
"synthetic": ``wav``, ``duration``, ``transcript`` and ``semantics``,
the dict ``{'scenario', 'action', 'entities'}`` as Python prints it with
its commas swapped for ``|``); the train manifest merges
``train_splits``, whose default is ``("train",)`` alone, as in JAX: the
``direct`` and ``NLU`` scripts pass none, so ``train_synthetic`` is left
out of their training.  It differs from the JAX script in one place: a
recording's duration is its sample count over the file's own rate,
where the JAX script divides by 16000 whatever the rate
(``prepare.py:80-82``).
"""

import json
import logging
import os
import wave

import numpy as np

from ..dataio.dataio import _load_audio_any

logger = logging.getLogger(__name__)

__all__ = ["parse_entities", "prepare_SLURP", "write_synthetic_slurp"]


def parse_entities(sentence_annotation):
    """``[type : filler]`` spans -> a list of ``{"type", "filler"}``.

    Example
    -------
    >>> parse_entities("wake me at [time : five am]")
    [{'type': 'time', 'filler': 'five am'}]
    """
    entities = []
    for chunk in sentence_annotation.split("[")[1:]:
        body = chunk.split("]")[0]
        if ":" not in body:
            continue
        etype, filler = body.split(":", 1)
        entities.append({"type": etype.strip(), "filler": filler.strip()})
    return entities


def prepare_SLURP(data_folder, save_folder, slu_type="direct",
                  train_splits=("train",), skip_prep=False):
    """Write the train, devel and test manifests of the corpus at
    ``data_folder`` (a manifest that exists is kept; a missing jsonl
    raises).  ``slu_type`` is unused, as in JAX.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_slurp(d, {"train": 2, "devel": 1, "test": 1},
    ...                       seconds=(0.2, 0.3))
    >>> prepare_SLURP(d, d + "/save")
    >>> row = next(iter(json.load(open(d + "/save/train.json")).values()))
    >>> row["semantics"].startswith("{'scenario': ")
    True
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    jobs = [("train", list(train_splits)), ("devel", ["devel"]),
            ("test", ["test"])]
    for out_name, splits in jobs:
        out = os.path.join(save_folder, f"{out_name}.json")
        if os.path.exists(out):
            continue
        manifest = {}
        for split in splits:
            jsonl_path = os.path.join(data_folder, split + ".jsonl")
            if not os.path.isfile(jsonl_path):
                raise FileNotFoundError(f"Missing {jsonl_path}")
            audio_folder = ("slurp_synth" if "synthetic" in split
                            else "slurp_real")
            with open(jsonl_path) as f:
                for line in f:
                    obj = json.loads(line)
                    semantics = str({
                        "scenario": obj["scenario"],
                        "action": obj["action"],
                        "entities": parse_entities(
                            obj.get("sentence_annotation", "")),
                    }).replace(",", "|")
                    for rec in obj["recordings"]:
                        path = os.path.join(data_folder, audio_folder,
                                            rec["file"])
                        if not os.path.exists(path):
                            continue
                        audio, rate = _load_audio_any(path)
                        manifest[os.path.splitext(rec["file"])[0]] = {
                            "wav": path,
                            "duration": round(len(audio) / rate, 3),
                            "transcript": obj["sentence"],
                            "semantics": semantics,
                        }
        with open(out, "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info(f"Prepared {out} ({len(manifest)} utterances)")


# (scenario, action, annotated sentence) of the corpus's kind
_UTTERANCES = (
    ("alarm", "set", "wake me up at [time : five am] this week"),
    ("alarm", "query", "what alarms do i have [date : tomorrow]"),
    ("weather", "query", "what is the weather like in [place_name : paris]"),
    ("music", "play", "play some [music_genre : jazz] please"),
    ("calendar", "set", "remind me of the [event_name : meeting] at "
                        "[time : noon]"),
    ("iot", "hue_lightoff", "turn the lights off in the [house_place : "
                            "kitchen]"),
    ("news", "query", "what are the news from [media_type : bbc]"),
    ("general", "quirky", "tell me something funny"),
)


def write_synthetic_slurp(folder, counts, seconds=(1.0, 3.0),
                          recordings=(1, 2), sample_rate=16000, seed=0):
    """Write a SLURP-shaped corpus of synthetic utterances, for trying the
    recipes without it: ``counts`` maps a split ('train', 'devel',
    'test', 'train_synthetic') to its number of lines of
    ``<split>.jsonl`` (``slurpid``, ``sentence``, ``sentence_annotation``,
    ``scenario``, ``action``, ``intent``, ``recordings``), each with
    ``recordings`` (uniform) 16-bit PCM WAVs (noise and a tone lasting
    ``seconds``, uniform) under ``slurp_real/`` (``slurp_synth/`` for the
    synthetic split).  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    n = 0
    for split in sorted(counts):
        audio_folder = os.path.join(
            folder, "slurp_synth" if "synthetic" in split else "slurp_real")
        os.makedirs(audio_folder, exist_ok=True)
        with open(os.path.join(folder, split + ".jsonl"), "w") as f:
            for i in range(counts[split]):
                scenario, action, annotation = _UTTERANCES[
                    int(rng.integers(len(_UTTERANCES)))]
                sentence = annotation
                for entity in parse_entities(annotation):
                    sentence = sentence.replace(
                        f"[{entity['type']} : {entity['filler']}]",
                        entity["filler"])
                recs = []
                for _ in range(int(rng.integers(recordings[0],
                                                recordings[1] + 1))):
                    name = f"audio-{1400000000 + n}-headset.wav"
                    samples = int(rng.uniform(*seconds) * sample_rate)
                    t = np.arange(samples) / sample_rate
                    sig = (0.05 * rng.standard_normal(samples)
                           + 0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000)
                                          * t))
                    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
                    with wave.open(os.path.join(audio_folder, name),
                                   "wb") as w:
                        w.setnchannels(1)
                        w.setsampwidth(2)
                        w.setframerate(sample_rate)
                        w.writeframes(pcm.tobytes())
                    recs.append({"file": name, "wer": 0.0, "ent_wer": 0.0})
                    n += 1
                f.write(json.dumps({
                    "slurpid": i, "sentence": sentence,
                    "sentence_annotation": annotation, "intent":
                    f"{scenario}_{action}", "action": action,
                    "scenario": scenario, "recordings": recs}) + "\n")
