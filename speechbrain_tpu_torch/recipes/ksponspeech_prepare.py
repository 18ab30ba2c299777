"""KsponSpeech (Korean conversational speech): the manifests of its
recipes, the conversion of its raw audio, and a synthetic corpus in its
layout.

``prepare_ksponspeech`` is a copy of
``recipes/KsponSpeech/ksponspeech_prepare.py``: the splits ``train``
(``train/KsponSpeech_0{1..5}/KsponSpeech_{0001..0620}``), ``dev``
(``train/KsponSpeech_05/KsponSpeech_{0621..0623}``), ``eval_clean`` and
``eval_other`` (``test/<split>``) become ``<save_folder>/<split>.json``
(``{id: {wav, duration, spk_id, wrd}}``), the transcripts read from
``train.trn`` (train and dev) or ``<split>.trn`` (``<path> :: <raw
text>`` a line) and normalized by ``normalize``.  ``convert_to_wav`` is
``recipes/KsponSpeech/convert_to_wav.py``'s: the corpus ships headerless
16 kHz 16-bit mono PCM (``.pcm``), which the manifests read as ``.wav``
beside it.  ``write_synthetic_kspon`` writes such a corpus (``.pcm`` files
and ``.trn`` indexes) from a seed.
"""

import json
import logging
import os
import re
import wave
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["SAMPLERATE", "prepare_ksponspeech", "create_json", "text_to_dict",
           "normalize", "split2dirs", "convert_to_wav", "convert_all",
           "write_synthetic_kspon"]

SAMPLERATE = 16000


def prepare_ksponspeech(data_folder, save_folder, tr_splits=(),
                        dev_splits=(), te_splits=(), select_n_sentences=None,
                        merge_lst=(), merge_name=None, skip_prep=False):
    """Write one manifest per split of ``tr_splits + dev_splits +
    te_splits`` (names from 'train', 'dev', 'eval_clean', 'eval_other');
    nothing when all of them exist.  ``select_n_sentences`` caps each
    split's files (in sorted order) before the ones without a transcript
    are dropped; ``merge_lst`` splits are also merged into
    ``merge_name``.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_kspon(d, {"dev": 2}, seconds=(0.2, 0.3))
    >>> convert_all(d)
    >>> prepare_ksponspeech(d, d + "/save", dev_splits=["dev"])
    >>> sorted(json.load(open(d + "/save/dev.json")))
    ['KsponSpeech_620001', 'KsponSpeech_620002']
    """
    if skip_prep:
        return
    splits = list(tr_splits) + list(dev_splits) + list(te_splits)
    os.makedirs(save_folder, exist_ok=True)
    if all(os.path.exists(os.path.join(save_folder, s + ".json"))
           for s in splits):
        logger.info("Skipping preparation, completed in previous run.")
        return
    for split_index, split in enumerate(splits):
        trn = "train.trn" if split in ("train", "dev") else split + ".trn"
        text_dict = text_to_dict(os.path.join(data_folder, trn))
        wav_lst = []
        for d in split2dirs(split):
            for dirpath, _, files in os.walk(os.path.join(data_folder, d)):
                wav_lst += [os.path.join(dirpath, f) for f in files
                            if f.endswith(".wav")]
        wav_lst.sort()
        n = len(wav_lst)
        if select_n_sentences is not None:
            n = select_n_sentences[split_index]
        create_json(save_folder, wav_lst, text_dict, split, n)
    if merge_lst and merge_name is not None:
        merged = {}
        for split in merge_lst:
            with open(os.path.join(save_folder, split + ".json"),
                      encoding="utf-8") as f:
                merged.update(json.load(f))
        with open(os.path.join(save_folder, merge_name), "w",
                  encoding="utf-8") as f:
            json.dump(merged, f, indent=2, ensure_ascii=False)


def create_json(save_folder, wav_lst, text_dict, split, n_sentences):
    """Write one split's manifest from the first ``n_sentences`` files of
    ``wav_lst`` that have a transcript in ``text_dict``."""
    path = os.path.join(save_folder, split + ".json")
    rows = {}
    for wav_file in wav_lst[:n_sentences]:
        snt_id = os.path.basename(wav_file).replace(".wav", "")
        if snt_id not in text_dict:
            continue
        with wave.open(wav_file, "rb") as w:
            duration = w.getnframes() / w.getframerate()
        rows[snt_id] = {
            "wav": wav_file,
            "duration": round(duration, 3),
            "spk_id": snt_id.split("_")[-1],
            "wrd": " ".join(text_dict[snt_id].split()),
        }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, indent=2, ensure_ascii=False)
    logger.info("%s successfully created (%d rows)!", path, len(rows))


def text_to_dict(trnpath):
    """A ``.trn`` index -> {utterance id: normalized text}; lines without
    `` :: `` are skipped."""
    text_dict = {}
    with open(trnpath, encoding="utf-8") as f:
        for line in f:
            if " :: " not in line:
                continue
            filename, raw = line.split(" :: ", 1)
            file_id = (os.path.basename(filename.strip())
                       .replace(".pcm", "").replace(".wav", ""))
            text_dict[file_id] = normalize(raw)
    return text_dict


def normalize(string):
    """KsponSpeech's transcript normalization: the orthographic side of
    each ``(orth)/(phon)`` pair, the ``n/ b/ o/ l/ u/`` non-speech markers
    removed, ``+ * / . ? ! ,`` stripped, whitespace collapsed.

    Example
    -------
    >>> normalize("o/ (70%)/(칠십 퍼센트) 정도 b/ 했어요? +")
    '70% 정도 했어요'
    """
    string = re.sub(r"\(([^)]*)\)\/\(([^)]*)\)", r"\1", string)
    string = re.sub(r"n/|b/|o/|l/|u/", "", string)
    string = re.sub(r"[+*/.?!,]", "", string)
    string = re.sub(r"\s+", " ", string)
    return string.strip()


def split2dirs(split):
    """The corpus directories that hold a split's audio."""
    if split not in ("eval_other", "eval_clean", "train", "dev"):
        raise ValueError("Unsupported data split")
    if "eval" in split:
        return ["test/" + split]
    if split == "dev":
        return ["train/KsponSpeech_05/KsponSpeech_{0:>04d}".format(n)
                for n in range(621, 624)]
    dirs = []
    for part, lo, hi in ((1, 1, 125), (2, 125, 249), (3, 249, 373),
                         (4, 373, 497), (5, 497, 621)):
        dirs += ["train/KsponSpeech_{0:>02d}/KsponSpeech_{1:>04d}".format(
            part, n) for n in range(lo, hi)]
    return dirs


def convert_to_wav(filepath):
    """Wrap one raw PCM file (16 kHz, 16-bit, mono) in a WAV header, as
    ``<name>.wav`` beside it."""
    filepath = Path(filepath)
    with open(filepath, "rb") as r:
        data = r.read()
    with wave.open(str(filepath.with_suffix(".wav")), "wb") as w:
        w.setparams((1, 2, SAMPLERATE, 0, "NONE", "NONE"))
        w.writeframes(data)


def convert_all(dirpath):
    """``convert_to_wav`` on every ``.pcm`` under ``dirpath`` (the
    script's ``main``, in one process)."""
    for path in sorted(Path(dirpath).glob("**/*.pcm")):
        convert_to_wav(path)


# where write_synthetic_kspon puts each split's audio and which index
# lists it
_LAYOUT = {
    "train": ("train/KsponSpeech_01/KsponSpeech_0001", "train.trn", 0),
    "dev": ("train/KsponSpeech_05/KsponSpeech_0621", "train.trn", 620000),
    "eval_clean": ("test/eval_clean", "eval_clean.trn", None),
    "eval_other": ("test/eval_other", "eval_other.trn", None),
}


def _korean_word(rng):
    syllables = rng.integers(0xAC00, 0xD7A4, rng.integers(1, 4))
    return "".join(chr(int(c)) for c in syllables)


def _raw_transcript(rng, lexicon, n_words):
    """A transcript in the corpus's raw form: words from ``lexicon`` with
    ``(orth)/(phon)`` pairs, non-speech markers and punctuation."""
    out = []
    for _ in range(rng.integers(n_words[0], n_words[1] + 1)):
        word = str(rng.choice(lexicon))
        r = rng.random()
        if r < 0.1:
            word = f"({word})/({rng.choice(lexicon)})"
        elif r < 0.2:
            word = f"{rng.choice(['n/', 'b/', 'o/', 'l/', 'u/'])} {word}"
        elif r < 0.3:
            word += str(rng.choice(["+", "*", ".", "?", "!", ","]))
        out.append(word)
    return " ".join(out)


def write_synthetic_kspon(folder, counts, seconds=(2.0, 6.0),
                          n_words=(3, 10), lexicon_size=200, seed=0):
    """Write a KsponSpeech-shaped corpus of synthetic utterances, for
    trying the recipes without it: ``counts`` maps a split name ('train',
    'dev', 'eval_clean', 'eval_other') to its number of utterances, each
    a headerless 16 kHz 16-bit PCM file (``.pcm``, noise plus two tones
    lasting ``seconds``, uniform) listed with a raw transcript of
    ``n_words`` words (uniform) from a lexicon of ``lexicon_size`` Hangul
    words in ``train.trn`` (train and dev) or ``<split>.trn``, with the
    corpus's ``(A)/(B)`` pairs, ``n/ b/ o/ l/ u/`` markers and
    punctuation.  Run ``convert_all`` on the folder before
    ``prepare_ksponspeech``.  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    lexicon = sorted({_korean_word(rng) for _ in range(lexicon_size)})
    indexes = {}
    for split, n in sorted(counts.items()):
        subdir, trn, first = _LAYOUT[split]
        os.makedirs(os.path.join(folder, subdir), exist_ok=True)
        for i in range(1, n + 1):
            name = (f"KsponSpeech_{first + i:06d}" if first is not None
                    else f"KsponSpeech_E{i:05d}")
            samples = int(rng.uniform(*seconds) * SAMPLERATE)
            t = np.arange(samples) / SAMPLERATE
            f1, f2 = rng.uniform(100, 3000, 2)
            sig = (0.05 * rng.standard_normal(samples)
                   + 0.2 * np.sin(2 * np.pi * f1 * t)
                   + 0.1 * np.sin(2 * np.pi * f2 * t))
            pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
            with open(os.path.join(folder, subdir, name + ".pcm"), "wb") as f:
                f.write(pcm.tobytes())
            listed = (subdir.split("/", 1)[1] if first is not None
                      else "KsponSpeech_eval/" + split)
            indexes.setdefault(trn, []).append(
                f"{listed}/{name}.pcm :: "
                f"{_raw_transcript(rng, lexicon, n_words)}")
    for trn, lines in indexes.items():
        with open(os.path.join(folder, trn), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
