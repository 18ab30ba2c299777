"""CommonVoice: the manifests of its recipes, and a synthetic corpus in
its layout.

``prepare_common_voice`` is a copy of ``recipes/CommonVoice/
common_voice_prepare.py``: each split's tsv (``path`` names a clip of
``<data_folder>/clips/``; a ``.wav`` beside it is read instead) becomes
``<save_folder>/{train,dev,test}.json`` (``{id: {wav, duration,
words}}``, the sentence through ``clean_transcript``; a row whose clip
is missing or whose cleaned sentence is empty is left out, and train
clips longer than ``duration_threshold`` seconds too; a manifest that
exists is kept).  It differs from the JAX script in one place: a clip's
duration is its sample count over the file's own rate, where the JAX
script divides by 16000 whatever the rate (``common_voice_prepare.py:
84-90``), so a 48 kHz clip of 4 s read as 12 s there and fell to the
10 s train filter.  A clip that neither package can decode (an ``.mp3``
with no ``.wav`` beside it) keeps the JAX script's estimate, its size in
bytes over 16000.

``write_synthetic_common_voice`` writes such a corpus from a seed: the
tsv files and ``clips/``, each ``.mp3`` of the tsv with its ``.wav``
beside it, the sentences in the language's words with punctuation,
apostrophes and its accented letters.
"""

import csv
import json
import logging
import os
import re
import unicodedata
import wave

import numpy as np

from ..dataio.dataio import _load_audio_any

logger = logging.getLogger(__name__)

__all__ = ["clean_transcript", "prepare_common_voice",
           "write_synthetic_common_voice", "LEXICONS"]


def clean_transcript(words, language="en", accented_letters=False):
    """Upper case, punctuation (all but apostrophes) to spaces, accents
    folded to ASCII unless ``accented_letters``, runs of spaces to one.
    ``language`` changes nothing, as in JAX (``common_voice_prepare.py:
    21-38``).

    Example
    -------
    >>> clean_transcript("Hello, world!")
    'HELLO WORLD'
    >>> clean_transcript("L'été, où?", "fr", accented_letters=True)
    "L'ÉTÉ OÙ"
    """
    words = words.upper()
    words = re.sub(r"[^\w\s']", " ", words, flags=re.UNICODE)
    if not accented_letters:
        words = (unicodedata.normalize("NFKD", words)
                 .encode("ascii", "ignore").decode("ascii"))
    return " ".join(words.split())


def _duration(path):
    """Seconds of audio at the file's own rate; for a file the port cannot
    decode, the JAX script's estimate (bytes / 16000)."""
    try:
        audio, rate = _load_audio_any(path)
    except ValueError:
        return round(os.path.getsize(path) / 16000.0, 3)
    return round(len(audio) / rate, 3)


def prepare_common_voice(data_folder, save_folder, train_tsv_file=None,
                         dev_tsv_file=None, test_tsv_file=None,
                         accented_letters=False, language="en",
                         skip_prep=False, duration_threshold=10.0):
    """Write the train, dev and test manifests of the CommonVoice language
    folder ``data_folder`` (``clips/`` and the tsv files; each tsv path
    defaults to ``<data_folder>/<split>.tsv``).

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_common_voice(d, {"train": 2, "dev": 1, "test": 1},
    ...                              seconds=(0.2, 0.3))
    >>> prepare_common_voice(d, d + "/save")
    >>> sorted(json.load(open(d + "/save/train.json")))
    ['common_voice_en_00000000', 'common_voice_en_00000001']
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    jobs = [
        ("train", train_tsv_file or os.path.join(data_folder, "train.tsv")),
        ("dev", dev_tsv_file or os.path.join(data_folder, "dev.tsv")),
        ("test", test_tsv_file or os.path.join(data_folder, "test.tsv")),
    ]
    for split, tsv in jobs:
        out = os.path.join(save_folder, f"{split}.json")
        if os.path.exists(out):
            continue
        manifest = {}
        with open(tsv, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f, delimiter="\t"):
                clip = row["path"]
                wav = os.path.join(data_folder, "clips", clip)
                wav_alt = os.path.splitext(wav)[0] + ".wav"
                if os.path.exists(wav_alt):
                    wav = wav_alt
                elif not os.path.exists(wav):
                    continue
                words = clean_transcript(row.get("sentence", ""), language,
                                         accented_letters)
                if not words:
                    continue
                duration = _duration(wav)
                if split == "train" and duration > duration_threshold:
                    continue
                manifest[os.path.splitext(clip)[0]] = {
                    "wav": wav, "duration": duration, "words": words}
        with open(out, "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info(f"Prepared {out} ({len(manifest)} utterances)")


# each language's words: punctuation and apostrophes around them, and its
# accented letters (German's ß upper-cases to SS)
LEXICONS = {
    "en": ["the", "cat", "don't", "café", "naïve", "rain", "it's", "road",
           "house", "light", "water", "after", "never", "green", "small"],
    "fr": ["l'été", "où", "ça", "garçon", "élève", "très", "forêt", "noël",
           "je", "suis", "à", "la", "maison", "c'est", "père", "deux",
           "rue", "île", "hôtel", "déjà"],
    "de": ["über", "schön", "straße", "mädchen", "grün", "der", "hund",
           "läuft", "heute", "nach", "hause", "müde", "ist", "größe"],
    "it": ["città", "perché", "più", "così", "l'uomo", "è", "un", "caffè",
           "bello", "dell'anno", "giù", "verità", "casa", "sono"],
    "rw": ["umwana", "w'umugabo", "ni", "mwiza", "cyane", "amazi", "y'ubuzima",
           "inka", "ishuri", "kandi", "murakoze", "ndashaka"],
}
_PUNCTUATION = (",", ".", "!", "?", ";", ":", " -", " «", "»", "\"")


def _sentence(rng, words, n_words):
    out = []
    for i in range(int(rng.integers(n_words[0], n_words[1] + 1))):
        word = str(rng.choice(words))
        if i == 0:
            word = word[0].upper() + word[1:]
        if rng.random() < 0.3:
            word += str(rng.choice(_PUNCTUATION))
        out.append(word)
    return " ".join(out) + str(rng.choice((".", "!", "?", "")))


def write_synthetic_common_voice(folder, counts, language="en",
                                 seconds=(1.0, 3.0), n_words=(2, 6),
                                 sample_rate=16000, seed=0):
    """Write a CommonVoice-shaped language folder of synthetic utterances,
    for trying the recipes without it: ``counts`` maps 'train', 'dev'
    and 'test' to their numbers of rows of ``<split>.tsv`` (CommonVoice's
    columns; ``path`` names ``common_voice_<language>_<n>.mp3``), each
    with a 16-bit PCM WAV at ``sample_rate`` (noise and two tones lasting
    ``seconds``, uniform) beside that name in ``clips/``, and a sentence
    of ``n_words`` words (uniform) of ``LEXICONS[language]`` with
    punctuation.  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    clips = os.path.join(folder, "clips")
    os.makedirs(clips, exist_ok=True)
    words = LEXICONS[language]
    n = 0
    for split in ("train", "dev", "test"):
        if split not in counts:
            continue
        with open(os.path.join(folder, f"{split}.tsv"), "w", newline="",
                  encoding="utf-8") as f:
            writer = csv.writer(f, delimiter="\t")
            writer.writerow(["client_id", "path", "sentence", "up_votes",
                             "down_votes", "age", "gender", "accent"])
            for _ in range(counts[split]):
                name = f"common_voice_{language}_{n:08d}"
                samples = int(rng.uniform(*seconds) * sample_rate)
                t = np.arange(samples) / sample_rate
                f1, f2 = rng.uniform(100, 3000, 2)
                sig = (0.05 * rng.standard_normal(samples)
                       + 0.2 * np.sin(2 * np.pi * f1 * t)
                       + 0.1 * np.sin(2 * np.pi * f2 * t))
                pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
                with wave.open(os.path.join(clips, name + ".wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sample_rate)
                    w.writeframes(pcm.tobytes())
                writer.writerow([f"client{n % 5}", name + ".mp3",
                                 _sentence(rng, words, n_words), 2, 0, "", "",
                                 ""])
                n += 1
