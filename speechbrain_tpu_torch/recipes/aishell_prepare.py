"""AISHELL-1 (Mandarin read speech): the manifests of its recipes, and a
synthetic corpus in its layout.

``prepare_aishell`` is a copy of ``recipes/AISHELL-1/aishell_prepare.py``:
the transcript table ``data_aishell/transcript/aishell_transcript_v0.8.txt``
(``<utt> <word> <word> ...`` a line) and the audio tree
``data_aishell/wav/<split>/<speaker>/<utt>.wav`` become
``<save_folder>/{train,dev,test}.json`` (``{id: {wav, duration,
transcript}}``, the words joined by spaces; a file without a transcript is
left out; a manifest that exists is kept).  ``write_synthetic_aishell``
writes such a corpus from a seed.
"""

import glob
import json
import logging
import os
import wave

import numpy as np

from ..dataio.dataio import read_audio

logger = logging.getLogger(__name__)

__all__ = ["prepare_aishell", "write_synthetic_aishell"]

SAMPLERATE = 16000


def prepare_aishell(data_folder, save_folder, skip_prep=False):
    """Write the train, dev and test manifests of the corpus at
    ``data_folder`` (which holds ``data_aishell/``).

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_aishell(d, {"dev": 2}, seconds=(0.2, 0.3))
    >>> prepare_aishell(d, d + "/save")
    >>> sorted(json.load(open(d + "/save/dev.json")))
    ['BAC009S0724W0001', 'BAC009S0724W0002']
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    transcript_path = os.path.join(data_folder, "data_aishell", "transcript",
                                   "aishell_transcript_v0.8.txt")
    filename2transcript = {}
    with open(transcript_path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                filename2transcript[parts[0]] = " ".join(parts[1:])
    for split in ("train", "dev", "test"):
        out = os.path.join(save_folder, f"{split}.json")
        if os.path.exists(out):
            continue
        manifest = {}
        pattern = os.path.join(data_folder, "data_aishell", "wav", split,
                               "*", "*.wav")
        for wav in sorted(glob.glob(pattern)):
            utt_id = os.path.splitext(os.path.basename(wav))[0]
            if utt_id not in filename2transcript:
                continue
            manifest[utt_id] = {
                "wav": wav,
                "duration": round(len(read_audio(wav)) / 16000.0, 3),
                "transcript": filename2transcript[utt_id],
            }
        with open(out, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, ensure_ascii=False)
        logger.info(f"Prepared {out} ({len(manifest)} utterances)")


# the speaker folder of each split in the synthetic corpus
_SPEAKERS = {"train": "S0002", "dev": "S0724", "test": "S0764"}


def write_synthetic_aishell(folder, counts, seconds=(2.0, 5.0),
                            n_words=(2, 6), n_chars=60, seed=0,
                            untranscribed=0):
    """Write an AISHELL-1-shaped corpus of synthetic utterances, for
    trying the recipes without it: ``counts`` maps 'train', 'dev' and
    'test' to their numbers of utterances, each a 16 kHz 16-bit PCM WAV
    (noise plus two tones lasting ``seconds``, uniform) under
    ``data_aishell/wav/<split>/<speaker>/``, listed in the transcript
    table with ``n_words`` words (uniform) of 1-3 characters drawn from
    ``n_chars`` CJK characters.  Each split also gets ``untranscribed``
    WAVs that the table does not list.  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    chars = [chr(0x4E00 + int(c))
             for c in rng.choice(20000, n_chars, replace=False)]
    lines = []
    for split, n in sorted(counts.items()):
        spk = _SPEAKERS[split]
        wav_dir = os.path.join(folder, "data_aishell", "wav", split, spk)
        os.makedirs(wav_dir, exist_ok=True)
        for i in range(1, n + 1 + untranscribed):
            utt = f"BAC009{spk}W{i:04d}"
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
            if i <= n:
                words = ["".join(rng.choice(chars, rng.integers(1, 4)))
                         for _ in range(rng.integers(n_words[0],
                                                     n_words[1] + 1))]
                lines.append(f"{utt} {' '.join(words)}")
    tdir = os.path.join(folder, "data_aishell", "transcript")
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(tdir, "aishell_transcript_v0.8.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
