"""Switchboard-1 and eval2000 (Hub5): the manifests of its recipes, the
scoring-time normalization of their words, and a synthetic corpus in
their layout.

``prepare_switchboard`` is a copy of ``recipes/Switchboard/
switchboard_prepare.py``: the ms98 transcripts
(``sw<conv><A|B>-ms98-a-trans.text``, lines ``<utt> <start> <end>
<text>`` in seconds) of the 2-channel 8 kHz SPHERE conversations
(``sw0<conv>.sph``) become ``train.json`` and ``dev.json`` (the last
``dev_conversations`` conversations by id), rows ``{id: {wav: {file,
start, stop}, channel, duration, words, spk_id}}`` with ``start``/``stop``
in samples and ``channel`` 0 for side A, 1 for B, the text normalized by
``filter_text`` (Kaldi's swbd1 conventions); and, when an eval2000 ``.stm``
is found, ``eval2000.json`` from its segments.

``expand_contractions``, ``remove_hesitations`` and ``normalize_words`` are
``recipes/Switchboard/normalize_util.py``'s: the transformer recipe
scores its words after them.  ``write_synthetic_switchboard`` writes
such a corpus (stereo SPHERE files, ms98 transcripts and an stm) from a
seed.
"""

import glob
import json
import logging
import os
import re

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["SAMPLERATE", "prepare_switchboard", "filter_text",
           "eval2000_data_prep", "expand_contractions",
           "expand_contractions_batch", "remove_hesitations",
           "normalize_words", "read_glm", "write_sphere",
           "write_synthetic_switchboard"]

SAMPLERATE = 8000


def prepare_switchboard(data_folder, save_folder, splits=("train", "dev"),
                        dev_conversations=20, skip_prep=False):
    """Write ``train.json`` and ``dev.json`` (and ``eval2000.json`` when an
    stm is found) in ``save_folder``; nothing when the first two exist.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_switchboard(d, conversations=3, turns=2,
    ...                             eval_segments=2, seconds=(0.3, 0.5))
    >>> prepare_switchboard(d, d + "/save", dev_conversations=1)
    >>> sorted(json.load(open(d + "/save/dev.json")))[:2]
    ['sw2003A-ms98-a-0001', 'sw2003A-ms98-a-0002']
    """
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    train_out = os.path.join(save_folder, "train.json")
    dev_out = os.path.join(save_folder, "dev.json")
    if os.path.exists(train_out) and os.path.exists(dev_out):
        logger.info("Skipping preparation, completed in previous run.")
        return
    sph_index = _index_sph_files(data_folder)
    trans_files = sorted(glob.glob(
        os.path.join(data_folder, "**", "sw*-ms98-a-trans.text"),
        recursive=True))
    if not trans_files:
        raise FileNotFoundError(
            f"No ms98 transcription files under {data_folder}")
    # grouped by conversation, so that the dev split is
    # conversation-disjoint
    conversations = {}
    for tf in trans_files:
        conversations.setdefault(os.path.basename(tf)[:6], []).append(tf)
    dev_ids = set(sorted(conversations)[-dev_conversations:])
    rows = {"train": {}, "dev": {}}
    for conv, files in conversations.items():
        target = "dev" if conv in dev_ids else "train"
        for tf in files:
            rows[target].update(_parse_trans_file(tf, sph_index))
    for split, out in (("train", train_out), ("dev", dev_out)):
        with open(out, "w", encoding="utf-8") as f:
            json.dump(rows[split], f, indent=2)
        logger.info("%s: %d utterances", out, len(rows[split]))
    eval2000_data_prep(data_folder, save_folder)


def _index_sph_files(data_folder):
    """Conversation id (sw2001) -> its SPHERE file (sw02001.sph, ...)."""
    index = {}
    for path in glob.glob(os.path.join(data_folder, "**", "*.sph"),
                          recursive=True):
        base = os.path.splitext(os.path.basename(path))[0].lower()
        m = re.match(r"sw_?0?(\d{4})", base)
        if m:
            index["sw" + m.group(1)] = path
    return index


def _parse_trans_file(trans_file, sph_index):
    """One channel's transcript file -> manifest rows."""
    rows = {}
    with open(trans_file, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            utt_id, start_s, end_s = parts[0], parts[1], parts[2]
            text = filter_text(" ".join(parts[3:]))
            if not text:
                continue
            conv = utt_id.split("-")[0][:6].lower()
            channel = utt_id.split("-")[0][6]
            sph = sph_index.get(conv)
            if sph is None:
                continue
            rows[utt_id] = {
                "wav": {"file": sph,
                        "start": int(float(start_s) * SAMPLERATE),
                        "stop": int(float(end_s) * SAMPLERATE)},
                "channel": 0 if channel.upper() == "A" else 1,
                "duration": round(float(end_s) - float(start_s), 3),
                "words": text,
                "spk_id": conv + channel.upper(),
            }
    return rows


def filter_text(text, dataset="train"):
    """Kaldi-style swbd1/eval2000 transcript normalization: upper case;
    for eval2000 an excluded segment gives "", hesitations and ``(...)``
    markers go; silence goes, noises become [NOISE], ``[LAUGHTER-W]``
    becomes W, pronunciation variants ``W_1`` become W, partial words keep
    their dash (``W[ORD]-`` -> ``W-``, ``-[WO]RD`` -> ``-RD``), braces and
    angle tags go; a transcript of only [NOISE] or [LAUGHTER] gives "".

    Example
    -------
    >>> filter_text("[laughter-yes] them_1 [silence] th[e]- {breath} okay")
    'YES THEM TH- OKAY'
    """
    text = text.upper()
    if dataset in ("eval2000", "hub5", "test"):
        if "IGNORE_TIME_SEGMENT_" in text:
            return ""
        text = text.replace("(%HESITATION)", "")
        text = re.sub(r"\(\%?\w+\)", "", text)
    text = text.replace("[SILENCE]", "")
    text = re.sub(r"\[VOCALIZED-NOISE\]|\[NOISE\]", "[NOISE]", text)
    text = re.sub(r"\[LAUGHTER-([^\]]+)\]", r"\1", text)
    text = re.sub(r"(\w+)_\d+", r"\1", text)
    text = re.sub(r"(\w+)\[[^\]]+\]-", r"\1-", text)
    text = re.sub(r"-\[[^\]]+\](\w+)", r"-\1", text)
    text = re.sub(r"\{[^}]*\}", "", text)
    text = re.sub(r"<[^>]*>", "", text)
    text = re.sub(r"\s+", " ", text).strip()
    if text in ("[NOISE]", "[LAUGHTER]", ""):
        return ""
    return text


def eval2000_data_prep(data_folder, save_folder):
    """The first eval2000 ``.stm`` under ``data_folder`` (lines ``<file>
    <channel> <speaker> <start> <end> <flags> <text>``; ``;;`` comments)
    -> ``eval2000.json`` (ids ``<file>_<line>``), unless it exists or no
    stm is found."""
    out = os.path.join(save_folder, "eval2000.json")
    if os.path.exists(out):
        return
    stm_files = glob.glob(os.path.join(data_folder, "**", "*.stm"),
                          recursive=True)
    if not stm_files:
        logger.info("No eval2000 stm found; skipping test manifest.")
        return
    sph_index = {}
    for path in glob.glob(os.path.join(data_folder, "**", "*.sph"),
                          recursive=True):
        sph_index[os.path.splitext(os.path.basename(path))[0].lower()] = path
    rows = {}
    with open(stm_files[0], encoding="utf-8") as f:
        for i, line in enumerate(f):
            if line.startswith(";;"):
                continue
            parts = line.split(None, 6)
            if len(parts) < 7:
                continue
            fname, channel, spk, start_s, end_s, _flags, text = parts
            text = filter_text(text, dataset="eval2000")
            if not text:
                continue
            sph = sph_index.get(fname.lower())
            if sph is None:
                continue
            rows[f"{fname}_{i}"] = {
                "wav": {"file": sph,
                        "start": int(float(start_s) * SAMPLERATE),
                        "stop": int(float(end_s) * SAMPLERATE)},
                "channel": 0 if channel.upper() in ("A", "1") else 1,
                "duration": round(float(end_s) - float(start_s), 3),
                "words": text,
                "spk_id": spk,
            }
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rows, f, indent=2)
    logger.info("%s: %d utterances", out, len(rows))


# recipes/Switchboard/normalize_util.py
_CONTRACTIONS = [
    (r"\bWON'T\b", "WILL NOT"),
    (r"\bCAN'T\b", "CANNOT"),
    (r"\bLET'S\b", "LET US"),
    (r"\bAIN'T\b", "AM NOT"),
    (r"\bY'ALL\b", "YOU ALL"),
    (r"\b'CAUSE\b", "BECAUSE"),
    (r"\bO'CLOCK\b", "O CLOCK"),
    (r"\bWANNA\b", "WANT TO"),
    (r"\bGONNA\b", "GOING TO"),
    (r"\bGOTTA\b", "GOT TO"),
    (r"(\w+)N'T\b", r"\1 NOT"),
    (r"(\w+)'RE\b", r"\1 ARE"),
    (r"(\w+)'VE\b", r"\1 HAVE"),
    (r"(\w+)'LL\b", r"\1 WILL"),
    (r"(\w+)'D\b", r"\1 WOULD"),
    (r"\bI'M\b", "I AM"),
    (r"\bIT'S\b", "IT IS"),
    (r"\bTHAT'S\b", "THAT IS"),
    (r"\bHE'S\b", "HE IS"),
    (r"\bSHE'S\b", "SHE IS"),
    (r"\bWHAT'S\b", "WHAT IS"),
    (r"\bTHERE'S\b", "THERE IS"),
]

_HESITATIONS = ("UH", "UM", "EH", "MM", "HM", "AH", "HUH", "HA", "ER")


def expand_contractions(text):
    """Upper-case ``text`` with its English contractions expanded.

    Example
    -------
    >>> expand_contractions("we're gonna go, don't you think")
    'WE ARE GOING TO GO, DO NOT YOU THINK'
    """
    text = text.upper()
    for pattern, repl in _CONTRACTIONS:
        text = re.sub(pattern, repl, text)
    return re.sub(r"\s+", " ", text).strip()


def expand_contractions_batch(texts):
    """``expand_contractions`` over strings or word lists -> word lists."""
    out = []
    for t in texts:
        joined = t if isinstance(t, str) else " ".join(t)
        out.append(expand_contractions(joined).split())
    return out


def remove_hesitations(words):
    """The words without hesitations (``UH``, ``UM``, ... with or without
    a dash) and without [NOISE] and [LAUGHTER]."""
    return [w for w in words
            if w.upper().strip("-") not in _HESITATIONS
            and w not in ("[NOISE]", "[LAUGHTER]")]


def normalize_words(batch_of_words):
    """The scoring normalization of a batch of word lists: contractions
    expanded, then hesitations removed.

    Example
    -------
    >>> normalize_words([["UH", "I'M", "HERE"], ["[NOISE]", "OK"]])
    [['I', 'AM', 'HERE'], ['OK']]
    """
    return [remove_hesitations(words)
            for words in expand_contractions_batch(batch_of_words)]


def read_glm(glm_file):
    """An eval2000 GLM file -> {FROM: TO} mappings ({} without one)."""
    mappings = {}
    if not os.path.exists(glm_file):
        return mappings
    with open(glm_file, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.split(";;")[0].strip()
            if "=>" not in line:
                continue
            src, dst = line.split("=>", 1)
            src = src.strip().strip("[]{}").upper()
            dst = dst.split("/")[0].strip().strip("[]{}").upper()
            if src:
                mappings[src] = dst
    return mappings


def write_sphere(path, pcm, sample_rate=SAMPLERATE):
    """Write int16 samples (T,) or (T, channels) as a NIST SPHERE file
    (a 1024-byte header, then little-endian interleaved PCM)."""
    pcm = np.asarray(pcm, "<i2")
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    fields = [
        "NIST_1A", "   1024",
        f"sample_rate -i {sample_rate}",
        f"channel_count -i {channels}",
        "sample_n_bytes -i 2",
        f"sample_count -i {pcm.shape[0]}",
        "sample_coding -s3 pcm",
        "sample_byte_format -s2 01",
        "end_head",
    ]
    header = ("\n".join(fields) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header.ljust(1024, b" "))
        f.write(pcm.tobytes())


_MARKERS = ["[SILENCE]", "[NOISE]", "[VOCALIZED-NOISE]", "[LAUGHTER]",
            "{BREATH}", "<B_ASIDE>"]
_SPOKEN = ["UH", "UM", "I'M", "DON'T", "WE'RE", "GONNA", "YOU'LL", "IT'S"]


def _raw_words(rng, lexicon, n_words, eval2000=False):
    """A transcript in the ms98 (or stm) conventions: words of
    ``lexicon``, contractions and hesitations, laughter words, variants,
    partial words and non-speech markers."""
    out = []
    for _ in range(rng.integers(n_words[0], n_words[1] + 1)):
        word = str(rng.choice(lexicon))
        r = rng.random()
        if r < 0.08:
            word = f"[laughter-{word.lower()}]"
        elif r < 0.14:
            word = f"{word}_1"
        elif r < 0.2:
            word = f"{word[:1]}[{word[1:]}]-"
        elif r < 0.26:
            word = str(rng.choice(_MARKERS))
        elif r < 0.4:
            word = str(rng.choice(_SPOKEN))
        elif eval2000 and r < 0.46:
            word = str(rng.choice(["(%HESITATION)", "((SOMETHING))"]))
        out.append(word.lower())
    return " ".join(out)


def write_synthetic_switchboard(folder, conversations=4, turns=3,
                                eval_segments=3, seconds=(1.0, 3.0),
                                n_words=(3, 8), lexicon_size=60, seed=0):
    """Write a Switchboard-shaped corpus of synthetic conversations, for
    trying the recipes without it: ``conversations`` stereo 8 kHz SPHERE
    files ``swb1/sw0<2001+i>.sph`` (each side noise plus its own tones)
    with ``turns`` segments a side of ``seconds`` (uniform) listed in the
    ms98 transcripts ``swb_ms98_transcriptions/<conv>/
    sw<conv><A|B>-ms98-a-trans.text``, and an eval2000 conversation
    ``hub5e_00/english/en_4156.sph`` of ``eval_segments`` segments a side
    in ``reference/hub5e00.english.000405.stm`` (with an excluded segment
    and a comment line).  Transcripts hold ``n_words`` words (uniform)
    from a lexicon of ``lexicon_size`` uppercase words with the corpora's
    markers.  Everything comes from ``seed``."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    lexicon = sorted({"".join(rng.choice(letters, rng.integers(2, 8)))
                      for _ in range(lexicon_size)})

    def conversation(n_turns):
        """The stereo signal and per-side segment times of one call."""
        sides = [[], []]
        t = 0.2
        for _ in range(n_turns):
            for side in (0, 1):
                dur = rng.uniform(*seconds)
                sides[side].append((t, t + dur))
                t += dur + 0.1
        samples = int((t + 0.2) * SAMPLERATE)
        tt = np.arange(samples) / SAMPLERATE
        pcm = np.zeros((samples, 2))
        for side in (0, 1):
            f1, f2 = rng.uniform(100, 3000, 2)
            pcm[:, side] = (0.05 * rng.standard_normal(samples)
                            + 0.2 * np.sin(2 * np.pi * f1 * tt)
                            + 0.1 * np.sin(2 * np.pi * f2 * tt))
        return (np.clip(pcm, -1, 1) * 32767).astype("<i2"), sides

    os.makedirs(os.path.join(folder, "swb1"), exist_ok=True)
    for i in range(conversations):
        conv = 2001 + i
        pcm, sides = conversation(turns)
        write_sphere(os.path.join(folder, "swb1", f"sw0{conv}.sph"), pcm)
        tdir = os.path.join(folder, "swb_ms98_transcriptions", str(conv))
        os.makedirs(tdir, exist_ok=True)
        for side, letter in ((0, "A"), (1, "B")):
            lines = [
                f"sw{conv}{letter}-ms98-a-{k + 1:04d} {a:.6f} {b:.6f} "
                f"{_raw_words(rng, lexicon, n_words)}"
                for k, (a, b) in enumerate(sides[side])]
            with open(os.path.join(tdir,
                                   f"sw{conv}{letter}-ms98-a-trans.text"),
                      "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
    if eval_segments:
        pcm, sides = conversation(eval_segments)
        edir = os.path.join(folder, "hub5e_00", "english")
        os.makedirs(edir, exist_ok=True)
        write_sphere(os.path.join(edir, "en_4156.sph"), pcm)
        lines = [";; CATEGORY \"0\" \"\" \"\""]
        for side, letter in ((0, "A"), (1, "B")):
            for k, (a, b) in enumerate(sides[side]):
                text = ("IGNORE_TIME_SEGMENT_IN_SCORING" if k == 0 and side
                        else _raw_words(rng, lexicon, n_words, True))
                lines.append(f"en_4156 {letter} en_4156_{letter} {a:.2f} "
                             f"{b:.2f} <O,en,F,en-F> {text}")
        rdir = os.path.join(folder, "reference")
        os.makedirs(rdir, exist_ok=True)
        with open(os.path.join(rdir, "hub5e00.english.000405.stm"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
