"""Subword tokenizer: BPE / char models trained from manifests.

A copy of ``speechbrain_tpu/tokenizers/SentencePiece.py`` (the port
imports nothing of the JAX package): the same trainers (native C++ in
``native/``, and Python), the same encoder and the same
``<vocab>_<type>.model.json`` file, so each package loads the other's
model.  Train from a CSV/JSON annotation, persist the model, encode
as ids/pieces, decode back to text.  Word-boundary marker "▁"
(U+2581) follows the sentencepiece convention so saved vocabularies are
interchangeable in format.

Supported model types: "bpe" (greedy merges by pair frequency),
"unigram" (substring-seeded Viterbi-EM with pruning — the
sentencepiece unigram-LM algorithm with Viterbi E-steps), "char",
"word".
"""

import collections
import json
import logging
import math
import os
import re

logger = logging.getLogger(__name__)

__all__ = ["SentencePiece", "BPEModel"]

WORD_BOUNDARY = "▁"


class BPEModel:
    """Byte-pair-encoding model: train / encode / decode / save / load."""

    def __init__(self, vocab_size=1000, character_coverage=1.0, model_type="bpe", special_tokens=("<unk>",), unk_id=0, use_native=True):
        self.vocab_size = vocab_size
        self.model_type = model_type
        self.special_tokens = list(special_tokens)
        self.unk_id = unk_id
        self.pieces = []
        self.piece2id = {}
        self.merges = []
        self.scores = {}
        self.use_native = use_native
        self._native_enc = None
        self.train_route = None  # "native" or "python" once trained

    # -- native (C++) fast paths --------------------------------------

    def _from_native_blob(self, blob):
        """Adopt a model trained by the native library."""
        self.pieces, self.merges, self.scores = [], [], {}
        specials = set(self.special_tokens)
        for line in blob.splitlines():
            parts = line.split(" ")
            if parts[0] == "PIECE":
                self.pieces.append(parts[1])
                if self.model_type == "unigram" and parts[1] not in specials:
                    self.scores[parts[1]] = float(parts[2])
            elif parts[0] == "MERGE":
                self.merges.append((parts[1], parts[2]))
        self._rebuild_index()

    def _to_native_blob(self):
        """Serialize for the native encoder (inverse of the above)."""
        lines = [f"TYPE {self.model_type}", f"UNK {self.unk_id}"]
        for s in self.special_tokens:
            lines.append(f"SPECIAL {s}")
        for p in self.pieces:
            lines.append(f"PIECE {p} {self.scores.get(p, 0.0)!r}")
        for a, b in self.merges:
            lines.append(f"MERGE {a} {b}")
        return "\n".join(lines)

    def _native_encoder(self):
        """Lazily-built native encode handle (None = Python path)."""
        if not self.use_native or self.model_type not in ("bpe", "unigram"):
            return None
        if self._native_enc is None:
            try:
                from .. import native

                if native.get_lib() is None:
                    self.use_native = False
                    return None
                self._native_enc = native.NativeEncoder(
                    self._to_native_blob()
                )
            except Exception as err:  # pragma: no cover
                logger.warning("Native encoder unavailable: %s", err)
                self.use_native = False
                return None
        return self._native_enc

    # -- training ----------------------------------------------------------

    def train(self, sentences):
        """Learn merges from an iterable of text lines."""
        sentences = [line.strip() for line in sentences]
        if self.use_native and self.model_type in ("bpe", "unigram"):
            try:
                from .. import native

                blob = native.tok_train(
                    sentences,
                    self.vocab_size,
                    self.model_type,
                    self.special_tokens,
                )
            except Exception as err:  # pragma: no cover
                logger.warning("Native training failed (%s); Python path", err)
                blob = None
            if blob is not None:
                self._from_native_blob(blob)
                self.train_route = "native"
                return self
        self.train_route = "python"
        word_freq = collections.Counter()
        for line in sentences:
            for word in line.strip().split():
                word_freq[WORD_BOUNDARY + word] += 1
        # Base vocabulary: all characters.
        charset = set()
        for word in word_freq:
            charset.update(word)
        pieces = list(self.special_tokens) + sorted(charset)
        if self.model_type == "char":
            self.pieces = pieces[: self.vocab_size]
            self._rebuild_index()
            return self
        if self.model_type == "word":
            words = [w for w, _ in word_freq.most_common(self.vocab_size)]
            self.pieces = list(self.special_tokens) + words
            self._rebuild_index()
            return self
        if self.model_type == "unigram":
            return self._train_unigram(word_freq, pieces)
        # BPE merges.
        words = {
            word: (list(word), freq) for word, freq in word_freq.items()
        }
        merges = []
        while len(pieces) + len(merges) < self.vocab_size:
            pair_freq = collections.Counter()
            for symbols, freq in words.values():
                for a, b in zip(symbols, symbols[1:]):
                    pair_freq[(a, b)] += freq
            if not pair_freq:
                break
            (a, b), freq = pair_freq.most_common(1)[0]
            if freq < 2:
                break
            merges.append((a, b))
            merged = a + b
            for word, (symbols, f) in words.items():
                out = []
                i = 0
                while i < len(symbols):
                    if (
                        i < len(symbols) - 1
                        and symbols[i] == a
                        and symbols[i + 1] == b
                    ):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(symbols[i])
                        i += 1
                words[word] = (out, f)
        self.merges = merges
        self.pieces = pieces + [a + b for a, b in merges]
        self._rebuild_index()
        return self

    def _rebuild_index(self):
        self.piece2id = {p: i for i, p in enumerate(self.pieces)}
        self.merge_ranks = {
            pair: i for i, pair in enumerate(self.merges)
        }

    # -- unigram LM training (sentencepiece algorithm, Viterbi E-step) --

    MAX_PIECE_LEN = 10
    SEED_FACTOR = 4
    EM_ITERS = 2
    SHRINK = 0.75

    def _viterbi_split(self, word, scores):
        """Best segmentation of ``word`` under piece log-probs.

        Unknown single chars get a large penalty (guaranteed fallback).
        Returns (pieces, total score).
        """
        n = len(word)
        best = [(-math.inf, -1)] * (n + 1)
        best[0] = (0.0, -1)
        maxlen = self.MAX_PIECE_LEN
        for e in range(1, n + 1):
            for s in range(max(0, e - maxlen), e):
                if best[s][0] == -math.inf:
                    continue
                piece = word[s:e]
                sc = scores.get(piece)
                if sc is None:
                    if e - s == 1:
                        sc = -20.0  # unk char fallback
                    else:
                        continue
                cand = best[s][0] + sc
                if cand > best[e][0]:
                    best[e] = (cand, s)
        pieces = []
        e = n
        while e > 0:
            s = best[e][1]
            pieces.append(word[s:e])
            e = s
        return pieces[::-1], best[n][0]

    def _train_unigram(self, word_freq, base_pieces):
        """Seed with frequent substrings, Viterbi-EM, prune to size."""
        # 1) seed: all substrings up to MAX_PIECE_LEN by frequency
        sub_freq = collections.Counter()
        for word, freq in word_freq.items():
            L = len(word)
            for s in range(L):
                for e in range(s + 1, min(L, s + self.MAX_PIECE_LEN) + 1):
                    sub_freq[word[s:e]] += freq
        chars = {p for p in sub_freq if len(p) == 1}
        n_seed = max(
            self.vocab_size * self.SEED_FACTOR, len(chars) + 16
        )
        seed = dict(sub_freq.most_common(n_seed))
        for c in chars:  # single chars always survive
            seed.setdefault(c, sub_freq[c])
        total = sum(seed.values())
        scores = {
            p: math.log(f / total) for p, f in seed.items()
        }
        target = self.vocab_size - len(self.special_tokens)

        def em(scores, iters):
            for _ in range(iters):
                counts = collections.Counter()
                for word, freq in word_freq.items():
                    pieces, _ = self._viterbi_split(word, scores)
                    for p in pieces:
                        counts[p] += freq
                tot = sum(counts.values())
                scores = {
                    p: math.log(c / tot)
                    for p, c in counts.items()
                    if p in scores
                }
                # chars must stay segmentable
                for c in chars:
                    scores.setdefault(c, math.log(0.5 / max(tot, 1)))
            return scores

        scores = em(scores, self.EM_ITERS)
        # 2) prune multi-char pieces with the lowest scores until target
        while len(scores) > target:
            keep = max(
                int(len(scores) * self.SHRINK), target
            )
            multi = sorted(
                (p for p in scores if len(p) > 1),
                key=lambda p: scores[p],
            )
            n_drop = len(scores) - keep
            for p in multi[:n_drop]:
                del scores[p]
            scores = em(scores, 1)
            if not multi:
                break
        vocab = sorted(scores, key=lambda p: -scores[p])[:target]
        self.pieces = list(self.special_tokens) + vocab
        self.scores = {p: scores[p] for p in vocab}
        self._rebuild_index()
        return self

    # -- encoding ----------------------------------------------------------

    def _bpe_word(self, word):
        if self.model_type == "unigram":
            pieces, _ = self._viterbi_split(word, self.scores)
            return pieces
        symbols = list(word)
        if self.model_type != "bpe":
            return symbols
        while len(symbols) > 1:
            best_rank, best_i = None, None
            for i, pair in enumerate(zip(symbols, symbols[1:])):
                rank = self.merge_ranks.get(pair)
                if rank is not None and (
                    best_rank is None or rank < best_rank
                ):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            symbols = (
                symbols[:best_i]
                + [symbols[best_i] + symbols[best_i + 1]]
                + symbols[best_i + 2 :]
            )
        return symbols

    def encode_as_pieces(self, text):
        """Text to list of subword pieces (BPE merges)."""
        enc = self._native_encoder()
        if enc is not None:
            # Single segmentation source: the native ids.
            return [self.pieces[i] for i in enc.encode(text.strip())]
        pieces = []
        for word in text.strip().split():
            if self.model_type == "word":
                pieces.append(
                    WORD_BOUNDARY + word
                    if WORD_BOUNDARY + word in self.piece2id
                    else self.special_tokens[self.unk_id]
                )
                continue
            pieces.extend(self._bpe_word(WORD_BOUNDARY + word))
        return pieces

    def encode_as_ids(self, text):
        """Text to list of piece ids (native C++ hot path when built)."""
        enc = self._native_encoder()
        if enc is not None:
            return enc.encode(text.strip())
        return [
            self.piece2id.get(p, self.unk_id)
            for p in self.encode_as_pieces(text)
        ]

    def decode_ids(self, ids):
        """Ids back to text."""
        pieces = [
            self.pieces[i] if 0 <= i < len(self.pieces) else ""
            for i in ids
        ]
        return self.decode_pieces(pieces)

    def decode_pieces(self, pieces):
        """Pieces back to text (strip word markers)."""
        text = "".join(
            p for p in pieces if p not in self.special_tokens
        )
        return text.replace(WORD_BOUNDARY, " ").strip()

    def get_piece_size(self):
        """Vocabulary size."""
        return len(self.pieces)

    def id_to_piece(self, i):
        """Id to piece string."""
        return self.pieces[i]

    def piece_to_id(self, piece):
        """Piece string to id (unk id if absent)."""
        return self.piece2id.get(piece, self.unk_id)

    # -- persistence -------------------------------------------------------

    def save(self, path):
        """Write the model (vocab+merges) as JSON."""
        with open(path, "w") as f:
            json.dump(
                {
                    "model_type": self.model_type,
                    "vocab_size": self.vocab_size,
                    "special_tokens": self.special_tokens,
                    "unk_id": self.unk_id,
                    "pieces": self.pieces,
                    "merges": [list(m) for m in self.merges],
                    "scores": self.scores,
                },
                f,
                ensure_ascii=False,
            )

    @classmethod
    def load(cls, path):
        """Load state from the given path."""
        with open(path) as f:
            data = json.load(f)
        model = cls(
            vocab_size=data["vocab_size"],
            model_type=data["model_type"],
            special_tokens=tuple(data["special_tokens"]),
            unk_id=data["unk_id"],
        )
        model.pieces = data["pieces"]
        model.merges = [tuple(m) for m in data["merges"]]
        model.scores = data.get("scores", {})
        model._rebuild_index()
        return model


class SentencePiece:
    """Recipe-facing tokenizer: train-or-load from an annotation file.

    Mirrors the reference surface (``tokenizers/SentencePiece.py:20``):
    same constructor args, ``sp`` attribute with
    encode_as_ids/encode_as_pieces/decode_ids, and batch ``__call__``.

    Arguments
    ---------
    model_dir : str
    vocab_size : int
    annotation_train : str, optional
        CSV or JSON manifest holding the text column.
    annotation_read : str
        Column/key with the text.
    model_type : "bpe" | "char" | "word" | "unigram" (approximated by bpe)
    character_coverage : float (accepted for API parity)
    bos_id, eos_id, pad_id, unk_id : int
    """

    def __init__(
        self,
        model_dir,
        vocab_size,
        annotation_train=None,
        annotation_read=None,
        model_type="unigram",
        char_format_input=False,
        character_coverage=1.0,
        user_defined_symbols=None,
        max_sentencepiece_length=10,
        bos_id=-1,
        eos_id=-1,
        pad_id=-1,
        unk_id=0,
        split_by_whitespace=True,
        num_sequences=None,
        annotation_list_to_check=None,
        annotation_format="csv",
        text_file=None,
        add_dummy_prefix=True,
    ):
        self.model_dir = model_dir
        self.vocab_size = int(vocab_size)
        self.model_type = model_type
        self.char_format_input = char_format_input
        self.annotation_read = annotation_read
        os.makedirs(model_dir, exist_ok=True)
        self.prefix_model_file = os.path.join(
            model_dir, f"{self.vocab_size}_{model_type}.model.json"
        )
        if os.path.isfile(self.prefix_model_file):
            self.sp = BPEModel.load(self.prefix_model_file)
        elif annotation_train is not None:
            sentences = list(
                self._read_annotation(annotation_train, annotation_format)
            )
            self.sp = BPEModel(
                vocab_size=self.vocab_size, model_type=model_type
            ).train(sentences)
            from ..utils.distributed import (
                ddp_barrier,
                if_main_process,
            )

            if if_main_process():
                self.sp.save(self.prefix_model_file)
            ddp_barrier()
        else:
            raise ValueError(
                "No existing model and no annotation_train to train from"
            )

    def _read_annotation(self, path, fmt):
        if fmt == "json" or path.endswith(".json"):
            from ..dataio.dataio import load_data_json

            data = load_data_json(path)
            for row in data.values():
                yield str(row[self.annotation_read])
        elif fmt == "csv" or path.endswith(".csv"):
            from ..dataio.dataio import load_data_csv

            data = load_data_csv(path)
            for row in data.values():
                yield str(row[self.annotation_read])
        else:
            with open(path) as f:
                yield from f

    def __call__(self, batch, batch_lens=None, ind2lab=None, task="encode"):
        """Batch encode ('encode') or decode ('decode_from_list')."""
        import numpy as np

        if task == "encode":
            if ind2lab is not None:
                batch = [
                    " ".join(ind2lab(row)) if not isinstance(row, str) else row
                    for row in batch
                ]
            encoded = [self.sp.encode_as_ids(text) for text in batch]
            max_len = max(len(e) for e in encoded)
            out = np.zeros((len(encoded), max_len), np.int64)
            lens = np.zeros(len(encoded), np.float32)
            for i, e in enumerate(encoded):
                out[i, : len(e)] = e
                lens[i] = len(e) / max_len
            return out, lens
        elif task == "decode_from_list":
            return [self.sp.decode_ids(row).split(" ") for row in batch]
        elif task == "decode":
            return [
                self.sp.decode_ids(
                    row[: int(round(float(l) * len(row)))]
                ).split(" ")
                for row, l in zip(batch, batch_lens)
            ]
        raise ValueError(f"Unknown task {task}")
