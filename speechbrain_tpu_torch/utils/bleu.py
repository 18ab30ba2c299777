"""Corpus BLEU (no sacrebleu), for the speech translation recipes.

A copy of ``speechbrain_tpu/utils/bleu.py`` (the port imports nothing of
the JAX package): ``corpus_bleu`` clips each hypothesis n-gram count by
its largest count in any one reference, takes the closest reference
length (the shorter one on a tie) for the brevity penalty, and averages
the log precisions over the orders that have n-grams at all (a corpus of
segments shorter than 4 has no 4-grams: its BLEU is over orders 1-3);
any zero precision among those gives 0.
"""

import collections
import math

from .metric_stats import MetricStats

__all__ = ["BLEUStats", "corpus_bleu"]


def _ngram_counts(tokens, n):
    return collections.Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(hypotheses, references, max_n=4):
    """Corpus-level BLEU with the standard brevity penalty.

    hypotheses : list of token lists; references : for each segment a
    list of reference token lists.  Returns a dict of ``BLEU`` (0-100),
    ``precisions`` (percent, one per order), ``BP``, ``hyp_len`` and
    ``ref_len``.

    Example
    -------
    >>> round(corpus_bleu([["the", "cat", "sat"]],
    ...                   [[["the", "cat", "sat"]]])["BLEU"], 1)
    100.0
    >>> corpus_bleu([[]], [[["a"]]])["BLEU"]
    0.0
    """
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_counts = _ngram_counts(hyp, n)
            max_ref = collections.Counter()
            for r in refs:
                for gram, c in _ngram_counts(r, n).items():
                    max_ref[gram] = max(max_ref[gram], c)
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            clipped[n - 1] += sum(
                min(c, max_ref[gram]) for gram, c in hyp_counts.items()
            )
    precisions = [
        (clipped[i] / totals[i]) if totals[i] > 0 else 0.0
        for i in range(max_n)
    ]
    # the orders with n-grams at all (short segments have no 4-grams)
    effective = [precisions[i] for i in range(max_n) if totals[i] > 0] or [0.0]
    if min(effective) > 0:
        geo_mean = math.exp(
            sum(math.log(p) for p in effective) / len(effective))
    else:
        geo_mean = 0.0
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return {
        "BLEU": 100.0 * bp * geo_mean,
        "precisions": [100.0 * p for p in precisions],
        "BP": bp,
        "hyp_len": hyp_len,
        "ref_len": ref_len,
    }


class BLEUStats(MetricStats):
    """Accumulates (hypothesis, references) pairs; ``summarize`` gives
    the corpus BLEU (``corpus_bleu``'s dict, or one field of it).

    Example
    -------
    >>> stats = BLEUStats()
    >>> stats.append(ids=["u1"], predict=[["a", "b", "c"]],
    ...              targets=[[["a", "b", "c"]]])
    >>> round(stats.summarize("BLEU"), 1)
    100.0
    """

    def __init__(self, lang="en", merge_words=True):
        self.clear()
        self.merge_words = merge_words

    def clear(self):
        """Reset accumulated statistics."""
        self.ids = []
        self.predicts = []
        self.targets = []
        self.summary = {}

    def append(self, ids, predict, targets):
        """``predict``: a token list a segment; ``targets``: a list of
        streams, each a reference a segment (the JAX recipes pass one
        stream, ``[refs]``), appended as they are."""
        self.ids.extend(ids)
        self.predicts.extend(predict)
        self.targets.extend(targets)

    def summarize(self, field=None):
        """The corpus BLEU of everything appended: the dict, or its
        ``field``."""
        self.summary = corpus_bleu(self.predicts, self.targets)
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream):
        """The BLEU and the precisions, a line each."""
        if not self.summary:
            self.summarize()
        print(f"BLEU: {self.summary['BLEU']:.2f}", file=filestream)
        print(f"Precisions: {self.summary['precisions']}", file=filestream)
