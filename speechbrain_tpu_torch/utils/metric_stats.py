"""Metric accumulation across batches: ``MetricStats``, the WER/CER
``ErrorRateStats`` and the classification ``AccuracyStats``; and the
speaker-verification metrics ``EER`` and ``minDCF``.

A copy of ``MetricStats``/``ErrorRateStats``/``AccuracyStats`` of
``speechbrain_tpu/utils/metric_stats.py`` (the port imports nothing of
the JAX package).  Values accumulate on the host (numpy; a tensor is
brought to the host when appended) and ``summarize()`` at stage end.
"""

import numpy as np

from .data_utils import undo_padding
from .edit_distance import wer_details_for_batch, wer_summary

__all__ = ["MetricStats", "ErrorRateStats", "AccuracyStats", "EER", "minDCF"]


def _to_numpy(x):
    if hasattr(x, "detach"):  # a tensor, on any device
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__"):
        return np.asarray(x)
    return x


class MetricStats:
    """Accumulate a scalar metric over utterances; summarize at stage end.

    Arguments
    ---------
    metric : callable
        Called as metric(**kwargs appended) and expected to return a
        per-example array or scalar of scores.

    Example
    -------
    >>> def l1(a, b):
    ...     return np.abs(np.asarray(a) - np.asarray(b)).mean(axis=-1)
    >>> stats = MetricStats(metric=l1)
    >>> stats.append(ids=["u1", "u2"], a=np.array([[1.0], [2.0]]),
    ...              b=np.array([[1.5], [2.0]]))
    >>> stats.summarize("average")
    0.25
    """

    def __init__(self, metric, n_jobs=1):
        self.metric = metric
        self.n_jobs = n_jobs
        self.clear()

    def clear(self):
        """Reset accumulated statistics."""
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(self, ids, *args, **kwargs):
        """Accumulate a batch of ids/predictions/targets."""
        self.ids.extend(ids)
        args = [_to_numpy(a) for a in args]
        kwargs = {k: _to_numpy(v) for k, v in kwargs.items()}
        scores = np.atleast_1d(np.asarray(self.metric(*args, **kwargs)))
        self.scores.extend(scores.tolist())

    def summarize(self, field=None):
        """Return the requested summary statistic(s)."""
        scores = np.asarray(self.scores, dtype=np.float64)
        min_index = int(np.argmin(scores)) if len(scores) else 0
        max_index = int(np.argmax(scores)) if len(scores) else 0
        self.summary = {
            "average": float(scores.mean()) if len(scores) else 0.0,
            "min_score": float(scores[min_index]) if len(scores) else 0.0,
            "min_id": self.ids[min_index] if self.ids else None,
            "max_score": float(scores[max_index]) if len(scores) else 0.0,
            "max_id": self.ids[max_index] if self.ids else None,
        }
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream, verbose=False):
        """Write a detailed report to the given stream."""
        if not self.summary:
            self.summarize()
        message = f"Average score: {self.summary['average']}\n"
        message += f"Min error: {self.summary['min_score']} "
        message += f"id: {self.summary['min_id']}\n"
        message += f"Max error: {self.summary['max_score']} "
        message += f"id: {self.summary['max_id']}\n"
        filestream.write(message)
        if verbose:
            print(message)


class ErrorRateStats(MetricStats):
    """WER/CER accumulation with Kaldi-style alignment reporting.

    Arguments
    ---------
    merge_tokens : bool
        Concatenate tokens before scoring (for CER from subwords).
    split_tokens : bool
        Split each token into characters before scoring (CER).
    space_token : str
        Token replaced by a space when merging.

    Example
    -------
    >>> stats = ErrorRateStats()
    >>> stats.append(ids=["u1"], predict=[["the", "cat"]],
    ...              target=[["the", "hat"]])
    >>> stats.summarize("error_rate")
    50.0
    """

    def __init__(self, merge_tokens=False, split_tokens=False, space_token="_"):
        self.clear()
        self.merge_tokens = merge_tokens
        self.split_tokens = split_tokens
        self.space_token = space_token

    def clear(self):
        """Reset accumulated statistics."""
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(
        self,
        ids,
        predict,
        target,
        predict_len=None,
        target_len=None,
        ind2lab=None,
    ):
        """Accumulate a batch of ids/predictions/targets."""
        self.ids.extend(ids)
        if predict_len is not None:
            predict = undo_padding(predict, predict_len)
        if target_len is not None:
            target = undo_padding(target, target_len)
        if ind2lab is not None:
            predict = [ind2lab(p) for p in predict]
            target = [ind2lab(t) for t in target]
        if self.merge_tokens:
            predict = _merge_tokens(predict, self.space_token)
            target = _merge_tokens(target, self.space_token)
        if self.split_tokens:
            predict = _split_tokens(predict)
            target = _split_tokens(target)
        scores = wer_details_for_batch(ids, target, predict, True)
        self.scores.extend(scores)

    def summarize(self, field=None):
        """Return the requested summary statistic(s)."""
        self.summary = wer_summary(self.scores)
        self.summary["error_rate"] = self.summary["WER"]
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream):
        """Write a Kaldi-style aligned error report."""
        from ..dataio.wer import print_alignments, print_wer_summary

        if not self.summary:
            self.summarize()
        print_wer_summary(self.summary, filestream)
        print_alignments(self.scores, filestream)


class AccuracyStats(MetricStats):
    """Masked categorical accuracy of padded (B, T, C) log-probs against
    (B, T) targets, over each row's first ``round(length * T)`` positions
    (all of them without ``length``); a (B, 1, C) batch is one
    prediction a row.

    Example
    -------
    >>> probs = np.log(np.array([[[0.9, 0.1], [0.2, 0.8]]]))
    >>> stats = AccuracyStats()
    >>> stats.append(probs, np.array([[0, 1]]), np.array([1.0]))
    >>> stats.summarize()
    1.0
    """

    def __init__(self):
        self.clear()

    def clear(self):
        """Reset accumulated statistics."""
        self.correct = 0.0
        self.total = 0.0
        self.summary = {}

    def append(self, log_probabilities, targets, length=None):
        """Accumulate a batch of predictions and targets."""
        log_probabilities = _to_numpy(log_probabilities)
        targets = _to_numpy(targets)
        if length is not None:
            length = _to_numpy(length)
            abs_len = np.round(length * targets.shape[1]).astype(np.int64)
            mask = np.arange(targets.shape[1])[None, :] < abs_len[:, None]
        else:
            mask = np.ones(targets.shape[:2], dtype=bool)
        pred = log_probabilities.argmax(-1)
        self.correct += float(((pred == targets) & mask).sum())
        self.total += float(mask.sum())

    def summarize(self, field=None):
        """The accuracy (``correct / max(1, total)``), or the summary's
        ``field`` ("accuracy", "correct", "total")."""
        acc = self.correct / max(1.0, self.total)
        self.summary = {"accuracy": acc, "correct": self.correct,
                        "total": self.total}
        if field is not None:
            return self.summary[field]
        return acc


def _error_rates(positive_scores, negative_scores):
    """The thresholds of the JAX ``EER``/``minDCF`` (the unique scores and
    their midpoints, sorted) and at each the miss rate (the share of
    positive scores <= t) and the false-alarm rate (negative scores >
    t), as float64 numpy arrays.  The JAX package compares every score
    with every threshold (two N x 2N boolean matrices); here each count
    is a ``searchsorted`` into the sorted scores, O(N log N), and the
    rates are the same numbers (count / N in float64, as ``np.mean`` of
    the booleans)."""
    pos = np.asarray(_to_numpy(positive_scores), dtype=np.float64).reshape(-1)
    neg = np.asarray(_to_numpy(negative_scores), dtype=np.float64).reshape(-1)
    thresholds = np.unique(np.concatenate([pos, neg]))
    if len(thresholds) > 1:
        mid = (thresholds[:-1] + thresholds[1:]) / 2
        thresholds = np.sort(np.concatenate([thresholds, mid]))
    miss = np.searchsorted(np.sort(pos), thresholds, side="right") / len(pos)
    false_alarm = (len(neg) - np.searchsorted(np.sort(neg), thresholds,
                                              side="right")) / len(neg)
    return thresholds, miss, false_alarm


def EER(positive_scores, negative_scores):
    """The equal error rate and its threshold: at the first threshold
    where |FAR - FRR| is least, their mean (thresholds and boundary rules
    of ``_error_rates``).  Scores are arrays or tensors.

    Example
    -------
    >>> EER(np.array([0.6, 0.7, 0.8, 0.5]), np.array([0.4, 0.3, 0.2, 0.1]))
    (0.0, 0.4)
    """
    thresholds, frr, far = _error_rates(positive_scores, negative_scores)
    idx = np.argmin(np.abs(far - frr))
    return float((far[idx] + frr[idx]) / 2), float(thresholds[idx])


def minDCF(positive_scores, negative_scores, c_miss=1.0, c_fa=1.0,
           p_target=0.01):
    """The least detection cost ``c_miss P_miss p_target + c_fa P_fa (1 -
    p_target)`` over the thresholds of ``_error_rates``, and its
    threshold.  The cost is the raw one (not divided by the default
    cost), as in the JAX package.

    Example
    -------
    >>> minDCF(np.array([0.6, 0.7, 0.8, 0.5]), np.array([0.4, 0.3, 0.2, 0.1]))
    (0.0, 0.4)
    """
    thresholds, p_miss, p_fa = _error_rates(positive_scores, negative_scores)
    c_det = c_miss * p_miss * p_target + c_fa * p_fa * (1 - p_target)
    idx = int(np.argmin(c_det))
    return float(c_det[idx]), float(thresholds[idx])


def _merge_tokens(sequences, space_token):
    out = []
    for seq in sequences:
        joined = "".join(str(s) for s in seq)
        out.append(joined.replace(space_token, " ").split(" "))
    return out


def _split_tokens(sequences):
    out = []
    for seq in sequences:
        out.append(list("".join(str(s) for s in seq)))
    return out
