"""Edit-distance (Levenshtein) accounting for WER/CER computation.

A copy of ``speechbrain_tpu/utils/edit_distance.py`` (pure Python: the
port imports nothing of the JAX package).  Error-rate accounting is not
a device workload.

Example
-------
>>> ref = "the quick brown fox".split()
>>> hyp = "the quack brown box".split()
>>> details = wer_details_for_batch(["utt1"], [ref], [hyp])
>>> details[0]["WER"]
50.0
"""

import collections

EDIT_SYMBOLS = {
    "eq": "=",
    "ins": "I",
    "del": "D",
    "sub": "S",
}

__all__ = [
    "accumulatable_wer_stats",
    "op_table",
    "alignment",
    "count_ops",
    "wer_details_for_batch",
    "wer_details_by_utterance",
    "wer_summary",
    "wer_details_by_speaker",
    "top_wer_utts",
    "top_wer_spks",
]


def op_table(a, b):
    """Levenshtein DP table of edit ops between sequences a (ref) and b (hyp).

    Returns a (len(a)+1) x (len(b)+1) list-of-lists of EDIT_SYMBOLS values,
    from which ``alignment`` backtraces the minimum edit path.
    """
    table = [
        [EDIT_SYMBOLS["eq"] for _ in range(len(b) + 1)]
        for _ in range(len(a) + 1)
    ]
    prev_row = list(range(len(b) + 1))
    curr_row = [0] * (len(b) + 1)
    for j in range(len(b) + 1):
        if j > 0:
            table[0][j] = EDIT_SYMBOLS["ins"]
    for i in range(len(a) + 1):
        if i > 0:
            table[i][0] = EDIT_SYMBOLS["del"]
    for i in range(1, len(a) + 1):
        curr_row[0] = i
        for j in range(1, len(b) + 1):
            sub_cost = prev_row[j - 1] + (a[i - 1] != b[j - 1])
            del_cost = prev_row[j] + 1
            ins_cost = curr_row[j - 1] + 1
            best = min(sub_cost, del_cost, ins_cost)
            curr_row[j] = best
            if best == sub_cost:
                table[i][j] = (
                    EDIT_SYMBOLS["eq"]
                    if a[i - 1] == b[j - 1]
                    else EDIT_SYMBOLS["sub"]
                )
            elif best == del_cost:
                table[i][j] = EDIT_SYMBOLS["del"]
            else:
                table[i][j] = EDIT_SYMBOLS["ins"]
        prev_row, curr_row = curr_row, prev_row
    return table


def alignment(table):
    """Backtrace the op table to a list of (op, ref_idx, hyp_idx) steps.

    Indices are None on the side an insertion/deletion skips.
    """
    i = len(table) - 1
    j = len(table[0]) - 1
    steps = []
    while i > 0 or j > 0:
        op = table[i][j]
        if i == 0 or op == EDIT_SYMBOLS["ins"]:
            j -= 1
            steps.append((EDIT_SYMBOLS["ins"], None, j))
        elif j == 0 or op == EDIT_SYMBOLS["del"]:
            i -= 1
            steps.append((EDIT_SYMBOLS["del"], i, None))
        else:
            i -= 1
            j -= 1
            steps.append((op, i, j))
    steps.reverse()
    return steps


def count_ops(table):
    """Count insertions/deletions/substitutions along the min edit path."""
    edits = collections.Counter()
    i = len(table) - 1
    j = len(table[0]) - 1
    while i > 0 or j > 0:
        op = table[i][j]
        if i == 0 or op == EDIT_SYMBOLS["ins"]:
            edits["insertions"] += 1
            j -= 1
        elif j == 0 or op == EDIT_SYMBOLS["del"]:
            edits["deletions"] += 1
            i -= 1
        else:
            if op == EDIT_SYMBOLS["sub"]:
                edits["substitutions"] += 1
            i -= 1
            j -= 1
    return edits


def accumulatable_wer_stats(refs, hyps, stats=None):
    """Accumulate WER stats over batches into a running Counter.

    Example
    -------
    >>> s = accumulatable_wer_stats([[1, 2, 3]], [[1, 2, 4]])
    >>> s = accumulatable_wer_stats([[1, 2]], [[1, 2]], s)
    >>> round(s["WER"], 2)
    20.0
    """
    if stats is None:
        stats = collections.Counter()
    updates = collections.Counter()
    for ref, hyp in zip(refs, hyps):
        table = op_table(ref, hyp)
        updates += count_ops(table)
        updates["num_ref_tokens"] += len(ref)
        updates["num_sentences"] += 1
    stats = stats + updates
    num_edits = (
        stats["insertions"] + stats["deletions"] + stats["substitutions"]
    )
    if stats["num_ref_tokens"] > 0:
        stats["WER"] = 100.0 * num_edits / stats["num_ref_tokens"]
    stats["num_edits"] = num_edits
    return stats


def wer_details_for_batch(ids, refs, hyps, compute_alignments=False):
    """Per-utterance WER details for a batch of (id, ref, hyp) triples."""
    refs = list(refs)
    hyps = list(hyps)
    details = []
    for utt_id, ref, hyp in zip(ids, refs, hyps):
        table = op_table(ref, hyp)
        ops = count_ops(table)
        num_edits = (
            ops["insertions"] + ops["deletions"] + ops["substitutions"]
        )
        detail = {
            "key": utt_id,
            "hyp_absent": hyp is None,
            "hyp_empty": len(hyp) == 0 if hyp is not None else True,
            "num_edits": num_edits,
            "num_ref_tokens": len(ref),
            "WER": 100.0 * num_edits / max(1, len(ref)),
            "insertions": ops["insertions"],
            "deletions": ops["deletions"],
            "substitutions": ops["substitutions"],
            "alignment": alignment(table) if compute_alignments else None,
            "ref_tokens": list(ref) if compute_alignments else None,
            "hyp_tokens": list(hyp) if compute_alignments else None,
        }
        details.append(detail)
    return details


def wer_summary(details_by_utterance):
    """Aggregate utterance details into corpus-level WER/SER summary."""
    total = {
        "WER": None,
        "SER": None,
        "num_edits": 0,
        "num_scored_tokens": 0,
        "num_erroneous_sents": 0,
        "num_scored_sents": 0,
        "num_absent_sents": 0,
        "num_ref_sents": 0,
        "insertions": 0,
        "deletions": 0,
        "substitutions": 0,
    }
    for d in details_by_utterance:
        total["num_ref_sents"] += 1
        if d["hyp_absent"]:
            total["num_absent_sents"] += 1
            continue
        total["num_scored_sents"] += 1
        total["num_scored_tokens"] += d["num_ref_tokens"]
        total["num_edits"] += d["num_edits"]
        total["insertions"] += d["insertions"]
        total["deletions"] += d["deletions"]
        total["substitutions"] += d["substitutions"]
        if d["num_edits"] > 0:
            total["num_erroneous_sents"] += 1
    if total["num_scored_tokens"] > 0:
        total["WER"] = 100.0 * total["num_edits"] / total["num_scored_tokens"]
    if total["num_scored_sents"] > 0:
        total["SER"] = (
            100.0 * total["num_erroneous_sents"] / total["num_scored_sents"]
        )
    return total


def wer_details_by_utterance(
    ref_dict, hyp_dict, compute_alignments=False, scoring_mode="strict"
):
    """WER details keyed by utterance-id dicts (Kaldi-style scoring modes).

    scoring_mode: "strict" raises on missing hyp; "present" skips missing;
    "all" scores missing hyps as empty.
    """
    details = []
    for key, ref in ref_dict.items():
        if key in hyp_dict:
            hyp = hyp_dict[key]
        elif scoring_mode == "all":
            hyp = []
        elif scoring_mode == "present":
            details.append(
                {
                    "key": key,
                    "hyp_absent": True,
                    "hyp_empty": True,
                    "num_edits": 0,
                    "num_ref_tokens": len(ref),
                    "WER": None,
                    "insertions": 0,
                    "deletions": 0,
                    "substitutions": 0,
                    "alignment": None,
                    "ref_tokens": None,
                    "hyp_tokens": None,
                }
            )
            continue
        else:
            raise KeyError(f"Missing hypothesis for utterance {key}")
        details.extend(
            wer_details_for_batch([key], [ref], [hyp], compute_alignments)
        )
    return details


def wer_details_by_speaker(details_by_utterance, utt2spk):
    """Group utterance WER details by speaker."""
    by_spk = {}
    for d in details_by_utterance:
        spk = utt2spk[d["key"]]
        spk_details = by_spk.setdefault(
            spk,
            collections.Counter(
                {
                    "speaker": spk,
                    "num_edits": 0,
                    "insertions": 0,
                    "deletions": 0,
                    "substitutions": 0,
                    "num_scored_tokens": 0,
                    "num_scored_sents": 0,
                    "num_erroneous_sents": 0,
                    "num_absent_sents": 0,
                    "num_ref_sents": 0,
                }
            ),
        )
        spk_details["num_ref_sents"] += 1
        if d["hyp_absent"]:
            spk_details["num_absent_sents"] += 1
        else:
            spk_details["num_scored_sents"] += 1
            spk_details["num_scored_tokens"] += d["num_ref_tokens"]
            spk_details["num_edits"] += d["num_edits"]
            spk_details["insertions"] += d["insertions"]
            spk_details["deletions"] += d["deletions"]
            spk_details["substitutions"] += d["substitutions"]
            if d["num_edits"] > 0:
                spk_details["num_erroneous_sents"] += 1
    out = []
    for spk, details in sorted(by_spk.items()):
        details = dict(details)
        if details["num_scored_tokens"] > 0:
            details["WER"] = (
                100.0 * details["num_edits"] / details["num_scored_tokens"]
            )
            details["SER"] = (
                100.0
                * details["num_erroneous_sents"]
                / details["num_scored_sents"]
            )
        else:
            details["WER"] = None
            details["SER"] = None
        out.append(details)
    return out


def top_wer_utts(details_by_utterance, top_k=20):
    """The top-k highest-WER scored utterances (also empty-hyp ones)."""
    scored = [
        d
        for d in details_by_utterance
        if not d["hyp_absent"] and d["WER"] is not None
    ]
    scored.sort(key=lambda d: d["WER"], reverse=True)
    non_empty = [d for d in scored if not d["hyp_empty"]][:top_k]
    empty = [d for d in scored if d["hyp_empty"]][:top_k]
    return non_empty, empty


def top_wer_spks(details_by_speaker, top_k=10):
    """The top-k highest-WER speakers."""
    scored = [d for d in details_by_speaker if d["WER"] is not None]
    scored.sort(key=lambda d: d["WER"], reverse=True)
    return scored[:top_k]
