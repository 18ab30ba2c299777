"""Kaldi-style WER report output.

A copy of ``speechbrain_tpu/dataio/wer.py`` (the port imports nothing
of the JAX package).
"""

import sys

from ..utils import edit_distance

__all__ = ["print_wer_summary", "print_alignments"]


def print_wer_summary(wer_details, file=sys.stdout):
    """Print the corpus-level summary in Kaldi compute-wer style."""
    print(
        "%WER {WER:.2f} [ {num_edits} / {num_scored_tokens}, {insertions} ins, "
        "{deletions} del, {substitutions} sub ]".format(**wer_details),
        file=file,
        end="",
    )
    print(
        " [PARTIAL]" if wer_details["num_scored_sents"] < wer_details["num_ref_sents"] else "",
        file=file,
    )
    print(
        "%SER {SER:.2f} [ {num_erroneous_sents} / {num_scored_sents} ]".format(
            **wer_details
        ),
        file=file,
    )
    print(
        "Scored {num_scored_sents} sentences, {num_absent_sents} not present in hyp.".format(
            **wer_details
        ),
        file=file,
    )


def print_alignments(details_by_utterance, file=sys.stdout, empty_symbol="<eps>", separator=" ; "):
    """Print per-utterance alignments with ref/hyp rows aligned."""
    _print_alignments_global_header(
        file=file, empty_symbol=empty_symbol, separator=separator
    )
    for dets in details_by_utterance:
        if dets["hyp_absent"] or dets["alignment"] is None:
            continue
        _print_alignment_header(dets, file=file)
        _print_alignment(
            dets["alignment"],
            dets["ref_tokens"],
            dets["hyp_tokens"],
            file=file,
            empty_symbol=empty_symbol,
            separator=separator,
        )


def _print_alignments_global_header(file, empty_symbol, separator):
    print("=" * 80, file=file)
    print("ALIGNMENTS", file=file)
    print("", file=file)
    print("Format:", file=file)
    print("<utterance-id>, WER DETAILS", file=file)
    # Demo alignment
    a = ["reference", "on", "the", "first", "line"]
    b = ["and", "hypothesis", "on", "the", "third"]
    table = edit_distance.op_table(a, b)
    alignment = edit_distance.alignment(table)
    _print_alignment(
        alignment, a, b, file=file, empty_symbol=empty_symbol, separator=separator
    )


def _print_alignment_header(wer_details, file):
    print("=" * 80, file=file)
    print(
        "{key}, %WER {WER:.2f} [ {num_edits} / {num_ref_tokens}, "
        "{insertions} ins, {deletions} del, {substitutions} sub ]".format(
            **wer_details
        ),
        file=file,
    )


def _print_alignment(alignment, a, b, file, empty_symbol, separator):
    a_padded = []
    b_padded = []
    ops_padded = []
    for op, i, j in alignment:
        op_string = str(op)
        a_string = str(a[i]) if i is not None else empty_symbol
        b_string = str(b[j]) if j is not None else empty_symbol
        pad_length = max(len(op_string), len(a_string), len(b_string))
        a_padded.append(a_string.center(pad_length))
        b_padded.append(b_string.center(pad_length))
        ops_padded.append(op_string.center(pad_length))
    print(separator.join(a_padded), file=file)
    print(separator.join(ops_padded), file=file)
    print(separator.join(b_padded), file=file)
