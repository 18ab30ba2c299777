"""Label <-> index encoders, with save/load and special tokens.

A copy of ``speechbrain_tpu/dataio/encoder.py`` (``CategoricalEncoder``,
``TextEncoder`` with BOS/EOS, ``CTCTextEncoder`` with the CTC blank):
the same dataset gives every label the same index as in the JAX
package, and the label files are the same format, so a file written by
one package loads in the other.

Example
-------
>>> enc = CategoricalEncoder()
>>> _ = enc.update_from_iterable(["spk0", "spk1", "spk2"])
>>> enc.encode_label("spk1")
1
>>> enc.decode_ndim([2, 0])
['spk2', 'spk0']
"""

import ast
import collections
import itertools
import logging
import os

import numpy as np

from ..utils.distributed import ddp_barrier, if_main_process

logger = logging.getLogger(__name__)

__all__ = ["CategoricalEncoder", "TextEncoder", "CTCTextEncoder"]

DEFAULT_UNK = "<unk>"
DEFAULT_BOS = "<bos>"
DEFAULT_EOS = "<eos>"
DEFAULT_BLANK = "<blank>"


class CategoricalEncoder:
    """Encode a finite label set to integers 0..N-1."""

    VALUE_SEPARATOR = " => "
    EXTRAS_SEPARATOR = "================\n"

    def __init__(self, starting_index=0, **special_labels):
        self.lab2ind = {}
        self.ind2lab = {}
        self.starting_index = starting_index
        self.handle_special_labels(special_labels)

    def handle_special_labels(self, special_labels):
        """Insert special labels (blank/bos/eos/unk) per the dict."""
        if "unk_label" in special_labels:
            self.add_unk(special_labels["unk_label"])

    def __len__(self):
        return len(self.lab2ind)

    def is_continuous(self):
        """True if indices form a contiguous range from starting_index."""
        minval = min(self.ind2lab.keys(), default=self.starting_index)
        return self.starting_index == minval and all(
            j - i == 1
            for i, j in zip(
                sorted(self.ind2lab.keys()), sorted(self.ind2lab.keys())[1:]
            )
        )

    def update_from_iterable(self, iterable, sequence_input=False):
        """Collect labels from an iterable (of labels, or of sequences)."""
        if sequence_input:
            label_iterator = itertools.chain.from_iterable(iterable)
        else:
            label_iterator = iter(iterable)
        for label in label_iterator:
            self.ensure_label(label)
        return self

    def update_from_didataset(
        self, didataset, output_key, sequence_input=False
    ):
        """Collect labels by computing one key over a DynamicItemDataset."""
        with didataset.output_keys_as([output_key]):
            self.update_from_iterable(
                (data_point[output_key] for data_point in _iter_dataset(didataset)),
                sequence_input=sequence_input,
            )
        return self

    def limited_labelset_from_iterable(
        self, iterable, sequence_input=False, n_most_common=None, min_count=1
    ):
        """Keep only frequent-enough labels (vocab truncation)."""
        if sequence_input:
            label_iterator = itertools.chain.from_iterable(iterable)
        else:
            label_iterator = iter(iterable)
        counts = collections.Counter(label_iterator)
        for label, count in counts.most_common(n_most_common):
            if count < min_count:
                break
            self.ensure_label(label)
        return counts

    def add_label(self, label):
        """Add a new label; error if it exists."""
        if label in self.lab2ind:
            raise KeyError(f"Label already present: {label}")
        index = self._next_index()
        self.lab2ind[label] = index
        self.ind2lab[index] = label
        return index

    def ensure_label(self, label):
        """Add a label if not already present."""
        if label not in self.lab2ind:
            self.add_label(label)

    def insert_label(self, label, index):
        """Add a new label at a specific index; error if label exists."""
        if label in self.lab2ind:
            raise KeyError(f"Label already present: {label}")
        self.enforce_label(label, index)

    def enforce_label(self, label, index):
        """Place label at index, evicting/moving any current occupant."""
        index = int(index)
        if label in self.lab2ind:
            if index == self.lab2ind[label]:
                return
            del self.ind2lab[self.lab2ind[label]]
        if index in self.ind2lab:
            saved_label = self.ind2lab[index]
            moving_other = True
        else:
            moving_other = False
        self.lab2ind[label] = index
        self.ind2lab[index] = label
        if moving_other:
            new_index = self._next_index()
            self.lab2ind[saved_label] = new_index
            self.ind2lab[new_index] = saved_label

    def _next_index(self):
        index = self.starting_index
        while index in self.ind2lab:
            index += 1
        return index

    def add_unk(self, unk_label=DEFAULT_UNK):
        """Add an unknown-label catch-all."""
        self.unk_label = unk_label
        return self.add_label(unk_label)

    def encode_label(self, label, allow_unk=True):
        """One label -> int."""
        try:
            return self.lab2ind[label]
        except KeyError:
            if hasattr(self, "unk_label") and allow_unk:
                return self.lab2ind[self.unk_label]
            raise KeyError(
                f"Unknown label {label}, and no unk_label set"
            )

    def encode_label_np(self, label, allow_unk=True):
        """encode_label returning a numpy array."""
        return np.array(self.encode_label(label, allow_unk), dtype=np.int64)

    def encode_sequence(self, sequence, allow_unk=True):
        """Sequence of labels -> list of ints."""
        return [self.encode_label(label, allow_unk) for label in sequence]

    def encode_sequence_np(self, sequence, allow_unk=True):
        """encode_sequence returning a numpy array."""
        return np.array(self.encode_sequence(sequence, allow_unk), dtype=np.int64)

    def decode_ndim(self, x):
        """Decode arbitrarily nested int containers/arrays to labels.

        Indices outside the inventory decode to ``<id=N>`` instead of
        raising: models whose output layer is wider than the label set
        can argmax onto unmapped logits early in training, and error
        metrics should record (not crash on) those hypotheses.
        """
        try:
            return [self.decode_ndim(subtensor) for subtensor in x]
        except TypeError:
            idx = int(x)
            if idx in self.ind2lab:
                return self.ind2lab[idx]
            return f"<id={idx}>"

    def expect_len(self, expected_len):
        """Assert the vocabulary has the expected size (guards against
        accidental re-fitting with different data)."""
        if len(self) != expected_len:
            raise ValueError(
                f"Categorical encoder has {len(self)} labels, expected "
                f"{expected_len}"
            )

    # -- persistence -------------------------------------------------------

    def save(self, path):
        """Write label<->index mapping + extras to a text file."""
        extras = self._get_extras()
        with open(path, "w") as f:
            for label, ind in self.lab2ind.items():
                f.write(f"{repr(label)}{self.VALUE_SEPARATOR}{ind}\n")
            f.write(self.EXTRAS_SEPARATOR)
            for key, value in extras.items():
                f.write(f"{key}{self.VALUE_SEPARATOR}{repr(value)}\n")

    def load(self, path):
        """Load mapping written by save()."""
        lab2ind = {}
        extras = {}
        with open(path) as f:
            lines = iter(f)
            for line in lines:
                if line == self.EXTRAS_SEPARATOR:
                    break
                literal, ind = line.strip().rsplit(self.VALUE_SEPARATOR, 1)
                label = ast.literal_eval(literal)
                lab2ind[label] = int(ind)
            for line in lines:
                key, literal = line.strip().split(self.VALUE_SEPARATOR, 1)
                extras[key] = ast.literal_eval(literal)
        self.lab2ind = lab2ind
        self.ind2lab = {ind: label for label, ind in lab2ind.items()}
        self._set_extras(extras)

    def load_if_possible(self, path):
        """Load if the file exists; returns success bool."""
        if os.path.isfile(path):
            try:
                self.load(path)
                return True
            except Exception as e:  # pragma: no cover
                logger.warning(f"Could not load encoder from {path}: {e}")
        return False

    def load_or_create(
        self,
        path,
        from_iterables=[],
        from_didatasets=[],
        sequence_input=False,
        output_key=None,
        special_labels={},
    ):
        """Load from file if present, else fit and save."""
        if not self.load_if_possible(path):
            for iterable in from_iterables:
                self.update_from_iterable(iterable, sequence_input)
            for didataset in from_didatasets:
                self.update_from_didataset(
                    didataset, output_key, sequence_input
                )
            self.handle_special_labels(special_labels)
            if if_main_process():
                self.save(path)
            ddp_barrier()
        return self

    def _get_extras(self):
        extras = {"starting_index": self.starting_index}
        if hasattr(self, "unk_label"):
            extras["unk_label"] = self.unk_label
        return extras

    def _set_extras(self, extras):
        if "unk_label" in extras:
            self.unk_label = extras["unk_label"]
        self.starting_index = extras.get("starting_index", 0)


def _iter_dataset(didataset):
    for i in range(len(didataset)):
        yield didataset[i]


class TextEncoder(CategoricalEncoder):
    """CategoricalEncoder + BOS/EOS token handling for seq2seq text."""

    def handle_special_labels(self, special_labels):
        """Insert special labels (blank/bos/eos/unk) per the dict."""
        super().handle_special_labels(special_labels)
        if "bos_label" in special_labels and "eos_label" in special_labels:
            if special_labels["bos_label"] == special_labels["eos_label"]:
                self.insert_bos_eos(
                    bos_label=special_labels["bos_label"],
                    eos_label=special_labels["eos_label"],
                )
            else:
                self.add_bos_eos(
                    bos_label=special_labels["bos_label"],
                    eos_label=special_labels["eos_label"],
                )

    def add_bos_eos(self, bos_label=DEFAULT_BOS, eos_label=DEFAULT_EOS):
        """Add distinct (or same) BOS/EOS labels at the next indices."""
        if bos_label == eos_label:
            self.add_label(bos_label)
            self.bos_label = bos_label
            self.eos_label = eos_label
        else:
            self.add_label(bos_label)
            self.add_label(eos_label)
            self.bos_label = bos_label
            self.eos_label = eos_label

    def insert_bos_eos(
        self,
        bos_label=DEFAULT_BOS,
        eos_label=DEFAULT_EOS,
        bos_index=0,
        eos_index=None,
    ):
        """Insert BOS/EOS at specific indices (default both at 0/1)."""
        if bos_label == eos_label:
            self.insert_label(bos_label, bos_index)
        else:
            self.insert_label(bos_label, bos_index)
            if eos_index is None:
                eos_index = bos_index + 1
            self.insert_label(eos_label, eos_index)
        self.bos_label = bos_label
        self.eos_label = eos_label

    def get_bos_index(self):
        """Index of the BOS label."""
        return self.lab2ind[self.bos_label]

    def get_eos_index(self):
        """Index of the EOS label."""
        return self.lab2ind[self.eos_label]

    def prepend_bos_label(self, x):
        """Prepend BOS to a label sequence (host-side list)."""
        return [self.bos_label] + list(x)

    def prepend_bos_index(self, x):
        """Prepend BOS index to an index sequence."""
        return [self.get_bos_index()] + list(x)

    def append_eos_label(self, x):
        """Append the EOS label."""
        return list(x) + [self.eos_label]

    def append_eos_index(self, x):
        """Append the EOS label at the given index."""
        return list(x) + [self.get_eos_index()]

    def _get_extras(self):
        extras = super()._get_extras()
        if hasattr(self, "bos_label"):
            extras["bos_label"] = self.bos_label
            extras["eos_label"] = self.eos_label
        return extras

    def _set_extras(self, extras):
        super()._set_extras(extras)
        if "bos_label" in extras:
            self.bos_label = extras["bos_label"]
            self.eos_label = extras["eos_label"]


class CTCTextEncoder(TextEncoder):
    """TextEncoder + CTC blank handling."""

    def handle_special_labels(self, special_labels):
        """Insert special labels (blank/bos/eos/unk) per the dict."""
        super().handle_special_labels(special_labels)
        if "blank_label" in special_labels:
            self.insert_blank(
                special_labels["blank_label"],
                special_labels.get("blank_index", 0),
            )

    def add_blank(self, blank_label=DEFAULT_BLANK):
        """Append the CTC blank label."""
        self.add_label(blank_label)
        self.blank_label = blank_label

    def insert_blank(self, blank_label=DEFAULT_BLANK, index=0):
        """Insert the CTC blank label at the given index."""
        self.insert_label(blank_label, index)
        self.blank_label = blank_label

    def get_blank_index(self):
        """Index of the CTC blank label."""
        return self.lab2ind[self.blank_label]

    def collapse_labels(self, x, merge_repeats=True):
        """CTC collapse on labels: merge repeats, drop blanks."""
        if merge_repeats:
            x = [
                label
                for i, label in enumerate(x)
                if i == 0 or label != x[i - 1]
            ]
        return [label for label in x if label != self.blank_label]

    def collapse_indices_ndim(self, x, merge_repeats=True):
        """CTC collapse on (nested) index sequences."""
        try:
            iter(x[0] if len(x) else [])
            is_nested = len(x) > 0 and not isinstance(x[0], (int, np.integer))
        except TypeError:
            is_nested = False
        if is_nested:
            return [
                self.collapse_indices_ndim(sub, merge_repeats) for sub in x
            ]
        blank_index = self.get_blank_index()
        if merge_repeats:
            x = [
                int(idx)
                for i, idx in enumerate(x)
                if i == 0 or idx != x[i - 1]
            ]
        return [int(idx) for idx in x if idx != blank_index]

    def _get_extras(self):
        extras = super()._get_extras()
        if hasattr(self, "blank_label"):
            extras["blank_label"] = self.blank_label
        return extras

    def _set_extras(self, extras):
        super()._set_extras(extras)
        if "blank_label" in extras:
            self.blank_label = extras["blank_label"]
