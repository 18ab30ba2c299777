"""Batch collation with padding and shape bucketing.

``PaddedBatch`` right-pads each array key to the batch max, or to a
bucketed shape (``BatchShapePolicy``: time, key and batch buckets).  A
copy of ``speechbrain_tpu/dataio/batch.py`` (the port imports nothing of
the JAX package).  Eager PyTorch does not need a bounded set of shapes,
but the recipe's bucketing stays: the relative lengths that the model
sees are relative to the bucketed time, and dummy rows of length 0 pad
the batch dim, with ``batch_mask`` 0.  Batches stay numpy on the host;
``core.Brain.prepare_batch`` moves ``numeric_dict()`` to the device.

Example
-------
>>> import numpy as np
>>> batch = PaddedBatch([
...     {"id": "ex1", "val": np.array([1.0])},
...     {"id": "ex2", "val": np.array([2.0, 1.0])},
... ])
>>> batch.id
['ex1', 'ex2']
>>> batch.val.data.shape
(2, 2)
>>> [float(x) for x in batch.val.lengths]
[0.5, 1.0]
"""

import collections

import numpy as np

from ..utils.data_utils import (
    batch_pad_right,
    ceil_to_bucket,
    mod_default_collate,
)

__all__ = ["PaddedData", "PaddedBatch", "BatchShapePolicy"]

PaddedData = collections.namedtuple("PaddedData", ["data", "lengths"])


class BatchShapePolicy:
    """Quantizes (batch, time) shapes to a fixed menu of buckets.

    Arguments
    ---------
    time_buckets : list[int] | None
        Sorted menu of time-dimension sizes; observed max length is
        rounded up to the nearest bucket.  None disables quantization.
    pad_batch_to : int | None
        If set, the batch dim is padded with all-zero rows (length 0)
        up to this size.
    time_keys : tuple[str] | None
        Keys the ``time_buckets`` menu applies to (e.g. ``("sig",)``).
        None (default) applies it to every padded key — fine when all
        padded keys share the time axis, wrong for mixed audio+token
        batches.
    key_buckets : dict[str, list[int]] | None
        Per-key bucket menus overriding ``time_buckets`` (e.g. a small
        power-of-two menu for token sequences).
    batch_buckets : list[int] | None
        Menu for the BATCH dimension: each batch is padded with
        zero-length dummy rows up to the nearest bucket.  Dummy rows
        carry ``batch_mask`` 0 (masked-loss convention).

    Example
    -------
    >>> policy = BatchShapePolicy(time_buckets=[4, 8])
    >>> policy.target_time(5)
    8
    >>> policy = BatchShapePolicy(
    ...     time_buckets=[100, 200], time_keys=("sig",),
    ...     key_buckets={"tokens": [8, 16]})
    >>> policy.target_time(150, key="sig"), policy.target_time(5, key="tokens")
    (200, 8)
    >>> policy.target_time(7, key="other")  # unscoped key: untouched
    7
    """

    def __init__(
        self,
        time_buckets=None,
        pad_batch_to=None,
        time_keys=None,
        key_buckets=None,
        batch_buckets=None,
    ):
        self.time_buckets = sorted(time_buckets) if time_buckets else None
        self.pad_batch_to = pad_batch_to
        self.time_keys = tuple(time_keys) if time_keys is not None else None
        self.key_buckets = (
            {k: sorted(v) for k, v in key_buckets.items()}
            if key_buckets
            else {}
        )
        self.batch_buckets = (
            sorted(batch_buckets) if batch_buckets else None
        )

    def target_batch(self, observed):
        """Quantized batch size (None = no batch quantization)."""
        if self.pad_batch_to is not None:
            return self.pad_batch_to
        if self.batch_buckets is None:
            return None
        return ceil_to_bucket(observed, self.batch_buckets)

    def target_time(self, observed_max, key=None):
        """Quantized target length for the observed maximum (per key)."""
        if key is not None and key in self.key_buckets:
            return ceil_to_bucket(observed_max, self.key_buckets[key])
        if self.time_keys is not None and key not in self.time_keys:
            return observed_max
        if self.time_buckets is None:
            return observed_max
        return ceil_to_bucket(observed_max, self.time_buckets)


class PaddedBatch:
    """Collate a list of example dicts; pad array values, list the rest.

    Array-valued keys (all examples arrays) become ``PaddedData(data,
    lengths)`` with relative lengths on the first dim.  Attribute-style
    access returns the collated value for a key.  ``numeric_dict()``
    returns the numeric subset that ``Brain.prepare_batch`` moves to the
    device.
    """

    def __init__(
        self,
        examples,
        padded_keys=None,
        padding_func=batch_pad_right,
        padding_kwargs={},
        nonpadded_stack=True,
        shape_policy=None,
    ):
        self.__length = len(examples)
        self.__keys = list(examples[0].keys())
        self.__padded_keys = []
        self.__dict = {}
        self.__pad_to = None
        policy = shape_policy
        real_batch = len(examples)
        pad_to = (
            policy.target_batch(real_batch) if policy is not None else None
        )
        if pad_to is not None and real_batch > pad_to:
            raise ValueError(
                f"Batch of {real_batch} exceeds batch target {pad_to}"
            )
        self.__pad_to = pad_to
        for key in self.__keys:
            values = [ex[key] for ex in examples]
            if isinstance(values[0], (np.ndarray, float, int)) and not isinstance(
                values[0], bool
            ):
                values = [np.asarray(v) for v in values]
            pad_this = (
                isinstance(values[0], np.ndarray)
                and values[0].ndim >= 1
                and (padded_keys is None or key in padded_keys)
            )
            if pad_this:
                target_shape = None
                if policy is not None and values[0].ndim >= 1:
                    observed = tuple(
                        max(v.shape[d] for v in values)
                        for d in range(values[0].ndim)
                    )
                    target_shape = (
                        policy.target_time(observed[0], key=key),
                    ) + observed[1:]
                if pad_to is not None:
                    # Dummy all-zero examples with zero length.
                    shape = target_shape or tuple(
                        max(v.shape[d] for v in values)
                        for d in range(values[0].ndim)
                    )
                    n_dummy = pad_to - real_batch
                    values = values + [
                        np.zeros((0,) + shape[1:], dtype=values[0].dtype)
                    ] * n_dummy
                    target_shape = shape
                padded = PaddedData(
                    *padding_func(
                        values, target_shape=target_shape, **padding_kwargs
                    )
                )
                self.__dict[key] = padded
                self.__padded_keys.append(key)
            else:
                if pad_to is not None:
                    n_dummy = pad_to - real_batch
                    if isinstance(values[0], np.ndarray):
                        values = values + [np.zeros_like(values[0])] * n_dummy
                    else:
                        values = values + [values[0]] * n_dummy
                if nonpadded_stack:
                    values = mod_default_collate(values)
                self.__dict[key] = values

    def __len__(self):
        return self.__length

    @property
    def batchsize(self):
        """Number of real (non-dummy) examples in the batch."""
        return self.__length

    def __getattr__(self, key):
        if key in self._PaddedBatch__dict:
            return self._PaddedBatch__dict[key]
        raise AttributeError(f"Batch doesn't have key: {key}")

    def __getitem__(self, key):
        return self.__dict[key]

    def __iter__(self):
        """Iterate over collated values in order (supports unpacking)."""
        return iter(self.__dict[key] for key in self.__keys)

    def __contains__(self, key):
        return key in self.__dict

    @property
    def batch_keys(self):
        """All collated keys."""
        return list(self.__keys)

    @property
    def padded_keys(self):
        """Keys that were padded (PaddedData values)."""
        return list(self.__padded_keys)

    def at_position(self, pos):
        """The collated value of the pos'th key."""
        key = self.__keys[pos]
        return self.__dict[key]

    def numeric_dict(self):
        """Flat dict of arrays: key -> data, key_lens -> lengths.

        When the batch dim was padded to a bucket, a ``batch_mask``
        (1 real / 0 dummy) is included so per-example losses can weight
        out the dummy rows.
        """
        out = {}
        for key in self.__keys:
            value = self.__dict[key]
            if isinstance(value, PaddedData):
                out[key] = value.data
                out[f"{key}_lens"] = value.lengths
            elif isinstance(value, np.ndarray):
                out[key] = value
        if (
            self.__pad_to is not None
            and self.__pad_to > self.__length
        ):
            mask = np.zeros(self.__pad_to, np.float32)
            mask[: self.__length] = 1.0
            out["batch_mask"] = mask
        return out
