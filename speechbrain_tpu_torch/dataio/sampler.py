"""Samplers: sequential, reproducible shuffling and token-budget
dynamic batching.

Copies of ``speechbrain_tpu/dataio/sampler.py``'s ``SequentialSampler``,
``ReproducibleRandomSampler`` and ``DynamicBatchSampler`` (the port
imports nothing of the JAX package).  They draw from numpy's
``default_rng`` exactly as the JAX package does, so both give the same
batches for the same seed and epoch.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["SequentialSampler", "ReproducibleRandomSampler",
           "DynamicBatchSampler"]


class SequentialSampler:
    """Yield indices 0..N-1 in order."""

    def __init__(self, data_source):
        self.data_source = data_source

    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class ReproducibleRandomSampler:
    """Seeded shuffling that changes deterministically per epoch.

    ``set_epoch`` changes the order: the effective seed is
    ``seed + epoch``.

    Example
    -------
    >>> s = ReproducibleRandomSampler(range(5), seed=17)
    >>> a = list(s)
    >>> b = list(s)   # same epoch -> same order
    >>> a == b
    True
    >>> s.set_epoch(1)
    >>> c = list(s)
    >>> a == c
    False
    """

    def __init__(self, data_source, seed=563375142, epoch=0):
        if not isinstance(seed, int):
            raise ValueError(
                f"The seed must be an integer value, got {seed}"
            )
        self.data_source = data_source
        self.seed = int(seed)
        self.epoch = epoch

    def set_epoch(self, epoch):
        """Change the epoch (and thereby the shuffle order)."""
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(len(self.data_source)).tolist())

    def __len__(self):
        return len(self.data_source)


class DynamicBatchSampler:
    """Token-budget batching by length buckets.

    Examples are assigned to buckets by length; each bucket's batch size
    is ``max_batch_length // boundary`` so every batch costs at most
    ``max_batch_length`` padded tokens.  The boundaries are a fixed
    menu, which a downstream ``BatchShapePolicy(time_buckets=
    sampler.bucket_boundaries)`` pads each batch's time axis to.

    Arguments
    ---------
    dataset : DynamicItemDataset
        Lengths are read from the manifest rows, NOT by loading audio.
    max_batch_length : int
        Token budget per batch (in length_func units).
    num_buckets : int, optional
        Number of buckets when boundaries are derived automatically.
    length_func : callable
        Maps a manifest row dict to a length (default: x["duration"]).
    shuffle : bool
        Shuffle examples (and batches) per epoch, seeded.
    batch_ordering : "random" | "ascending" | "descending" | "random_runs"
        "random_runs" shuffles like "random" but keeps same-bucket
        batches together in runs of up to ``run_length`` — feeding the
        ``steps_per_execute`` windows batches of one shape while
        remaining epoch-shuffled.
    max_batch_ex : int, optional
        Cap on examples per batch.
    run_length : int
        Run size for "random_runs" (match ``steps_per_execute``).
    bucket_boundaries : list, optional
        Explicit boundaries, overrides num_buckets.
    lengths_list : list, optional
        Explicit lengths (overrides length_func).
    epoch, seed, drop_last : as usual.
    """

    def __init__(
        self,
        dataset,
        max_batch_length,
        num_buckets=None,
        length_func=lambda x: x["duration"],
        shuffle=True,
        batch_ordering="random",
        max_batch_ex=None,
        bucket_boundaries=[],
        lengths_list=None,
        seed=42,
        epoch=0,
        drop_last=False,
        verbose=False,
        run_length=8,
    ):
        self._run_length = max(1, int(run_length))
        self._dataset = dataset
        self._ex_lengths = {}
        ex_ids = self._dataset.data_ids
        self.verbose = verbose

        if lengths_list is not None:
            for indx in range(len(lengths_list)):
                self._ex_lengths[str(indx)] = lengths_list[indx]
        else:
            for indx in range(len(self._dataset)):
                self._ex_lengths[str(indx)] = length_func(
                    self._dataset.data[ex_ids[indx]]
                )

        if bucket_boundaries:
            if not all([x >= 1 for x in bucket_boundaries]):
                raise ValueError(
                    "All elements in bucket boundaries should be >= 1."
                )
            if len(set(bucket_boundaries)) != len(bucket_boundaries):
                raise ValueError(
                    "Bucket_boundaries should not contain duplicates."
                )
            self._bucket_boundaries = np.array(sorted(bucket_boundaries))
        else:
            if num_buckets is None:
                raise ValueError(
                    "Please specify either num_buckets or bucket_boundaries"
                )
            self._bucket_boundaries = np.array(
                self._get_boundaries_through_warping(
                    max_batch_length=max_batch_length,
                    num_quantiles=num_buckets,
                )
            )

        self._max_batch_length = max_batch_length
        self._shuffle_ex = shuffle
        self._batch_ordering = batch_ordering
        self._seed = seed
        self._drop_last = drop_last
        if max_batch_ex is None:
            max_batch_ex = np.inf
        self._max_batch_ex = max_batch_ex
        # Batch size for each bucket (index len(boundaries) is the
        # catch-all bucket of batch size 1).
        self._bucket_lens = [
            max(1, int(max_batch_length / self._bucket_boundaries[i]))
            for i in range(len(self._bucket_boundaries))
        ] + [1]
        self._epoch = epoch
        self._generate_batches()

    @property
    def bucket_boundaries(self):
        """The time-bucket menu for BatchShapePolicy quantization."""
        return [int(np.ceil(b)) for b in self._bucket_boundaries] + [
            int(np.ceil(max(self._ex_lengths.values())))
        ]

    def get_durations(self, batch):
        """Durations (seconds) of the given example ids."""
        return [self._ex_lengths[str(idx)] for idx in batch]

    def _get_boundaries_through_warping(
        self, max_batch_length, num_quantiles
    ):
        """Lognormal-quantile bucket boundaries scaled to max_batch_length.

        """
        from scipy.stats import lognorm

        logger.info("Batch quantisation in latent space")
        # reference spacing: linspace(1/(Q+1), Q/(Q+1), Q)
        num_boundaries = num_quantiles + 1
        latent_boundaries = np.linspace(
            1 / num_boundaries,
            num_quantiles / num_boundaries,
            num_quantiles,
        )
        bucket_boundaries = lognorm.ppf(latent_boundaries, 1)
        bucket_boundaries = (
            bucket_boundaries * max_batch_length / bucket_boundaries[-1]
        )
        return list(sorted(bucket_boundaries))

    def _permute_batches(self):
        if self._batch_ordering == "random":
            rng = np.random.default_rng(self._seed + self._epoch)
            perm = rng.permutation(len(self._batches))
            self._batches = [self._batches[i] for i in perm]
        elif self._batch_ordering == "random_runs":
            # Shuffle, but emit same-shaped batches in runs of up to
            # run_length so fused multi-step windows stay full.
            rng = np.random.default_rng(self._seed + self._epoch)
            by_sig = {}
            for i, b in enumerate(self._batches):
                maxlen = max(self._ex_lengths[str(x)] for x in b)
                sig = (
                    len(b),
                    int(np.searchsorted(self._bucket_boundaries, maxlen)),
                )
                by_sig.setdefault(sig, []).append(i)
            runs = []
            for idxs in by_sig.values():
                rng.shuffle(idxs)
                for j in range(0, len(idxs), self._run_length):
                    runs.append(idxs[j : j + self._run_length])
            rng.shuffle(runs)
            self._batches = [
                self._batches[i] for run in runs for i in run
            ]
        elif self._batch_ordering in ("ascending", "descending"):
            reverse = self._batch_ordering == "descending"
            self._batches = sorted(
                self._batches,
                key=lambda b: max(
                    self._ex_lengths[str(i)] for i in b
                ),
                reverse=reverse,
            )
        else:
            raise NotImplementedError(
                f"Unknown batch_ordering: {self._batch_ordering}"
            )

    def _generate_batches(self):
        if self._shuffle_ex:
            rng = np.random.default_rng(self._seed + self._epoch)
            sampler = rng.permutation(len(self._dataset)).tolist()
        else:
            sampler = range(len(self._dataset))

        self._batches = []
        bucket_batches = [[] for _ in self._bucket_lens]
        for idx in sampler:
            item_len = self._ex_lengths[str(idx)]
            # Left bucket whose boundary >= item_len.
            bucket_id = int(
                np.searchsorted(self._bucket_boundaries, item_len)
            )
            bucket_batches[bucket_id].append(idx)
            if (
                len(bucket_batches[bucket_id])
                >= self._bucket_lens[bucket_id]
                or len(bucket_batches[bucket_id]) >= self._max_batch_ex
            ):
                self._batches.append(bucket_batches[bucket_id])
                bucket_batches[bucket_id] = []
        if not self._drop_last:
            for batch in bucket_batches:
                if batch:
                    self._batches.append(batch)
        self._permute_batches()

    def __iter__(self):
        for batch in self._batches:
            yield batch
        if self._shuffle_ex:
            self._generate_batches()
        if self._batch_ordering in ("random", "random_runs"):
            self._permute_batches()

    def set_epoch(self, epoch):
        """Set the epoch for deterministic reshuffling."""
        self._epoch = epoch
        self._generate_batches()

    def __len__(self):
        return len(self._batches)
