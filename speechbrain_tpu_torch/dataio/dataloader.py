"""Prefetching dataloader with a checkpointable position.

Copies of ``speechbrain_tpu/dataio/dataloader.py``'s ``DataLoader``,
``SaveableDataLoader`` and ``make_dataloader`` (the port imports nothing
of the JAX package).  Worker threads evaluate the per-example pipeline
and collate batches (numpy, on the host), in order, a bounded number
ahead of the consumer; the device transfer happens in the Brain
(``core.Brain.prepare_batch``).  ``SaveableDataLoader`` saves the
position that training has consumed (``Brain._staged_iter`` hands it
over when a staging thread runs the loader ahead), so a mid-epoch
checkpoint resumes with exactly the batches not yet trained on.
"""

import logging
import threading

from ..utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)
from .batch import PaddedBatch
from .dataset import DynamicItemDataset
from .sampler import ReproducibleRandomSampler, SequentialSampler

logger = logging.getLogger(__name__)

__all__ = ["DataLoader", "SaveableDataLoader", "make_dataloader"]


class DataLoader:
    """Iterates a dataset in collated batches.

    Arguments
    ---------
    dataset : map-style dataset (``__getitem__``/``__len__``) or iterable
    batch_size : int
    shuffle : bool
        Use a ReproducibleRandomSampler when no sampler given.
    sampler : example sampler, optional
    batch_sampler : yields lists of indices, optional
    collate_fn : callable, default PaddedBatch
    drop_last : bool
    num_workers : int
        Worker THREADS computing examples (audio decode releases the
        GIL in numpy/file IO).  0 = synchronous.
    prefetch_batches : int
        Bounded queue depth of collated batches prepared ahead.
    """

    def __init__(
        self,
        dataset,
        batch_size=1,
        shuffle=False,
        sampler=None,
        batch_sampler=None,
        collate_fn=None,
        drop_last=False,
        num_workers=0,
        prefetch_batches=2,
        seed=563375142,
        **kwargs,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = max(1, prefetch_batches)
        if collate_fn is None:
            if isinstance(dataset, DynamicItemDataset) or (
                hasattr(dataset, "__getitem__")
                and hasattr(dataset, "pipeline")
            ):
                collate_fn = PaddedBatch
            else:
                collate_fn = _identity_collate
        self.collate_fn = collate_fn
        if batch_sampler is not None:
            if sampler is not None or shuffle:
                raise ValueError(
                    "batch_sampler is mutually exclusive with sampler/shuffle"
                )
            self.batch_sampler = batch_sampler
            self.sampler = None
        else:
            if sampler is None:
                if shuffle:
                    sampler = ReproducibleRandomSampler(dataset, seed=seed)
                else:
                    sampler = SequentialSampler(dataset)
            self.sampler = sampler
            self.batch_sampler = None

    def _batches_of_indices(self):
        if self.batch_sampler is not None:
            yield from iter(self.batch_sampler)
            return
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, indices):
        examples = [self.dataset[i] for i in indices]
        return self.collate_fn(examples)

    def __iter__(self):
        if self.num_workers <= 0:
            for indices in self._batches_of_indices():
                yield self._make_batch(indices)
            return
        yield from self._prefetching_iter(skip_batches=0)

    def _prefetching_iter(self, skip_batches=0):
        """Ordered multi-worker prefetching.

        ``num_workers`` threads each claim whole batches (index lists)
        from a shared iterator and run decode + pipeline + collate
        concurrently (the native decoders and numpy's file reads release
        the GIL, so batch building runs in parallel).  Batches are emitted to
        the consumer IN ORDER (checkpoint positions stay exact); a
        worker runs at most ``prefetch_batches`` ahead of the consumer
        to bound memory.
        """
        n_workers = max(1, int(self.num_workers))
        window = max(int(self.prefetch_batches), n_workers)
        stop = threading.Event()
        lock = threading.Lock()  # guards job_iter
        cond = threading.Condition()  # guards results / counters
        job_iter = enumerate(self._batches_of_indices())
        results = {}
        state = {"next": skip_batches, "active": n_workers}

        def worker():
            try:
                while not stop.is_set():
                    with lock:
                        try:
                            i, indices = next(job_iter)
                        except StopIteration:
                            break
                    if i < skip_batches:
                        continue
                    with cond:
                        while (
                            i - state["next"] >= window
                            and not stop.is_set()
                        ):
                            cond.wait(0.2)
                    if stop.is_set():
                        break
                    batch = self._make_batch(indices)
                    with cond:
                        results[i] = (batch, None)
                        cond.notify_all()
            except Exception as e:
                with cond:
                    results[i] = (None, e)
                    cond.notify_all()
            finally:
                with cond:
                    state["active"] -= 1
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(n_workers)
        ]
        for t in threads:
            t.start()
        try:
            while True:
                with cond:
                    i = state["next"]
                    while i not in results and state["active"] > 0:
                        cond.wait(0.2)
                    if i not in results:
                        break  # all workers done: epoch exhausted
                    batch, err = results.pop(i)
                    state["next"] = i + 1
                    cond.notify_all()
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()


def _identity_collate(examples):
    return examples


@register_checkpoint_hooks
class SaveableDataLoader(DataLoader):
    """DataLoader that checkpoints its mid-epoch iteration position.

    On recovery inside an epoch, the loader skips ahead to the saved
    batch position (indices are re-drawn from the same seeded sampler,
    so the skipped examples are exactly those already trained on).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._speechbrain_recovery_skip_to = None
        self._speechbrain_iterator_position = None
        # Set by Brain._staged_iter: the position actually CONSUMED by
        # training when a staging thread runs this loader ahead of the
        # fit loop (saving the raw iterator position would over-report
        # progress by up to staging_depth batches on mid-epoch resume).
        self._speechbrain_staged_position = None

    def __iter__(self):
        skip = 0
        if self._speechbrain_recovery_skip_to is not None:
            skip = self._speechbrain_recovery_skip_to
            self._speechbrain_recovery_skip_to = None
            logger.info(f"Dataloader skipping {skip} batches after recovery")
        self._speechbrain_iterator_position = skip
        if self.num_workers <= 0:
            for i, indices in enumerate(self._batches_of_indices()):
                if i < skip:
                    continue
                batch = self._make_batch(indices)
                self._speechbrain_iterator_position = i + 1
                yield batch
        else:
            for batch in self._prefetching_iter(skip_batches=skip):
                self._speechbrain_iterator_position += 1
                yield batch
        self._speechbrain_iterator_position = None

    @mark_as_saver
    def _save(self, path):
        pos = getattr(self, "_speechbrain_staged_position", None)
        if pos is None:
            pos = self._speechbrain_iterator_position
        with open(path, "w") as f:
            f.write(str(pos if pos is not None else -1))

    @mark_as_loader
    def _recover(self, path, end_of_epoch=True):
        with open(path) as f:
            pos = int(f.read())
        if end_of_epoch or pos < 0:
            self._speechbrain_recovery_skip_to = None
        else:
            self._speechbrain_recovery_skip_to = pos


def make_dataloader(dataset, **loader_kwargs):
    """Make a loader for a map-style ``dataset`` (the Brain calls this).

    DynamicItemDatasets get PaddedBatch collation automatically; pass
    ``shape_policy`` through ``collate_kwargs`` for bucketed shapes.
    Streaming sources and nominal epochs (the JAX package's
    ``SaveableStreamLoader`` and ``LoopedLoader``) are not ported.
    """
    collate_kwargs = loader_kwargs.pop("collate_kwargs", None)
    if collate_kwargs and "collate_fn" not in loader_kwargs:
        loader_kwargs["collate_fn"] = lambda ex: PaddedBatch(
            ex, **collate_kwargs
        )
    if not hasattr(dataset, "__getitem__"):
        raise NotImplementedError(
            "streaming datasets are not ported: pass a map-style dataset")
    return SaveableDataLoader(dataset, **loader_kwargs)
