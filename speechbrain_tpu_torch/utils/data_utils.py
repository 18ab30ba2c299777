"""Host-side padding helpers (numpy).

Copies of ``speechbrain_tpu/utils/data_utils.py``'s ``pad_right_to``,
``batch_pad_right``, ``mod_default_collate``, ``undo_padding`` and
``ceil_to_bucket`` (the port imports nothing of the JAX package).  The
data path builds its batches on the host in numpy, as the JAX package
does, and ``core.Brain.prepare_batch`` moves them to the device.
"""

import numpy as np

__all__ = ["pad_right_to", "batch_pad_right", "mod_default_collate",
           "undo_padding", "ceil_to_bucket"]


def pad_right_to(array, target_shape, mode="constant", value=0.0):
    """Pad ``array`` (numpy) on the right of each dim up to ``target_shape``.

    Returns (padded, valid_percent) where valid_percent[i] is the fraction
    of dim i that holds real data — the relative-length convention used
    throughout the framework.

    Example
    -------
    >>> x, valid = pad_right_to(np.ones((2, 3)), (4, 5))
    >>> x.shape
    (4, 5)
    >>> valid
    [0.5, 0.6]
    """
    array = np.asarray(array)
    if len(target_shape) != array.ndim:
        raise ValueError("target_shape must match number of dims")
    pads = []
    valid_percent = []
    for i, target in enumerate(target_shape):
        if target < array.shape[i]:
            raise ValueError(
                f"Target shape {target_shape} smaller than input {array.shape}"
            )
        pads.append((0, target - array.shape[i]))
        valid_percent.append(array.shape[i] / target)
    padded = np.pad(array, pads, mode=mode, constant_values=value)
    return padded, valid_percent


def batch_pad_right(arrays, mode="constant", value=0.0, target_shape=None):
    """Stack a list of numpy arrays, right-padding each to the batch max.

    Returns (batched, relative_lengths) where relative_lengths is the
    per-example fraction of the *first* dimension that is real data.

    Arguments
    ---------
    target_shape : tuple, optional
        Pad every example to this shape instead of the observed max —
        used for bucketed shapes (``dataio.batch.BatchShapePolicy``).
    """
    if not len(arrays):
        raise IndexError("Cannot batch empty list")
    arrays = [np.asarray(a) for a in arrays]
    if any(a.ndim != arrays[0].ndim for a in arrays):
        raise IndexError("All examples must have the same number of dims")
    if arrays[0].ndim == 0:
        return np.stack(arrays), np.ones(len(arrays), dtype=np.float32)
    if target_shape is None:
        target_shape = tuple(
            max(a.shape[dim] for a in arrays) for dim in range(arrays[0].ndim)
        )
    if mode == "constant":
        # One allocation and per-row slice copies instead of per-row
        # np.pad + np.stack.
        for a in arrays:
            for dim, target in enumerate(target_shape):
                if target < a.shape[dim]:
                    raise ValueError(
                        f"Target shape {target_shape} smaller than "
                        f"input {a.shape}"
                    )
        dtype = np.result_type(*[a.dtype for a in arrays])
        full_shape = (len(arrays),) + tuple(target_shape)
        if value == 0:
            # np.zeros gets calloc'd zero pages (no write pass);
            # np.full writes every byte.
            out = np.zeros(full_shape, dtype)
        else:
            out = np.full(full_shape, value, dtype)
        valid = np.empty(len(arrays), dtype=np.float32)
        for i, a in enumerate(arrays):
            out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
            valid[i] = a.shape[0] / target_shape[0]
        return out, valid
    padded, valid = [], []
    for a in arrays:
        p, v = pad_right_to(a, target_shape, mode=mode, value=value)
        padded.append(p)
        valid.append(v[0])
    return np.stack(padded), np.asarray(valid, dtype=np.float32)


def mod_default_collate(batch):
    """Collate a list of equal-shape elements into a stacked numpy array.

    Non-array leaves are returned as a plain list.
    """
    elem = batch[0]
    if isinstance(elem, np.ndarray):
        return np.stack(batch)
    if isinstance(elem, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(elem, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return batch


def undo_padding(batch, lengths):
    """Trim padded rows back to python lists of their true length.

    Example
    -------
    >>> undo_padding(np.array([[1, 2, 0], [3, 4, 5]]), np.array([2/3, 1.0]))
    [[1, 2], [3, 4, 5]]
    """
    batch = np.asarray(batch)
    lengths = np.asarray(lengths)
    batch_max_len = batch.shape[1]
    as_list = []
    for seq, rel_length in zip(batch, lengths):
        actual_size = int(round(float(rel_length) * batch_max_len))
        as_list.append(seq[:actual_size].tolist())
    return as_list


def ceil_to_bucket(n, buckets):
    """Smallest bucket >= n; buckets must be sorted ascending.

    Time and batch dims are rounded up to a fixed menu (the recipe's
    bucketing, which sets the relative lengths the model sees).

    Example
    -------
    >>> ceil_to_bucket(130, [128, 256, 512])
    256
    """
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"Length {n} exceeds largest bucket {buckets[-1]}")
