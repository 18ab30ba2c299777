"""Padding helpers.

``undo_padding`` is a copy of ``speechbrain_tpu/utils/data_utils.py``'s
(the port imports nothing of the JAX package).
"""

import numpy as np

__all__ = ["undo_padding"]


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
