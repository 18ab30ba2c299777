"""Token embedding, with the one-hot blank mode of transducer prediction
networks.

Counterpart of ``speechbrain_tpu/nnet/embedding.py`` (``Embedding``): a
lookup table ``weight (num_embeddings, embedding_dim)`` (the Flax
``Embed_0.embedding``), or, with ``consider_as_one_hot``, fixed one-hot
vectors of width ``num_embeddings - 1`` with ``blank_id`` mapped to the
zero vector (no parameters).
"""

import math

import torch
import torch.nn.functional as F

__all__ = ["Embedding"]


class Embedding(torch.nn.Module):
    """Lookup embedding of int token ids: (...) -> (..., embedding_dim)
    float32.

    Example
    -------
    >>> Embedding(5, 3)(torch.tensor([[0, 1]])).shape
    torch.Size([1, 2, 3])
    >>> Embedding(4, consider_as_one_hot=True)(torch.tensor([0, 2])).tolist()
    [[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    """

    def __init__(self, num_embeddings, embedding_dim=128,
                 consider_as_one_hot=False, blank_id=0):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.consider_as_one_hot = consider_as_one_hot
        self.blank_id = blank_id
        if consider_as_one_hot:
            self.embedding_dim = num_embeddings - 1
            self.weight = None
        else:
            self.embedding_dim = embedding_dim
            self.weight = torch.nn.Parameter(
                torch.randn(num_embeddings, embedding_dim)
                / math.sqrt(embedding_dim))

    def forward(self, x):
        """x: int token ids of any shape."""
        x = x.long()
        if self.consider_as_one_hot:
            cols = [i for i in range(self.num_embeddings) if i != self.blank_id]
            one_hot = F.one_hot(x, self.num_embeddings).float()
            return one_hot[..., torch.tensor(cols, device=x.device)]
        return F.embedding(x, self.weight)
