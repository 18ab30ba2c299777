"""Device resolution: CUDA by default, the CPU only when asked for."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """Return the ``torch.device`` to run on.

    ``None`` means the first CUDA card; it raises when there is none,
    so a caller never ends up on the CPU without asking for it.  Any
    other value (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken
    as given.

    Example
    -------
    >>> resolve_device("cpu")
    device(type='cpu')
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
