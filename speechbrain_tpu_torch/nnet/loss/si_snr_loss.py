"""The SI-SNR loss between single-channel signals.

Counterpart of ``speechbrain_tpu/nnet/loss/si_snr_loss.py``
(``si_snr_loss``).
"""

import numpy as np
import torch

__all__ = ["si_snr_loss"]

_SMALL = float(np.finfo("float").eps)  # float64's machine epsilon, as in JAX


def si_snr_loss(y_pred_batch, y_true_batch, lens=None, reduction="mean"):
    """Negative scale-invariant SNR between (B, T[, 1]) signals, over the
    first ``floor(lens * T)`` samples of each (``lens`` relative; None:
    all), with eps = float64's machine epsilon and no zero-mean step, as
    in JAX.  ``reduction`` "mean" gives the batch mean, anything else the
    (B,) values.

    Example
    -------
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(
    ...     size=(2, 100)).astype(np.float32))
    >>> bool(si_snr_loss(x, x, torch.ones(2)) < -50)
    True
    """
    y_pred, y_true = y_pred_batch, y_true_batch
    if y_pred.dim() == 3:
        y_pred = y_pred[..., 0]
    if y_true.dim() == 3:
        y_true = y_true[..., 0]
    T = y_pred.shape[1]
    if lens is None:
        mask = torch.ones_like(y_pred)
    else:
        n = torch.floor(torch.as_tensor(lens, device=y_pred.device) * T)
        mask = (torch.arange(T, device=y_pred.device)[None, :]
                < n[:, None]).to(y_pred.dtype)
    s_target = y_true * mask
    s_estimate = y_pred * mask
    dot = (s_estimate * s_target).sum(1, keepdim=True)
    s_energy = (s_target ** 2).sum(1, keepdim=True) + _SMALL
    proj = dot * s_target / s_energy
    e_noise = s_estimate - proj
    before_log = ((proj ** 2) * mask).sum(1) / (
        ((e_noise ** 2) * mask).sum(1) + _SMALL)
    si_snr = 10 * torch.log10(before_log + _SMALL)
    if reduction == "mean":
        return -si_snr.mean()
    return -si_snr
