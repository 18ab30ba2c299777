"""Feature front end: log-mel filterbank (Fbank).

Counterpart of ``speechbrain_tpu/lobes/features.py`` (``Fbank``) with
deltas and context off, as the conformer recipes use it.
"""

import torch

from ..processing.features import STFT, Filterbank, spectral_magnitude

__all__ = ["Fbank"]


class Fbank(torch.nn.Module):
    """waveform (B, samples) -> log-mel features (B, frames, n_mels).

    Example
    -------
    >>> Fbank(n_mels=40)(torch.zeros(1, 16000)).shape
    torch.Size([1, 101, 40])
    """

    def __init__(self, sample_rate=16000, f_min=0, f_max=None, n_fft=400,
                 n_mels=40, filter_shape="triangular", win_length=25,
                 hop_length=10):
        super().__init__()
        if f_max is None:
            f_max = sample_rate / 2
        self.compute_STFT = STFT(
            sample_rate=sample_rate, n_fft=n_fft, win_length=win_length,
            hop_length=hop_length,
        )
        self.compute_fbanks = Filterbank(
            sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max, filter_shape=filter_shape,
        )

    def forward(self, wav):
        """wav: (B, samples) float32."""
        mag = spectral_magnitude(self.compute_STFT(wav), power=1)
        return self.compute_fbanks(mag)
