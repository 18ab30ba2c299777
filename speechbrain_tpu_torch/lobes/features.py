"""Feature front end: log-mel filterbank (Fbank), with optional deltas
and context windows.

Counterpart of ``speechbrain_tpu/lobes/features.py`` (``Fbank``).
"""

import torch

from ..processing.features import (
    STFT,
    ContextWindow,
    Deltas,
    Filterbank,
    spectral_magnitude,
)

__all__ = ["Fbank"]


class Fbank(torch.nn.Module):
    """waveform (B, samples) -> log-mel features (B, frames, n_mels), or
    with ``deltas`` (B, frames, 3 n_mels): the mels, their deltas and
    the deltas' deltas, concatenated; ``context`` then stacks
    ``left_frames`` and ``right_frames`` around each frame
    (``ContextWindow``), multiplying the features by l + r + 1.

    Example
    -------
    >>> Fbank(n_mels=40)(torch.zeros(1, 16000)).shape
    torch.Size([1, 101, 40])
    >>> Fbank(n_mels=40, deltas=True)(torch.zeros(1, 16000)).shape
    torch.Size([1, 101, 120])
    """

    def __init__(self, deltas=False, context=False, sample_rate=16000,
                 f_min=0, f_max=None, n_fft=400, n_mels=40,
                 filter_shape="triangular", win_length=25, hop_length=10,
                 left_frames=5, right_frames=5):
        super().__init__()
        if f_max is None:
            f_max = sample_rate / 2
        self.deltas = deltas
        self.context = context
        self.compute_STFT = STFT(
            sample_rate=sample_rate, n_fft=n_fft, win_length=win_length,
            hop_length=hop_length,
        )
        self.compute_fbanks = Filterbank(
            sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max, filter_shape=filter_shape,
        )
        self.compute_deltas = Deltas()
        self.context_window = ContextWindow(left_frames, right_frames)

    def forward(self, wav):
        """wav: (B, samples) float32."""
        mag = spectral_magnitude(self.compute_STFT(wav), power=1)
        fbanks = self.compute_fbanks(mag)
        if self.deltas:
            delta1 = self.compute_deltas(fbanks)
            delta2 = self.compute_deltas(delta1)
            fbanks = torch.cat([fbanks, delta1, delta2], -1)
        if self.context:
            fbanks = self.context_window(fbanks)
        return fbanks
