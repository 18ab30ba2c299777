"""Feature extraction: STFT, power spectrum, mel filterbank, and
eval-mode global input normalization.

Counterpart of ``speechbrain_tpu/processing/features.py``.  The STFT is
the same chunked-frame DFT matmul as the JAX package's "matmul" backend
(frames are concatenations of hop-sized chunks, times a windowed DFT
matrix zero-padded to a whole number of chunks), so both packages
compute identical products.
"""

import math

import numpy as np
import torch

__all__ = [
    "STFT",
    "spectral_magnitude",
    "Filterbank",
    "mel_filter_matrix",
    "GlobalNormState",
    "InputNormalization",
]


def _ms_to_samples(sample_rate, duration_ms):
    return int(round(sample_rate * duration_ms / 1000.0))


def _make_window(window_type, length):
    """Periodic window of ``length`` samples, float32 numpy."""
    n = np.arange(length, dtype=np.float64)
    if window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / length)
    elif window_type == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / length)
    elif window_type == "blackman":
        w = (
            0.42
            - 0.5 * np.cos(2 * np.pi * n / length)
            + 0.08 * np.cos(4 * np.pi * n / length)
        )
    elif window_type == "rect":
        w = np.ones(length)
    else:
        raise ValueError(f"Unknown window: {window_type}")
    return w.astype(np.float32)


def _frame_signal(x, frame_length, hop):
    """(batch, time) -> (batch, n_frames, frame_length), VALID framing."""
    return x.unfold(1, frame_length, hop)


class STFT(torch.nn.Module):
    """Short-time Fourier transform returning (batch, frames, freq, 2).

    The last axis holds [real, imag].  ``win_length``/``hop_length`` are
    in milliseconds.  The signal is zero-padded by n_fft//2 on both
    sides, so frame t is centered on t * hop (the JAX defaults
    ``center=True``, ``pad_mode="constant"``, unnormalized).
    ``backend="matmul"`` (chosen for n_fft <= 1024, as in the JAX
    package) computes the DFT as one matmul over chunked frames;
    ``"fft"`` uses ``torch.fft.rfft`` over ``_frame_signal`` frames.

    Example
    -------
    >>> stft = STFT(sample_rate=16000)
    >>> stft(torch.zeros(2, 16000)).shape
    torch.Size([2, 101, 201, 2])
    """

    def __init__(
        self,
        sample_rate,
        win_length=25,
        hop_length=10,
        n_fft=400,
        window_type="hamming",
        backend="auto",
    ):
        super().__init__()
        self.win_length = _ms_to_samples(sample_rate, win_length)
        self.hop_length = _ms_to_samples(sample_rate, hop_length)
        self.n_fft = n_fft
        if backend == "auto":
            backend = "matmul" if n_fft <= 1024 else "fft"
        self.backend = backend
        if self.win_length > n_fft:
            raise ValueError(
                f"win_length ({self.win_length} samples) must be <= n_fft "
                f"({n_fft})"
            )
        window = _make_window(window_type, self.win_length)
        if self.win_length < n_fft:  # zero-pad the window, centered
            left = (n_fft - self.win_length) // 2
            padded = np.zeros(n_fft, dtype=np.float32)
            padded[left : left + self.win_length] = window
            window = padded
        self.register_buffer("window", torch.from_numpy(window), persistent=False)
        F = n_fft // 2 + 1
        k = np.arange(F)
        n = np.arange(n_fft)
        ang = -2.0 * np.pi * np.outer(n, k) / n_fft
        kern = np.concatenate(
            [
                window[:, None] * np.cos(ang).astype(np.float32),
                window[:, None] * np.sin(ang).astype(np.float32),
            ],
            axis=1,
        )  # (n_fft, 2F), float32 products as in the JAX package
        m = -(-n_fft // self.hop_length)
        kern = np.pad(kern, ((0, m * self.hop_length - n_fft), (0, 0)))
        self.register_buffer(
            "dft_kernel", torch.from_numpy(kern.astype(np.float32)),
            persistent=False,
        )

    def forward(self, x):
        """x: (batch, time) float -> (batch, frames, n_fft//2+1, 2)."""
        pad = self.n_fft // 2
        x = torch.nn.functional.pad(x, (pad, pad))
        F = self.n_fft // 2 + 1
        if self.backend == "matmul":
            hop = self.hop_length
            m = -(-self.n_fft // hop)
            Lk = m * hop
            xx = x
            if Lk > self.n_fft:  # zero tail: meets only the kernel's zero pad
                xx = torch.nn.functional.pad(x, (0, Lk - self.n_fft))
            nc = xx.shape[1] // hop
            chunks = xx[:, : nc * hop].reshape(x.shape[0], nc, hop)
            n_frames = max(nc - m + 1, 0)
            frames = torch.cat(
                [chunks[:, j : j + n_frames] for j in range(m)], dim=-1
            )  # (B, n_frames, m*hop)
            spec2 = torch.matmul(frames, self.dft_kernel.to(frames.dtype))
            real, imag = spec2[..., :F], spec2[..., F:]
        else:
            frames = _frame_signal(x, self.n_fft, self.hop_length)
            spec = torch.fft.rfft(frames * self.window, n=self.n_fft, dim=-1)
            real, imag = spec.real, spec.imag
        return torch.stack([real, imag], dim=-1)


def spectral_magnitude(stft, power=1, log=False, eps=1e-14):
    """``(re^2 + im^2) ** power`` of a (..., 2) STFT (power=1: power
    spectrogram, power=0.5: magnitude).

    Example
    -------
    >>> float(spectral_magnitude(torch.tensor([[3.0, 4.0]]), power=0.5)[0])
    5.0
    """
    spectr = (stft ** 2).sum(-1)
    if power < 1:
        spectr = spectr + eps
    if power != 1:
        spectr = spectr ** power
    if log:
        return torch.log(spectr + eps)
    return spectr


def hz_to_mel(hz):
    """Hz to mel scale."""
    return 2595 * np.log10(1 + np.asarray(hz) / 700)


def mel_to_hz(mel):
    """Mel scale to Hz."""
    return 700 * (10 ** (np.asarray(mel) / 2595) - 1)


def mel_filter_matrix(
    n_mels, f_min, f_max, n_stft, sample_rate, filter_shape="triangular"
):
    """(n_stft, n_mels) filter matrix, float32 numpy.

    Example
    -------
    >>> mel_filter_matrix(40, 0, 8000, 201, 16000).shape
    (201, 40)
    """
    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    band = hz_pts[1:] - hz_pts[:-1]
    f_central = hz_pts[1:-1]
    all_freqs = np.linspace(0, sample_rate // 2, n_stft)
    slope = (all_freqs[:, None] - f_central[None, :]) / band[:-1][None, :]
    if filter_shape == "triangular":
        fbank = np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))
    elif filter_shape == "rectangular":
        fbank = ((slope >= -1) & (slope <= 1)).astype(np.float64)
    elif filter_shape == "gaussian":
        fbank = np.exp(-0.5 * (slope / 0.5) ** 2)
    else:
        raise ValueError(f"Unknown filter shape: {filter_shape}")
    return fbank.astype(np.float32)


class Filterbank(torch.nn.Module):
    """Mel filterbank projection with optional log (dB) compression and
    per-utterance ``top_db`` clamping.

    Example
    -------
    >>> fb = Filterbank(n_mels=40)
    >>> fb(torch.ones(2, 101, 201)).shape
    torch.Size([2, 101, 40])
    """

    def __init__(
        self,
        n_mels=40,
        log_mel=True,
        filter_shape="triangular",
        f_min=0.0,
        f_max=8000.0,
        n_fft=400,
        sample_rate=16000,
        power_spectrogram=2,
        amin=1e-10,
        ref_value=1.0,
        top_db=80.0,
    ):
        super().__init__()
        self.log_mel = log_mel
        self.amin = amin
        self.top_db = top_db
        self.db_multiplier = math.log10(max(amin, ref_value))
        self.multiplier = 10 if power_spectrogram == 2 else 20
        filters = mel_filter_matrix(
            n_mels, f_min, f_max, n_fft // 2 + 1, sample_rate, filter_shape
        )
        self.register_buffer(
            "filters", torch.from_numpy(filters), persistent=False
        )

    def forward(self, spectrogram):
        """(batch, frames, n_stft) -> (batch, frames, n_mels)."""
        fbanks = torch.matmul(spectrogram, self.filters.to(spectrogram.dtype))
        if self.log_mel:
            fbanks = self._amplitude_to_db(fbanks)
        return fbanks

    def _amplitude_to_db(self, x):
        x_db = self.multiplier * torch.log10(torch.clamp(x, min=self.amin))
        x_db = x_db - self.multiplier * self.db_multiplier
        floor = x_db.reshape(x_db.shape[0], -1).amax(dim=1) - self.top_db
        return torch.maximum(x_db, floor[:, None, None])


class GlobalNormState:
    """Stored global statistics of ``InputNormalization``: a dict with
    ``count`` (scalar), ``mean`` and ``std`` (dim,) float32 tensors."""

    @staticmethod
    def init(dim, device=None):
        """Fresh state: count 0, mean 0, std 1."""
        return {
            "count": torch.zeros((), dtype=torch.float32, device=device),
            "mean": torch.zeros(dim, dtype=torch.float32, device=device),
            "std": torch.ones(dim, dtype=torch.float32, device=device),
        }


class InputNormalization(torch.nn.Module):
    """Global mean/variance normalization, eval mode: ``(x - mean) / std``
    with the stored statistics (buffers ``mean``, ``std``, ``count``).

    This is what the JAX ``InputNormalization(norm_type="global")``
    computes at ``training=False``; ``bridge.input_norm_state_dict``
    loads its stored state.  Updating the statistics is training work
    and is not part of this port yet.

    Example
    -------
    >>> norm = InputNormalization(3)
    >>> norm(torch.ones(1, 2, 3)).shape
    torch.Size([1, 2, 3])
    """

    def __init__(self, dim):
        super().__init__()
        state = GlobalNormState.init(dim)
        for name, value in state.items():
            self.register_buffer(name, value)

    def forward(self, x, lengths=None):
        """x: (batch, frames, dim); ``lengths`` is unused in eval mode."""
        return (x - self.mean) / self.std
