"""Feature extraction: STFT and its inverse, power spectrum, mel
filterbank, deltas, context windows, and global input normalization
(eval, and training with statistic updates).

Counterpart of ``speechbrain_tpu/processing/features.py``.  The STFT is
the same chunked-frame DFT matmul as the JAX package's "matmul" backend
(frames are concatenations of hop-sized chunks, times a windowed DFT
matrix zero-padded to a whole number of chunks), so both packages
compute identical products.  The ISTFT's overlap-add is a sum of
shifted reshapes where the hop divides the frame (``F.fold``
otherwise), not the JAX package's scatter-add: no atomics on CUDA.
"""

import math

import numpy as np
import torch

from .signal_processing import overlap_add

__all__ = [
    "STFT",
    "ISTFT",
    "spectral_magnitude",
    "Filterbank",
    "mel_filter_matrix",
    "Deltas",
    "ContextWindow",
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


class ISTFT(torch.nn.Module):
    """Inverse STFT: (batch, frames, freq, 2) -> (batch, time), the real
    inverse DFT of each frame times the analysis window, overlap-added at
    the hop and divided by the overlap-added squared window (at least
    ``epsilon``); with ``center`` the first and last n_fft // 2 samples
    are dropped, and ``sig_length`` cuts the result.  A 5-d input
    (batch, frames, freq, 2, channels) gives (batch, time, channels).
    ``n_fft`` None takes 2 (freq - 1).  ``win_length``/``hop_length`` in
    milliseconds, the window as ``STFT`` makes it (zero-padded, centred,
    when shorter than n_fft).

    Example
    -------
    >>> stft = STFT(8000, win_length=32, hop_length=16, n_fft=512)
    >>> istft = ISTFT(8000, win_length=32, hop_length=16, n_fft=512)
    >>> x = torch.randn(2, 4096)
    >>> y = istft(stft(x))
    >>> y.shape, bool((y - x).abs().max() < 1e-4)
    (torch.Size([2, 4096]), True)
    """

    def __init__(self, sample_rate, win_length=25, hop_length=10, n_fft=None,
                 window_type="hamming", normalized_stft=False, center=True,
                 epsilon=1e-12):
        super().__init__()
        self.win_length = _ms_to_samples(sample_rate, win_length)
        self.hop_length = _ms_to_samples(sample_rate, hop_length)
        self.n_fft = n_fft
        self.window_type = window_type
        self.normalized_stft = normalized_stft
        self.center = center
        self.epsilon = epsilon
        if n_fft is not None:  # a buffer: no copy from the host a call
            self.register_buffer("window", torch.from_numpy(
                self._make(n_fft)), persistent=False)

    def _make(self, n_fft):
        window = _make_window(self.window_type, self.win_length)
        if self.win_length < n_fft:
            left = (n_fft - self.win_length) // 2
            padded = np.zeros(n_fft, dtype=np.float32)
            padded[left : left + self.win_length] = window
            window = padded
        return window

    def _window(self, n_fft, like):
        if self.n_fft is not None:
            return self.window.to(like.dtype)
        return torch.from_numpy(self._make(n_fft)).to(like.device, like.dtype)

    def forward(self, x, sig_length=None):
        """x: (batch, frames, freq, 2) or (batch, frames, freq, 2,
        channels)."""
        multi_channel = x.dim() == 5
        if multi_channel:
            batch, n_frames, freq, _, channels = x.shape
            x = x.permute(0, 4, 1, 2, 3).reshape(batch * channels, n_frames,
                                                 freq, 2)
        n_fft = self.n_fft or 2 * (x.shape[2] - 1)
        spec = torch.complex(x[..., 0], x[..., 1])
        if self.normalized_stft:
            spec = spec * math.sqrt(n_fft)
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
        window = self._window(n_fft, frames)
        sig = overlap_add(frames * window, self.hop_length)
        norm = overlap_add((window ** 2).expand(1, frames.shape[1], n_fft),
                           self.hop_length)
        sig = sig / norm.clamp(min=self.epsilon)
        if self.center:
            pad = n_fft // 2
            sig = sig[:, pad:-pad] if pad else sig
        if sig_length is not None:
            sig = sig[:, :sig_length]
        if multi_channel:
            sig = sig.reshape(batch, channels, -1).transpose(1, 2)
        return sig


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


def _fold_channels(x):
    """(B, T, F, C) -> (B * C, T, F) and the function that undoes it on a
    (B * C, T, F') result; a 3-d input passes through."""
    if x.dim() != 4:
        return x, lambda y: y
    b, t, f, c = x.shape
    folded = x.permute(0, 3, 1, 2).reshape(b * c, t, f)
    return folded, lambda y: y.reshape(b, c, t, y.shape[-1]).permute(0, 2, 3, 1)


class Deltas(torch.nn.Module):
    """Delta (time-derivative) features: time padded with its edge
    values, then cross-correlated (not flipped) with the taps
    ``j / denom``, j = -n..n, ``n = (window_length - 1) // 2`` and
    ``denom = n (n + 1) (2n + 1) / 3``.

    Counterpart of the JAX ``Deltas``; a (B, T, F, C) input is taken
    channel by channel.

    Example
    -------
    >>> d = Deltas()(torch.arange(5.0)[None, :, None])
    >>> [round(v, 4) for v in d[0, :, 0].tolist()]
    [0.5, 0.8, 1.0, 0.8, 0.5]
    """

    def __init__(self, input_size=None, window_length=5):
        super().__init__()
        self.n = (window_length - 1) // 2
        self.denom = self.n * (self.n + 1) * (2 * self.n + 1) / 3
        self.taps = [float(t) for t in np.asarray(
            np.arange(-self.n, self.n + 1, dtype=np.float32) / self.denom,
            np.float32)]

    def forward(self, x):
        """x: (B, T, F) or (B, T, F, C) -> the same shape."""
        x, unfold = _fold_channels(x)
        T = x.shape[1]
        xp = torch.cat([x[:, :1].expand(-1, self.n, -1), x,
                        x[:, -1:].expand(-1, self.n, -1)], 1)
        out = xp[:, 0:T] * self.taps[0]
        for i in range(1, len(self.taps)):
            out = out + xp[:, i:i + T] * self.taps[i]
        return unfold(out)


class ContextWindow(torch.nn.Module):
    """Frame stacking: each frame gets ``left_frames`` frames before it
    and ``right_frames`` after it (zeros past the ends), interleaved
    feature-major: output channel ``f * (l + r + 1) + c`` holds
    ``x[t + c - l, f]``.

    Counterpart of the JAX ``ContextWindow``; a (B, T, F, C) input is
    taken channel by channel.

    Example
    -------
    >>> x = torch.arange(6.0).reshape(1, 3, 2)
    >>> ContextWindow(1, 1)(x)[0, 1].tolist()
    [0.0, 2.0, 4.0, 1.0, 3.0, 5.0]
    """

    def __init__(self, left_frames=0, right_frames=0):
        super().__init__()
        self.left_frames = left_frames
        self.right_frames = right_frames

    def forward(self, x):
        """x: (B, T, F) or (B, T, F, C) -> (B, T, F * (l + r + 1)[, C])."""
        left, right = self.left_frames, self.right_frames
        if left == 0 and right == 0:
            return x
        x, unfold = _fold_channels(x)
        T = x.shape[1]
        xp = torch.nn.functional.pad(x, (0, 0, left, right))
        out = torch.stack([xp[:, i:i + T] for i in range(left + right + 1)],
                          -1)
        return unfold(out.reshape(out.shape[0], T, -1))


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
    """Mean/variance normalization, by ``norm_type``:

    - ``"sentence"``: each row by its own statistics;
    - ``"batch"``: by the means over the batch of the rows' statistics;
    - ``"global"`` (the default): by stored statistics (buffers
      ``count``, ``mean``, ``std`` of width ``dim``).

    Counterpart of the JAX ``InputNormalization``.  A row's statistics
    are the mean and the Bessel-corrected std over its first
    ``round(length * T)`` frames (std floored at ``epsilon``); with
    ``mean_norm=False`` the mean is 0, with ``std_norm=False`` the std
    is 1.  They are not differentiated (detached, as in the reference).

    In ``"global"`` mode the stored statistics are used as they are in
    eval mode.  In training mode (``module.train()``) each call first
    updates them from the batch, as the JAX call does at
    ``training=True``:

    - the batch's statistics are the means over the batch of the rows';
    - the first training batch sets the statistics; later ones blend in
      with weight ``1 / (count + 1)`` while ``epoch <
      update_until_epoch``, and not at all after that;
    - ``count`` rises by one on every training batch;

    and normalizes with the updated statistics.  ``state()`` returns
    them as the JAX call returns its new state.  The other modes keep no
    state and act alike in training and eval.

    Example
    -------
    >>> norm = InputNormalization(3).eval()
    >>> norm(torch.ones(1, 2, 3)).shape
    torch.Size([1, 2, 3])
    >>> _ = norm.train()(torch.arange(12.0).reshape(2, 2, 3), torch.ones(2))
    >>> norm.state()["mean"].tolist(), float(norm.count)
    ([4.5, 5.5, 6.5], 1.0)
    >>> sent = InputNormalization(norm_type="sentence", std_norm=False)
    >>> sent(torch.tensor([[[1.0], [3.0], [9.0]]]),
    ...      torch.tensor([2 / 3]))[0, :, 0].tolist()
    [-1.0, 1.0, 7.0]
    """

    def __init__(self, dim=None, update_until_epoch=3, epsilon=1e-10,
                 norm_type="global", mean_norm=True, std_norm=True):
        super().__init__()
        if norm_type not in ("sentence", "batch", "global"):
            raise ValueError(f"Unknown norm_type {norm_type}")
        self.norm_type = norm_type
        self.mean_norm = mean_norm
        self.std_norm = std_norm
        self.update_until_epoch = update_until_epoch
        self.epsilon = epsilon
        if norm_type == "global":
            if dim is None:
                raise ValueError("global InputNormalization needs dim")
            for name, value in GlobalNormState.init(dim).items():
                self.register_buffer(name, value)

    @torch.no_grad()
    def _sentence_stats(self, x, lengths):
        """Per-row (B, F) mean and std, with the switches and the floor."""
        T = x.shape[1]
        n = torch.round(lengths.float() * T)  # (B,)
        mask = (torch.arange(T, device=x.device)[None, :] < n[:, None])
        mask = mask.to(x.dtype)[..., None]
        mean = (x * mask).sum(1) / n.clamp(min=1.0)[:, None]
        # the std is taken around the true mean, even without mean_norm
        ss = (((x - mean[:, None, :]) * mask) ** 2).sum(1)
        std = torch.sqrt(ss.clamp(min=1e-20) / (n - 1.0).clamp(min=1.0)[:, None])
        if not self.mean_norm:
            mean = torch.zeros_like(mean)
        if not self.std_norm:
            std = torch.ones_like(std)
        return mean, std.clamp(min=self.epsilon)

    @torch.no_grad()
    def _update(self, x, lengths, epoch):
        mean, std = self._sentence_stats(
            x.to(torch.promote_types(x.dtype, torch.float32)), lengths)
        cur_mean, cur_std = mean.mean(0), std.mean(0)
        w = 1.0 / (self.count + 1.0)
        in_window = 1.0 if epoch < self.update_until_epoch else 0.0
        blend = torch.where(self.count == 0, torch.ones_like(w), in_window * w)
        self.mean.copy_((1.0 - blend) * self.mean + blend * cur_mean)
        self.std.copy_((1.0 - blend) * self.std + blend * cur_std)
        self.count.add_(1.0)

    def forward(self, x, lengths=None, epoch=0):
        """x: (batch, frames, dim); ``lengths`` (batch,) relative, needed
        by the global mode in training (else None: every frame);
        ``epoch`` is the current epoch (global training only)."""
        if self.norm_type != "global":
            if lengths is None:
                lengths = torch.ones(x.shape[0], device=x.device)
            mean, std = self._sentence_stats(
            x.to(torch.promote_types(x.dtype, torch.float32)), lengths)
            if self.norm_type == "batch":
                mean, std = mean.mean(0), std.mean(0)
            else:
                mean, std = mean[:, None, :], std[:, None, :]
            return ((x - mean) / std).to(x.dtype)
        if self.training:
            if lengths is None:
                raise ValueError("InputNormalization in training needs lengths")
            self._update(x, lengths, epoch)
        return (x - self.mean) / self.std

    def state(self):
        """The statistics as a ``GlobalNormState`` dict (copies)."""
        return {k: getattr(self, k).detach().clone()
                for k in ("count", "mean", "std")}
