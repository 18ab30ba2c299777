"""Waveform-domain augmentation with fixed shapes and explicit draws.

Counterpart of ``speechbrain_tpu/processing/speech_augmentation.py``
(``Resample``, ``SpeedPerturb``, ``DropFreq``, ``DropChunk``): each
augmentor keeps the input's shape, as in the JAX package (a speed
change keeps the padded time dim and returns new relative lengths).
The random values come from a ``torch.Generator`` on the waveforms'
device, with no host sync; they cannot be JAX's bits, so each
augmentor's ``draw`` makes them and its call takes them as ``draws``,
which holds the arithmetic to JAX's with the draws fixed.

One fault of the JAX ``SpeedPerturb`` is not copied: it scales the
relative lengths by ``100 / speed`` (speeds are percentages; the
resampler gives ``T * speed / 100`` samples), so at speed 95 a signal
that filled half the window reads 0.526 long where its content fills
0.475.  Here the new relative length is ``min(lengths * t_new / T,
1)``, ``t_new`` the resampled length.  ``AddNoise``, ``AddReverb``,
``AddBabble`` and ``DoClip`` are not ported.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .signal_processing import (
    blackman_window,
    compute_amplitude,
    convolve1d,
    notch_filter,
)

__all__ = ["Resample", "SpeedPerturb", "DropFreq", "DropChunk"]


def _uniform(size, generator, device):
    return torch.rand(size, generator=generator, device=device)


def _randint(lo, hi, size, generator, device):
    return torch.randint(lo, hi, size, generator=generator, device=device)


class Resample(torch.nn.Module):
    """Windowed-sinc polyphase resampling, ``T`` -> ``ceil(T * up /
    down)`` samples (``up / down`` the reduced ratio of the rates).

    The weights are the JAX module's (Kaldi-style: a Hann-windowed sinc
    at 0.99 of the lower Nyquist, one period of ``up`` phases), built at
    init in float64 numpy and held as float32.  Output sample ``i * up +
    p`` is the dot product of phase ``p``'s weights with the input from
    ``i * down + min_idx[p]``; all phases run as one strided
    ``F.conv1d`` whose kernel places each phase's weights at its offset.

    Example
    -------
    >>> Resample(orig_freq=16000, new_freq=8000)(torch.ones(1, 1600)).shape
    torch.Size([1, 800])
    """

    def __init__(self, orig_freq=16000, new_freq=16000, lowpass_filter_width=6):
        super().__init__()
        g = math.gcd(int(orig_freq), int(new_freq))
        self.up = int(new_freq) // g
        self.down = int(orig_freq) // g
        self.lowpass_filter_width = lowpass_filter_width
        self.register_buffer("kernel", None, persistent=False)
        if self.up != self.down:
            self._build_kernel()

    def _build_kernel(self):
        up, down = self.up, self.down
        orig_freq, new_freq = float(down), float(up)
        cutoff = 0.99 * 0.5 * min(orig_freq, new_freq)
        window_width = self.lowpass_filter_width / (2.0 * cutoff)
        t_out = np.arange(up, dtype=np.float64) / new_freq
        min_idx = np.ceil((t_out - window_width) * orig_freq)
        max_idx = np.floor((t_out + window_width) * orig_freq)
        width = int((max_idx - min_idx).max()) + 1
        input_index = min_idx[:, None] + np.arange(width, dtype=np.float64)
        delta_t = input_index / orig_freq - t_out[:, None]
        inside = np.abs(delta_t) < window_width
        win = np.where(inside, 0.5 * (1 + np.cos(
            2 * np.pi * cutoff / self.lowpass_filter_width * delta_t)), 0.0)
        sinc = np.where(
            delta_t == 0, 2 * cutoff,
            np.sin(2 * np.pi * cutoff * delta_t)
            / (np.pi * np.where(delta_t == 0, 1.0, delta_t)))
        weights = (win * sinc / orig_freq).astype(np.float32)  # (up, W)
        self.width = width
        self.min_idx = min_idx.astype(np.int64)
        self.pad_left = int(max(0, -self.min_idx.min()))
        offs = self.min_idx + self.pad_left
        self.off_min = int(offs.min())
        span = int(offs.max()) - self.off_min + width
        kernel = np.zeros((up, 1, span), np.float32)
        for p in range(up):
            start = int(offs[p]) - self.off_min
            kernel[p, 0, start:start + width] = weights[p]
        self.kernel = torch.from_numpy(kernel)

    def forward(self, waveforms):
        """(B, T[, C]) -> (B, ceil(T * up / down)[, C])."""
        if self.kernel is None:
            return waveforms
        had_ch = waveforms.dim() == 3
        if had_ch:
            b, t, c = waveforms.shape
            waveforms = waveforms.permute(0, 2, 1).reshape(b * c, t)
        B, T = waveforms.shape
        up, down = self.up, self.down
        t_out = int(math.ceil(T * up / down))
        n_blocks = -(-t_out // up)
        span = self.kernel.shape[-1]
        x = F.pad(waveforms, (self.pad_left,
                              n_blocks * down + self.width + span))
        x = x[:, self.off_min:self.off_min + (n_blocks - 1) * down + span]
        out = F.conv1d(x[:, None, :], self.kernel.to(x.dtype), stride=down)
        out = out.transpose(1, 2).reshape(B, n_blocks * up)[:, :t_out]
        if had_ch:
            out = out.reshape(b, c, t_out).permute(0, 2, 1)
        return out


class SpeedPerturb(torch.nn.Module):
    """A random speed change by resampling, keeping the input's shape.

    One of ``speeds`` (percentages) is drawn a call and applied with
    probability ``perturb_prob`` to the whole batch; the result is
    cropped to T samples or zero-padded up to them, and the relative
    lengths become ``min(lengths * t_new / T, 1)`` (see the module's
    docstring).  Every speed's resampling runs and the drawn one is
    selected on the device, so nothing is read back.

    Example
    -------
    >>> sp = SpeedPerturb(16000, speeds=[90, 100, 110])
    >>> wav, lens = sp(torch.ones(2, 1600), torch.ones(2), torch.Generator())
    >>> wav.shape, lens.shape
    (torch.Size([2, 1600]), torch.Size([2]))
    """

    def __init__(self, orig_freq, speeds=[90, 100, 110], perturb_prob=1.0):
        super().__init__()
        self.orig_freq = orig_freq
        self.speeds = list(speeds)
        self.perturb_prob = perturb_prob
        self.resamplers = torch.nn.ModuleList(
            Resample(orig_freq, orig_freq * speed // 100) for speed in speeds)

    def draw(self, generator=None, device=None):
        """``{"index": the speed's index, "apply": bool}``, 0-d tensors."""
        return {"index": _randint(0, len(self.speeds), (), generator, device),
                "apply": _uniform((), generator, device) < self.perturb_prob}

    def forward(self, waveforms, lengths, generator=None, draws=None):
        """waveforms (B, T), lengths (B,) relative -> the same shapes."""
        if draws is None:
            draws = self.draw(generator, waveforms.device)
        T = waveforms.shape[1]
        outs, lens = [], []
        for resampler in self.resamplers:
            y = resampler(waveforms)
            t_new = y.shape[1]
            y = y[:, :T] if t_new >= T else F.pad(y, (0, T - t_new))
            outs.append(y)
            lens.append(torch.clamp(lengths * (t_new / T), max=1.0))
        index = draws["index"].reshape(1).to(waveforms.device)
        chosen = torch.index_select(torch.stack(outs), 0, index)[0]
        chosen_lens = torch.index_select(torch.stack(lens), 0, index)[0]
        apply = draws["apply"]
        return (torch.where(apply, chosen, waveforms),
                torch.where(apply, chosen_lens, lengths))


class DropFreq(torch.nn.Module):
    """Notch filters at random frequencies (spectral dropout in the time
    domain): a count in [drop_count_low, drop_count_high] and that many
    normalized frequencies, uniform in [drop_freq_low, drop_freq_high),
    for the whole batch, applied with probability ``drop_prob``.

    As in JAX, the ``drop_count_high`` notches are composed into one
    101-tap kernel (inactive slots are the identity), by correlation,
    and the waveforms, zero-padded by 50 each side, are correlated with
    it.

    Example
    -------
    >>> DropFreq()(torch.ones(2, 400), torch.Generator()).shape
    torch.Size([2, 400])
    """

    FILTER_LENGTH = 101

    def __init__(self, drop_freq_low=1e-14, drop_freq_high=1,
                 drop_count_low=1, drop_count_high=2, drop_width=0.05,
                 drop_prob=1):
        super().__init__()
        self.drop_freq_low = drop_freq_low
        self.drop_freq_high = drop_freq_high
        self.drop_count_low = drop_count_low
        self.drop_count_high = drop_count_high
        self.drop_width = drop_width
        self.drop_prob = drop_prob
        # the notches' window and the identity kernel, built once here so
        # that a call copies nothing from the host
        length = self.FILTER_LENGTH
        self.register_buffer("window", blackman_window(length),
                             persistent=False)
        delta = torch.zeros(1, length, 1)
        delta[0, length // 2, 0] = 1.0
        self.register_buffer("delta", delta, persistent=False)

    def draw(self, generator=None, device=None):
        """``{"count": 0-d, "freqs": (drop_count_high,), "apply": 0-d
        bool}``."""
        drop_range = self.drop_freq_high - self.drop_freq_low
        return {
            "count": _randint(self.drop_count_low, self.drop_count_high + 1,
                              (), generator, device),
            "freqs": (_uniform((self.drop_count_high,), generator, device)
                      * drop_range + self.drop_freq_low),
            "apply": _uniform((), generator, device) < self.drop_prob,
        }

    def forward(self, waveforms, generator=None, draws=None):
        """waveforms (B, T) or (B, T, C) -> the same shape."""
        if draws is None:
            draws = self.draw(generator, waveforms.device)
        x = waveforms[..., None] if waveforms.dim() == 2 else waveforms
        length = self.FILTER_LENGTH
        pad = length // 2
        window = self.window.to(x.device)
        kernel = delta = self.delta.to(x.device, x.dtype)
        for i in range(self.drop_count_high):
            nf = notch_filter(draws["freqs"][i], length, self.drop_width,
                              window)
            active = (i < draws["count"]).to(x.dtype)
            kernel = convolve1d(kernel, active * nf + (1 - active) * delta,
                                padding=pad)
        dropped = convolve1d(x, kernel, padding=pad)
        apply = draws["apply"].to(x.dtype)
        out = apply * dropped + (1 - apply) * x
        return out[..., 0] if waveforms.dim() == 2 else out


class DropChunk(torch.nn.Module):
    """Zero (or noise-fill) random chunks of each waveform: a count a row
    in [drop_count_low, drop_count_high], lengths in [drop_length_low,
    drop_length_high] and starts in [drop_start, drop_end or T) for
    ``drop_count_high`` slots a row (the slots past the count are
    inactive), applied to the batch with probability ``drop_prob``.
    With ``noise_factor`` > 0 the chunks hold uniform noise of up to
    ``2 noise_factor`` times each row's average amplitude over its
    ``int(lengths * T)`` samples.

    Example
    -------
    >>> drop = DropChunk(drop_length_low=10, drop_length_high=20)
    >>> drop(torch.ones(2, 200), torch.ones(2), torch.Generator()).shape
    torch.Size([2, 200])
    """

    def __init__(self, drop_length_low=100, drop_length_high=1000,
                 drop_count_low=1, drop_count_high=10, drop_start=0,
                 drop_end=None, drop_prob=1, noise_factor=0.0):
        super().__init__()
        self.drop_length_low = drop_length_low
        self.drop_length_high = drop_length_high
        self.drop_count_low = drop_count_low
        self.drop_count_high = drop_count_high
        self.drop_start = drop_start
        self.drop_end = drop_end
        self.drop_prob = drop_prob
        self.noise_factor = noise_factor

    def draw(self, shape, generator=None, device=None):
        """For (B, T) waveforms: ``{"counts": (B,), "lens", "starts": (B,
        drop_count_high), "noise": (B, T) uniform in [0, 1) or None (no
        noise fill), "apply": 0-d bool}``."""
        B, T = shape[0], shape[1]
        n = self.drop_count_high
        end = self.drop_end if self.drop_end is not None else T
        return {
            "counts": _randint(self.drop_count_low, n + 1, (B,), generator,
                               device),
            "lens": _randint(self.drop_length_low, self.drop_length_high + 1,
                             (B, n), generator, device),
            "starts": _randint(self.drop_start,
                               max(end, self.drop_start + 1), (B, n),
                               generator, device),
            "noise": (None if self.noise_factor == 0.0
                      else _uniform((B, T), generator, device)),
            "apply": _uniform((), generator, device) < self.drop_prob,
        }

    def forward(self, waveforms, lengths, generator=None, draws=None):
        """waveforms (B, T), lengths (B,) relative -> (B, T)."""
        B, T = waveforms.shape[0], waveforms.shape[1]
        if draws is None:
            draws = self.draw(waveforms.shape, generator, waveforms.device)
        positions = torch.arange(T, device=waveforms.device)[None, None, :]
        active = (torch.arange(self.drop_count_high,
                               device=waveforms.device)[None, :]
                  < draws["counts"][:, None])[..., None]
        starts = draws["starts"][..., None]
        in_chunk = ((positions >= starts)
                    & (positions < starts + draws["lens"][..., None])
                    & active)
        mask = in_chunk.any(1)
        if self.noise_factor == 0.0:
            dropped = torch.where(mask, torch.zeros_like(waveforms), waveforms)
        else:
            abs_lens = (lengths * T).to(torch.int32)
            clean_amp = compute_amplitude(waveforms, abs_lens[:, None])
            noise = (draws["noise"] * 2 - 1) * (2 * clean_amp * self.noise_factor)
            dropped = torch.where(mask, noise, waveforms)
        apply = draws["apply"].to(waveforms.dtype)
        return apply * dropped + (1 - apply) * waveforms
