"""Low-level signal ops: amplitude, 1-d correlation, notch filters,
overlap-add, resynthesis from a magnitude and a noisy phase.

Counterpart of ``speechbrain_tpu/processing/signal_processing.py``
(``compute_amplitude``, ``convolve1d`` and ``notch_filter``, as far as
the waveform augmentations of ``processing/speech_augmentation.py`` use
them, ``overlap_and_add``, Conv-TasNet's decoder's, over ``overlap_add``, the
ISTFT's, and ``resynthesize``, the spectral-mask enhancer's).  Everything stays on the input's device; ``convolve1d`` runs as a
grouped ``F.conv1d``.  The peak and dB amplitudes, ``convolve1d``'s
per-row kernels, strides and FFT path, and ``reverberate``, which only
``EnvCorrupt``'s noise and reverberation use, are not ported.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["compute_amplitude", "convolve1d", "blackman_window", "notch_filter",
           "overlap_add", "overlap_and_add", "resynthesize"]


def compute_amplitude(waveforms, lengths):
    """The average absolute amplitude of each waveform (B, T) -> (B, 1)
    over its first ``lengths`` samples (absolute counts, (B,) or (B, 1);
    at least 1), as the JAX function's "avg", "linear" case computes it.

    Example
    -------
    >>> compute_amplitude(torch.tensor([[1.0, -3.0, 9.0]]), torch.tensor([2])).tolist()
    [[2.0]]
    """
    T = waveforms.shape[1]
    lengths = lengths.reshape(-1, 1)
    mask = (torch.arange(T, device=waveforms.device)[None, :]
            < lengths).to(waveforms.dtype)
    return ((waveforms.abs() * mask).sum(1, keepdim=True)
            / lengths.to(waveforms.dtype).clamp(min=1.0))


def convolve1d(waveform, kernel, padding=0):
    """Correlation (the kernel is not flipped) along time of each channel,
    after zero-padding time by ``padding`` each side: ``out[b, n, c] =
    sum_k x[b, n + k, c] * kernel[0, k, c]``, as the JAX function's
    direct path computes it for a kernel shared by the batch.

    waveform (B, T, C); kernel (1, K, C).

    Example
    -------
    >>> x = torch.arange(5.0)[None, :, None]
    >>> convolve1d(x, torch.tensor([[[1.0], [0.0], [-1.0]]]))[0, :, 0].tolist()
    [-2.0, -2.0, -2.0]
    """
    C, K = waveform.shape[2], kernel.shape[1]
    x = F.pad(waveform.transpose(1, 2), (padding, padding))  # (B, C, T')
    w = kernel.to(x.dtype).permute(2, 0, 1)  # (C, 1, K)
    return F.conv1d(x, w, groups=C).transpose(1, 2)


def blackman_window(filter_width):
    """The periodic Blackman window of ``filter_width`` points (the
    symmetric one of N + 1 points, last dropped), float32 on the host."""
    return torch.tensor(np.blackman(filter_width + 1)[:-1], dtype=torch.float32)


def notch_filter(notch_freq, filter_width=101, notch_width=0.05, window=None):
    """A notch filter's taps (1, filter_width, 1) float32 at the
    normalized frequency ``notch_freq`` (a float or a 0-d tensor, whose
    device the taps take): a windowed-sinc low-pass below the notch plus
    a high-pass above it, each under the periodic Blackman window
    (``window``, from ``blackman_window`` and already on that device, or
    None to make it here), in the JAX function's order of operations.
    With a device ``notch_freq`` and ``window`` nothing is copied from
    the host.

    Example
    -------
    >>> taps = notch_filter(0.25)
    >>> taps.shape, round(float(taps.sum()), 4)
    (torch.Size([1, 101, 1]), 1.0)
    """
    notch_freq = torch.as_tensor(notch_freq, dtype=torch.float32)
    device = notch_freq.device
    if window is None:
        window = blackman_window(filter_width).to(device)
    pad = filter_width // 2
    inputs = torch.arange(filter_width, device=device) - pad
    notch_freq = notch_freq + notch_width

    def sinc(x):
        safe = torch.where(x == 0, torch.ones_like(x), x)
        return torch.where(x == 0, torch.ones_like(x), torch.sin(safe) / safe)

    hlpf = sinc(3 * (notch_freq - notch_width) * inputs) * window
    hlpf = hlpf / hlpf.sum()
    hhpf = sinc(3 * (notch_freq + notch_width) * inputs) * window
    hhpf = hhpf / -hhpf.sum()
    hhpf = hhpf + (inputs == 0).to(hhpf.dtype)  # + 1 at the centre tap
    return (hlpf + hhpf).reshape(1, -1, 1)


def overlap_add(frames, hop):
    """(batch, n_frames, frame_len) -> (batch, (n_frames - 1) hop +
    frame_len), frame i added at i hop.  Where the hop divides the frame
    (Conv-TasNet's L at L / 2, the ISTFT's 512 at 128) the frame's m =
    frame_len / hop blocks are summed shifted by one block each: m padded
    adds; otherwise ``F.fold``.  Both gather, so the sum is deterministic
    on CUDA (a scatter-add accumulates with atomics there).

    Example
    -------
    >>> overlap_add(torch.ones(1, 3, 4), 2).tolist()
    [[1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 1.0, 1.0]]
    >>> overlap_add(torch.ones(1, 2, 3), 2).tolist()
    [[1.0, 1.0, 2.0, 1.0, 1.0]]
    """
    batch, n_frames, frame_len = frames.shape
    if frame_len % hop == 0:
        m = frame_len // hop
        blocks = frames.reshape(batch, n_frames, m, hop)
        out = sum(F.pad(blocks[:, :, j], (0, 0, j, m - 1 - j))
                  for j in range(m))
        return out.reshape(batch, -1)
    time = (n_frames - 1) * hop + frame_len
    out = F.fold(frames.transpose(1, 2), (1, time), (1, frame_len),
                 stride=(1, hop))
    return out.reshape(batch, time)


def overlap_and_add(signal, frame_step):
    """(..., frames, frame_length) -> (..., (frames + 1) frame_step), each
    frame added at ``frame_step`` times its index, for frames of twice the
    step (Conv-TasNet's, L at hop L / 2; other shapes raise): ``overlap_add``
    over the leading axes.

    Example
    -------
    >>> overlap_and_add(torch.ones(1, 3, 4), 2).tolist()
    [[1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 1.0, 1.0]]
    """
    *lead, frames, length = signal.shape
    if length != 2 * frame_step:
        raise ValueError(f"frames of {length} at hop {frame_step}: "
                         "frames of twice the hop")
    out = overlap_add(signal.reshape(-1, frames, length), frame_step)
    return out.reshape(*lead, -1)


def resynthesize(enhanced_mag, noisy_inputs, stft, istft, normalize_wavs=True):
    """Waveforms (B, T) from an enhanced magnitude (B, frames, freq) and
    the phase of ``stft(noisy_inputs)`` (``atan2`` of its imaginary and
    real parts), both cut to the fewer frames, through ``istft`` at the
    noisy inputs' length; with ``normalize_wavs`` each row is divided by
    its peak when that exceeds 1 (``torch.amax`` and ``torch.maximum``,
    whose gradients split ties evenly, as JAX's ``max`` and ``maximum``
    do).

    Example
    -------
    >>> from speechbrain_tpu_torch.processing.features import ISTFT, STFT
    >>> stft = STFT(8000, win_length=32, hop_length=16, n_fft=512)
    >>> istft = ISTFT(8000, win_length=32, hop_length=16, n_fft=512)
    >>> x = 0.1 * torch.randn(1, 2048)
    >>> mag = (stft(x) ** 2).sum(-1).sqrt()
    >>> bool((resynthesize(mag, x, stft, istft) - x).abs().max() < 1e-5)
    True
    """
    noisy = stft(noisy_inputs)
    phase = torch.atan2(noisy[..., 1], noisy[..., 0])
    frames = min(enhanced_mag.shape[1], phase.shape[1])
    mag, phase = enhanced_mag[:, :frames], phase[:, :frames]
    spec = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], -1)
    wavs = istft(spec, sig_length=noisy_inputs.shape[1])
    if normalize_wavs:
        peak = torch.amax(wavs.abs(), dim=1, keepdim=True)
        wavs = wavs / torch.maximum(peak, peak.new_ones(()))
    return wavs
