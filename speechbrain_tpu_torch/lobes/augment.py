"""SpecAugment on (B, T, F) features, and TimeDomainSpecAugment on
waveforms.

Counterpart of ``speechbrain_tpu/lobes/augment.py`` (``SpecAugment``,
``TimeDomainSpecAugment``).  ``SpecAugment``:
the same time warp (a piecewise-linear remap with linear interpolation,
not upstream's bicubic resize), frequency masks and time masks, in that
order, from three independent draws.  The draws come from a
``torch.Generator`` on the features' device (the trainer's), with no
host sync; they cannot be JAX's bits, so a caller may pass the draws
(``draw`` makes them) to hold the arithmetic to JAX's with them fixed.
``TimeDomainSpecAugment`` draws and takes its draws the same way.
``EnvCorrupt`` is not ported.
"""

import torch

from ..processing.speech_augmentation import DropChunk, DropFreq, SpeedPerturb

__all__ = ["SpecAugment", "TimeDomainSpecAugment"]


class SpecAugment:
    """Time warp + frequency masks + time masks on (B, T, F) features.

    Arguments (JAX's, with its defaults)
    ---------
    time_warp, time_warp_window : the warp and its window W; a batch
        shares one centre ``c`` in [W, T - W) and one target
        ``w = c + [-W, W]``; no warp when T <= 2W.
    time_warp_mode : accepted for the yaml's sake; the warp is linear.
    freq_mask, n_freq_mask, freq_mask_width : ``n`` bands a row along
        the features, widths in [lo, max(hi, lo + 1)), starts in
        [0, max(1, F - hi)), combined as a union.
    time_mask, n_time_mask, time_mask_width : the same along time.
    replace_with_zero : fill 0, or else the mean of the whole current
        tensor (padded frames included; taken again before the time
        masks).

    Example
    -------
    >>> aug = SpecAugment(time_warp=False, n_freq_mask=2, n_time_mask=2)
    >>> g = torch.Generator().manual_seed(0)
    >>> out = aug(torch.ones(2, 50, 40), g)
    >>> out.shape, bool((out == 0).any())
    (torch.Size([2, 50, 40]), True)
    """

    def __init__(self, time_warp=True, time_warp_window=5,
                 time_warp_mode="bicubic", freq_mask=True, n_freq_mask=2,
                 time_mask=True, n_time_mask=2, replace_with_zero=True,
                 freq_mask_width=(0, 20), time_mask_width=(0, 100)):
        self.time_warp_flag = time_warp
        self.time_warp_window = time_warp_window
        self.freq_mask_flag = freq_mask
        self.n_freq_mask = n_freq_mask
        self.time_mask_flag = time_mask
        self.n_time_mask = n_time_mask
        self.replace_with_zero = replace_with_zero
        self.freq_mask_width = tuple(freq_mask_width)
        self.time_mask_width = tuple(time_mask_width)

    def __call__(self, x, generator=None, draws=None):
        """x (B, T, F) float; ``draws`` (from ``draw``) or else new draws
        from ``generator`` (None: the device's default generator).  Runs
        in a ``record_function`` range named "spec_augment"."""
        with torch.profiler.record_function("spec_augment"):
            if draws is None:
                draws = self.draw(x.shape, generator, x.device)
            if self.time_warp_flag and draws["warp"] is not None:
                x = self.time_warp(x, *draws["warp"])
            if self.freq_mask_flag:
                x = self.mask_along_axis(x, *draws["freq"], axis=2)
            if self.time_mask_flag:
                x = self.mask_along_axis(x, *draws["time"], axis=1)
            return x

    def draw(self, shape, generator=None, device=None):
        """The random values of one call on (B, T, F) features, as tensors
        on ``device`` (None: the generator's): ``{"warp": (c, w) 0-d or
        None, "freq": (lens, pos), "time": (lens, pos)}``, lens and pos
        (B, n)."""
        B, T, F = shape
        if device is None and generator is not None:
            device = generator.device

        def randint(lo, hi, size):
            return torch.randint(lo, hi, size, generator=generator,
                                 device=device)

        W = self.time_warp_window
        warp = None
        if T > 2 * W:
            c = randint(W, T - W, ())
            warp = (c, c + randint(-W, W + 1, ()))

        def band(n, width, D):
            lo, hi = width
            lens = randint(lo, max(hi, lo + 1), (B, n))
            return lens, randint(0, max(1, D - hi), (B, n))

        return {"warp": warp,
                "freq": band(self.n_freq_mask, self.freq_mask_width, F),
                "time": band(self.n_time_mask, self.time_mask_width, T)}

    @staticmethod
    def time_warp(x, c, w):
        """Remap time so that frame c lands on frame w: [0, c] onto
        [0, w] and [c, T-1] onto [w, T-1], linear in between."""
        T = x.shape[1]
        pos = torch.arange(T, device=x.device, dtype=torch.float32)
        left = pos * c / torch.clamp(w, min=1)
        right = c + (pos - w) * (T - 1 - c) / torch.clamp(T - 1 - w, min=1)
        src = torch.where(pos < w, left, right).clamp(0, T - 1)
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=T - 1)
        frac = (src - lo)[None, :, None]
        return x[:, lo, :] * (1 - frac) + x[:, hi, :] * frac

    def mask_along_axis(self, x, lens, pos, axis):
        """Fill the union of the bands [pos, pos + lens) of each row
        along ``axis`` (1: time, 2: features)."""
        D = x.shape[axis]
        arange = torch.arange(D, device=x.device)[None, None, :]
        mask = ((arange >= pos[..., None])
                & (arange < (pos + lens)[..., None])).any(1)
        fill = 0.0 if self.replace_with_zero else x.mean()
        if axis == 1:
            return torch.where(mask[:, :, None], fill, x)
        return torch.where(mask[:, None, :], fill, x)


class TimeDomainSpecAugment(torch.nn.Module):
    """Speed perturbation -> frequency drop -> chunk drop on raw
    waveforms (``processing.speech_augmentation``'s ``SpeedPerturb``,
    ``DropFreq`` and ``DropChunk``, with the JAX class's arguments and
    defaults); returns ``(waveforms, lengths)``, the lengths as the
    speed change leaves them (``min(lengths * t_new / T, 1)``, not the
    JAX package's ``lengths * 100 / speed``: see
    ``processing/speech_augmentation.py``).

    Its draws come from ``generator`` (the trainer's, on the waveforms'
    device) with no host sync, or are given as ``draws`` (``draw`` makes
    them).  A call runs in a ``record_function`` range named
    "time_domain_augment".

    Example
    -------
    >>> aug = TimeDomainSpecAugment(sample_rate=16000)
    >>> wav, lens = aug(torch.ones(2, 8000), torch.ones(2), torch.Generator())
    >>> wav.shape, lens.shape
    (torch.Size([2, 8000]), torch.Size([2]))
    """

    def __init__(self, perturb_prob=1.0, drop_freq_prob=1.0,
                 drop_chunk_prob=1.0, speeds=[95, 100, 105], sample_rate=16000,
                 drop_freq_count_low=0, drop_freq_count_high=3,
                 drop_chunk_count_low=0, drop_chunk_count_high=5,
                 drop_chunk_length_low=1000, drop_chunk_length_high=2000,
                 drop_chunk_noise_factor=0):
        super().__init__()
        self.speed_perturb = SpeedPerturb(
            perturb_prob=perturb_prob, orig_freq=sample_rate, speeds=speeds)
        self.drop_freq = DropFreq(
            drop_prob=drop_freq_prob, drop_count_low=drop_freq_count_low,
            drop_count_high=drop_freq_count_high)
        self.drop_chunk = DropChunk(
            drop_prob=drop_chunk_prob, drop_count_low=drop_chunk_count_low,
            drop_count_high=drop_chunk_count_high,
            drop_length_low=drop_chunk_length_low,
            drop_length_high=drop_chunk_length_high,
            noise_factor=drop_chunk_noise_factor)

    def draw(self, shape, generator=None, device=None):
        """The random values of one call on (B, T) waveforms: ``{"speed",
        "freq", "chunk"}``, each the ``draw`` of its augmentor."""
        if device is None and generator is not None:
            device = generator.device
        return {"speed": self.speed_perturb.draw(generator, device),
                "freq": self.drop_freq.draw(generator, device),
                "chunk": self.drop_chunk.draw(shape, generator, device)}

    def forward(self, waveforms, lengths, generator=None, draws=None):
        """waveforms (B, T) float, lengths (B,) relative."""
        with torch.profiler.record_function("time_domain_augment"):
            if draws is None:
                draws = self.draw(waveforms.shape, generator, waveforms.device)
            waveforms, lengths = self.speed_perturb(waveforms, lengths,
                                                    draws=draws["speed"])
            waveforms = self.drop_freq(waveforms, draws=draws["freq"])
            waveforms = self.drop_chunk(waveforms, lengths,
                                        draws=draws["chunk"])
            return waveforms, lengths
