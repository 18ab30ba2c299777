"""Conv-TasNet source separation (encoder, temporal-convolution masker,
decoder).

Counterpart of ``speechbrain_tpu/lobes/models/conv_tasnet.py``
(``Encoder``, ``Decoder``, ``ChannelwiseLayerNorm``, ``GlobalLayerNorm``,
``choose_norm``, ``Chomp1d``, ``DepthwiseSeparableConv``,
``TemporalBlock``, ``TemporalBlocksSequential``, ``MaskNet``,
``ConvTasNet``, ``BinauralConvTasNet``), channels-last as there.  The 1x1 convolutions are
``Linear`` layers; the depthwise dilated convolution is a grouped
``F.conv1d`` (it reaches no kernel in JAX either), reflect-padded for
"same" as the JAX ``Conv1d``; ``GlobalLayerNorm`` is ``dual_path``'s (the
same arithmetic on these (M, K, C) inputs).  The binaural model's
interaural level differences are resized to the encoder's frames by
``F.interpolate`` (linear, half-pixel centres), which is JAX's
``jax.image.resize(method="linear")`` when it enlarges; it asserts that
it does (JAX antialiases when it shrinks).
"""

import torch
import torch.nn.functional as F

from ...nnet.activations import PReLU
from ...nnet.CNN import Conv1d
from ...nnet.linear import Linear
from ...processing.features import STFT, spectral_magnitude
from ...processing.signal_processing import overlap_and_add
from .dual_path import GlobalLayerNorm

__all__ = ["Encoder", "Decoder", "ChannelwiseLayerNorm", "GlobalLayerNorm",
           "choose_norm", "Chomp1d", "DepthwiseSeparableConv", "TemporalBlock",
           "TemporalBlocksSequential", "MaskNet", "ConvTasNet",
           "BinauralConvTasNet"]

EPS = 1e-8


class Encoder(torch.nn.Module):
    """Waveform (B, T) -> latent frames (B, T // (L / 2) + 1, N): a
    bias-free convolution of L taps at stride L / 2 with the JAX
    ``Conv1d``'s "same" padding (L / 2 reflected samples each side), then
    ReLU.

    Example
    -------
    >>> Encoder(L=8, N=6)(torch.ones(2, 64)).shape
    torch.Size([2, 17, 6])
    """

    def __init__(self, L=16, N=512):
        super().__init__()
        self.conv = Conv1d(1, N, L, stride=L // 2, bias=False)

    def forward(self, x):
        return torch.relu(self.conv(x))


class Decoder(torch.nn.Module):
    """Latent frames (M, K, N) and masks (M, K, C, N) -> waveforms (M, T,
    C): each source's masked frames through the bias-free basis ``Linear``
    (N -> L), overlap-added at hop L / 2.

    Example
    -------
    >>> Decoder(L=8, N=6)(torch.ones(2, 17, 6), torch.ones(2, 17, 2, 6)).shape
    torch.Size([2, 72, 2])
    """

    def __init__(self, L=16, N=512):
        super().__init__()
        self.L = L
        self.basis = Linear(N, L, bias=False)

    def forward(self, mixture_w, est_mask):
        source_w = (mixture_w[:, :, None, :] * est_mask).transpose(1, 2)
        est = overlap_and_add(self.basis(source_w), self.L // 2)  # (M, C, T)
        return est.transpose(1, 2)


class ChannelwiseLayerNorm(torch.nn.Module):
    """cLN: each frame normalized over its channels (biased variance, eps
    1e-8), per-channel ``weight``/``bias`` (JAX's ``gamma``/``beta``).

    Example
    -------
    >>> ChannelwiseLayerNorm(8)(torch.randn(2, 20, 8)).shape
    torch.Size([2, 20, 8])
    """

    def __init__(self, channel_size, eps=EPS):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(channel_size))
        self.bias = torch.nn.Parameter(torch.zeros(channel_size))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (self.weight.to(x.dtype) * (x - mean) / torch.sqrt(var + self.eps)
                + self.bias.to(x.dtype))


def choose_norm(norm_type, channel_size):
    """"gLN" -> ``GlobalLayerNorm``, "cLN" -> ``ChannelwiseLayerNorm``,
    anything else -> a LayerNorm over the channels with Flax's eps
    (1e-6), as in JAX.

    Example
    -------
    >>> type(choose_norm("gLN", 8)).__name__
    'GlobalLayerNorm'
    """
    if norm_type == "gLN":
        return GlobalLayerNorm(channel_size)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channel_size)
    return torch.nn.LayerNorm(channel_size, eps=1e-6)


class Chomp1d(torch.nn.Module):
    """Drops the last ``chomp_size`` frames of (B, T, C).

    Example
    -------
    >>> Chomp1d(3)(torch.ones(2, 23, 8)).shape
    torch.Size([2, 20, 8])
    """

    def __init__(self, chomp_size):
        super().__init__()
        self.chomp_size = chomp_size

    def forward(self, x):
        return x[:, :x.shape[1] - self.chomp_size]


class DepthwiseSeparableConv(torch.nn.Module):
    """Depthwise dilated convolution ("same", reflect-padded, or causal)
    -> PReLU (slope 0.25) -> norm -> bias-free 1x1 to ``out_channels``.

    Example
    -------
    >>> DepthwiseSeparableConv(16, 8, kernel_size=3)(torch.ones(2, 20, 16)).shape
    torch.Size([2, 20, 8])
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 dilation=1, causal=False, norm_type="gLN"):
        super().__init__()
        self.depthwise = Conv1d(in_channels, in_channels, kernel_size,
                                stride=stride, dilation=dilation,
                                padding="causal" if causal else "same",
                                groups=in_channels, bias=False)
        self.act = PReLU(0.25)
        self.norm = choose_norm(norm_type, in_channels)
        self.pointwise = Linear(in_channels, out_channels, bias=False)

    def forward(self, x):
        return self.pointwise(self.norm(self.act(self.depthwise(x))))


class TemporalBlock(torch.nn.Module):
    """Bias-free 1x1 to ``out_channels`` (H) -> PReLU (0.25) -> norm ->
    ``DepthwiseSeparableConv`` back to ``in_channels``, plus the input.

    Example
    -------
    >>> TemporalBlock(8, 5, kernel_size=3, dilation=2)(torch.ones(2, 20, 8)).shape
    torch.Size([2, 20, 8])
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 dilation=1, norm_type="gLN", causal=False):
        super().__init__()
        self.conv = Linear(in_channels, out_channels, bias=False)
        self.act = PReLU(0.25)
        self.norm = choose_norm(norm_type, out_channels)
        self.dsconv = DepthwiseSeparableConv(
            out_channels, in_channels, kernel_size, stride=stride,
            dilation=dilation, causal=causal, norm_type=norm_type)

    def forward(self, x):
        return self.dsconv(self.norm(self.act(self.conv(x)))) + x


class TemporalBlocksSequential(torch.nn.Sequential):
    """R repeats of X ``TemporalBlock``s with dilations 1, 2, ..., 2^(X-1).

    Example
    -------
    >>> TemporalBlocksSequential(8, H=16, P=3, R=1, X=2)(torch.ones(2, 40, 8)).shape
    torch.Size([2, 40, 8])
    """

    def __init__(self, in_channels, H, P, R, X, norm_type="gLN", causal=False):
        super().__init__(*(
            TemporalBlock(in_channels, H, P, dilation=2 ** i,
                          norm_type=norm_type, causal=causal)
            for _ in range(R) for i in range(X)))


class MaskNet(torch.nn.Module):
    """cLN -> bias-free bottleneck 1x1 (N -> B) -> the R x X temporal
    blocks -> bias-free mask 1x1 (B -> C N) -> ReLU (or a softmax over
    N).  Latent frames (M, K, N) -> masks (C, M, K, N).

    Example
    -------
    >>> MaskNet(N=6, B=4, H=5, P=3, X=2, R=1, C=2)(torch.ones(2, 17, 6)).shape
    torch.Size([2, 2, 17, 6])
    """

    def __init__(self, N=512, B=128, H=512, P=3, X=8, R=3, C=2,
                 norm_type="gLN", causal=False, mask_nonlinear="relu"):
        super().__init__()
        self.C, self.N, self.mask_nonlinear = C, N, mask_nonlinear
        self.layer_norm = ChannelwiseLayerNorm(N)
        self.bottleneck = Linear(N, B, bias=False)
        self.temporal_conv_net = TemporalBlocksSequential(
            B, H, P, R, X, norm_type=norm_type, causal=causal)
        self.mask_conv = Linear(B, C * N, bias=False)

    def forward(self, mixture_w):
        M, K, _ = mixture_w.shape
        y = self.temporal_conv_net(self.bottleneck(self.layer_norm(mixture_w)))
        score = self.mask_conv(y).reshape(M, K, self.C, self.N)
        score = score.permute(2, 0, 1, 3)
        if self.mask_nonlinear == "softmax":
            return torch.softmax(score, -1)
        return torch.relu(score)


class ConvTasNet(torch.nn.Module):
    """``Encoder`` -> ``MaskNet`` -> ``Decoder``, cut or zero-padded to the
    mixture's length: (B, T) mixtures -> (B, T, C) estimates.

    Example
    -------
    >>> ConvTasNet(N=16, B=8, H=16, X=2, R=1, C=2, L=8)(torch.ones(1, 256)).shape
    torch.Size([1, 256, 2])
    """

    def __init__(self, N=512, B=128, H=512, P=3, X=8, R=3, C=2, L=16,
                 norm_type="gLN", causal=False, mask_nonlinear="relu"):
        super().__init__()
        self.encoder = Encoder(L, N)
        self.masknet = MaskNet(N, B, H, P, X, R, C, norm_type=norm_type,
                               causal=causal, mask_nonlinear=mask_nonlinear)
        self.decoder = Decoder(L, N)

    def forward(self, mixture):
        T = mixture.shape[1]
        w = self.encoder(mixture)
        y = self.decoder(w, self.masknet(w).permute(1, 2, 0, 3))
        return _fit_length(y, T)


def _fit_length(y, T):
    """``y`` (B, T', ...) cut or zero-padded to T frames."""
    if y.shape[1] >= T:
        return y[:, :T]
    return F.pad(y, (0, 0) * (y.dim() - 2) + (0, T - y.shape[1]))


class BinauralConvTasNet(torch.nn.Module):
    """Conv-TasNet for two ears: (B, T, 2) mixtures -> (B, T, 2, C)
    estimates, each ear with its own ``Encoder``/``Decoder``
    (``encoder_l``/``_r``, ``decoder_l``/``_r``) and masker
    (``masknet_l``/``_r``), wired by ``mode``:

    - "independent": each ear's masker sees its ear's latent frames;
    - "parallel": ``masknet_l`` sees ``encoder_l(left) || encoder_r(right)``
      and ``masknet_r`` ``encoder_r(left) || encoder_l(right)`` (the
      encoders' weights shared between the pairings); each 2N-channel mask
      is split, applied to the two latents it saw, and the two products
      summed for the ear;
    - "cross": the interaural level difference, 10 log10(|L| / (|R| +
      1e-8) + 1e-8) of the ears' STFT magnitudes (256 samples at hop
      128), resized to the encoder's frames, projected by ``ild_proj``
      (a Linear to N) and concatenated to each ear's latent (sign-flipped
      for the right); each ear keeps the first N channels of its mask.

    The decoders take the masked latents as masks over ones, as in JAX.

    Example
    -------
    >>> net = BinauralConvTasNet(mode="cross", N=16, B=8, H=16, X=2, R=1,
    ...                          C=2, L=8)
    >>> net(torch.ones(1, 2048, 2)).shape
    torch.Size([1, 2048, 2, 2])
    """

    def __init__(self, mode="parallel", N=256, B=128, H=256, P=3, X=6, R=2,
                 C=2, L=16, norm_type="gLN", causal=False,
                 mask_nonlinear="relu", sample_rate=8000):
        super().__init__()
        if mode not in ("independent", "parallel", "cross"):
            raise ValueError(f"unknown binaural mode {mode}")
        self.mode, self.N = mode, N
        self.encoder_l, self.encoder_r = Encoder(L, N), Encoder(L, N)
        self.decoder_l, self.decoder_r = Decoder(L, N), Decoder(L, N)
        n_in = N if mode == "independent" else 2 * N
        self.masknet_l, self.masknet_r = (
            MaskNet(n_in, B, H, P, X, R, C, norm_type=norm_type,
                    causal=causal, mask_nonlinear=mask_nonlinear)
            for _ in range(2))
        if mode == "cross":
            self.stft = STFT(sample_rate, 256 * 1000.0 / sample_rate,
                             128 * 1000.0 / sample_rate, n_fft=256)
            self.ild_proj = Linear(129, N)

    def _ild(self, xl, xr, K):
        """(B, K, N): the projected ILD at the encoder's K frames."""
        eps = 1e-8
        mag_l = spectral_magnitude(self.stft(xl), power=0.5)
        mag_r = spectral_magnitude(self.stft(xr), power=0.5)
        ild = 10.0 * torch.log10(mag_l / (mag_r + eps) + eps)
        assert K >= ild.shape[1], (K, ild.shape)  # enlarging only
        ild = F.interpolate(ild.transpose(1, 2), size=K, mode="linear",
                            align_corners=False).transpose(1, 2)
        return self.ild_proj(ild)

    def forward(self, mix):
        T, N = mix.shape[1], self.N
        xl, xr = mix[:, :, 0], mix[:, :, 1]
        wl, wr = self.encoder_l(xl), self.encoder_r(xr)
        if self.mode == "independent":
            sep_l = wl[None] * self.masknet_l(wl)  # (C, B, K, N)
            sep_r = wr[None] * self.masknet_r(wr)
        elif self.mode == "parallel":
            masks_l = self.masknet_l(torch.cat([wl, wr], -1))
            wl2, wr1 = self.encoder_r(xl), self.encoder_l(xr)
            masks_r = self.masknet_r(torch.cat([wl2, wr1], -1))
            sep_l = wl[None] * masks_l[..., :N] + wr[None] * masks_l[..., N:]
            sep_r = (wl2[None] * masks_r[..., :N]
                     + wr1[None] * masks_r[..., N:])
        else:
            ild = self._ild(xl, xr, wl.shape[1])
            masks_l = self.masknet_l(torch.cat([wl, ild], -1))
            masks_r = self.masknet_r(torch.cat([wr, -ild], -1))
            sep_l = wl[None] * masks_l[..., :N]
            sep_r = wr[None] * masks_r[..., :N]
        ones = torch.ones_like(wl)
        est = torch.stack([dec(ones, sep.permute(1, 2, 0, 3)) for dec, sep in
                           ((self.decoder_l, sep_l), (self.decoder_r, sep_r))],
                          dim=2)  # (B, T', 2, C)
        return _fit_length(est, T)
