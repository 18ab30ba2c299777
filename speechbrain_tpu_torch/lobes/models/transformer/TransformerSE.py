"""CNN-Transformer speech enhancement: a transformer encoder that maps a
magnitude spectrogram to a mask, and the wrapper that runs it from a
waveform to a waveform.

Counterpart of ``speechbrain_tpu/lobes/models/transformer/TransformerSE.py``
(``CNNTransformerSE``, ``SpectralMaskWrapper``).  Where the JAX module
adds its Dense ``in_proj`` when the input's width differs from
``d_model`` (it sees the width at its first call), the port takes the
input's width at construction (``input_size``, by default
``output_size``: a mask is as wide as its input).
"""

import torch

from ....nnet.linear import Linear
from ....processing.features import ISTFT, STFT, spectral_magnitude
from ....processing.signal_processing import resynthesize
from .Transformer import (TransformerEncoder, get_key_padding_mask,
                          get_lookahead_mask)

__all__ = ["CNNTransformerSE", "SpectralMaskWrapper"]

_OUTPUT_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": torch.nn.functional.softplus,
}


class CNNTransformerSE(torch.nn.Module):
    """``custom_emb_module`` (optional) -> ``in_proj`` (a Linear to
    ``d_model``, present when ``input_size`` differs from it) -> a
    ``TransformerEncoder`` (``activation`` "leaky_relu", slope 0.01; a
    lookahead mask when ``causal``, a key padding mask from ``lengths``)
    -> a bias-free Linear to ``output_size`` -> ``output_activation``
    ("relu", "sigmoid", "softplus", anything else: none).  (B, T,
    input_size) -> (B, T, output_size).

    Example
    -------
    >>> net = CNNTransformerSE(d_model=32, output_size=33, num_layers=2,
    ...                        nhead=4, d_ffn=64).eval()
    >>> net(torch.ones(2, 12, 33)).shape
    torch.Size([2, 12, 33])
    """

    def __init__(self, d_model, output_size, output_activation="relu",
                 nhead=8, num_layers=8, d_ffn=512, dropout=0.1,
                 activation="leaky_relu", causal=True, custom_emb_module=None,
                 normalize_before=False, input_size=None):
        super().__init__()
        self.causal = causal
        self.output_activation = output_activation
        self.custom_emb_module = custom_emb_module
        input_size = output_size if input_size is None else input_size
        self.in_proj = (Linear(input_size, d_model)
                        if input_size != d_model else None)
        self.encoder = TransformerEncoder(
            num_layers, nhead, d_ffn, d_model, dropout=dropout,
            activation=activation, normalize_before=normalize_before)
        self.output_layer = Linear(d_model, output_size, bias=False)

    def forward(self, x, lengths=None):
        T = x.shape[1]
        attn_mask = get_lookahead_mask(T, x.device) if self.causal else None
        key_padding_mask = (None if lengths is None
                            else get_key_padding_mask(lengths, T))
        if self.custom_emb_module is not None:
            x = self.custom_emb_module(x)
        if self.in_proj is not None:
            x = self.in_proj(x)
        out, _ = self.encoder(x, src_mask=attn_mask,
                              src_key_padding_mask=key_padding_mask)
        out = self.output_layer(out)
        act = _OUTPUT_ACTIVATIONS.get(self.output_activation)
        return out if act is None else act(out)


class SpectralMaskWrapper(torch.nn.Module):
    """A spectral masker as a waveform-to-waveform model: the STFT
    (``win_length``/``hop_length`` in ms, ``n_fft``), the magnitude at
    ``mag_power`` (0.5: the magnitude), ``masker`` on it, the enhanced
    magnitude ``(max(mask, 0) mag) ** (1 / mag_power)``, ``resynthesize``
    with the noisy phase, cut or zero-padded to the input's length.  (B,
    T) -> (B, T, 1), the separation models' contract with one source.

    Example
    -------
    >>> net = SpectralMaskWrapper(
    ...     CNNTransformerSE(d_model=16, output_size=129, num_layers=1,
    ...                      nhead=4, d_ffn=32), n_fft=256).eval()
    >>> net(torch.ones(1, 2000)).shape
    torch.Size([1, 2000, 1])
    """

    def __init__(self, masker, sample_rate=8000, win_length=32.0,
                 hop_length=16.0, n_fft=512, mag_power=0.5):
        super().__init__()
        self.masker = masker
        self.mag_power = mag_power
        self.stft = STFT(sample_rate, win_length, hop_length, n_fft)
        self.istft = ISTFT(sample_rate, win_length, hop_length, n_fft)

    def forward(self, wav):
        mag = spectral_magnitude(self.stft(wav), power=self.mag_power)
        mask = self.masker(mag)
        enhanced = (torch.maximum(mask, mask.new_zeros(())) * mag) ** (
            1.0 / self.mag_power)
        out = resynthesize(enhanced, wav, self.stft, self.istft)
        T = wav.shape[1]
        if out.shape[1] >= T:
            out = out[:, :T]
        else:
            out = torch.nn.functional.pad(out, (0, T - out.shape[1]))
        return out[..., None]
