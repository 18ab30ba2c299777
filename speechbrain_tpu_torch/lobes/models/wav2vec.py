"""Native wav2vec 2.0 components.

Counterpart of ``speechbrain_tpu/lobes/models/wav2vec.py``:
``W2VLatentExtractor``, ``W2VTargetQuantiser``, ``EncoderWrapper``,
``compute_mask``, ``sample_negatives`` (here split into
``negative_offsets`` and ``gather_negatives``) and
``w2v_mask_collate_fn``.  Three things differ from PyTorch's defaults and
follow Flax: the LayerNorms take eps 1e-6, ``jax.nn.gelu`` is the tanh
approximation, and ``EncoderWrapper`` holds ``mask_emb`` only when built
to take a mask (Flax creates it only when the init call passes one), so
the parameter trees map one to one (``bridge.wav2vec_state_dict``).
"""

import numpy as np
import torch

from ...nnet.linear import Linear
from ...nnet.quantisers import GumbelVectorQuantizer
from .transformer.Conformer import LayerNorm, _ln
from .transformer.Transformer import PositionalEncoding, TransformerEncoder

__all__ = [
    "W2VLatentExtractor",
    "W2VTargetQuantiser",
    "EncoderWrapper",
    "compute_mask",
    "negative_offsets",
    "gather_negatives",
    "sample_negatives",
    "w2v_mask_collate_fn",
]


class W2VLatentExtractor(torch.nn.Module):
    """Strided convolutions: raw wave -> latents (~50 Hz at 16 kHz).

    Each layer is a VALID ``Conv1d`` without bias, a LayerNorm over the
    channels (eps 1e-6) and the tanh GELU.  As in JAX, the layers are the
    ``zip`` of the three tuples (two ``out_channels`` take the first two
    kernel sizes and strides).  The input is a (B, N) wave (or (B, N,
    1)): the JAX module sizes ``conv_0`` from its first input, so a (B, N,
    2) stereo batch gives it two input channels; no recipe of the port
    feeds one.

    Example
    -------
    >>> ext = W2VLatentExtractor(out_channels=(16,) * 7)
    >>> ext(torch.ones(2, 16000)).shape
    torch.Size([2, 48, 16])
    """

    def __init__(self, out_channels=(512,) * 7,
                 kernel_sizes=(11, 3, 3, 3, 3, 3, 3),
                 strides=(5, 2, 2, 2, 2, 2, 2)):
        super().__init__()
        layers = list(zip(out_channels, kernel_sizes, strides))
        ins = [1] + [c for c, _, _ in layers[:-1]]
        self.convs = torch.nn.ModuleList(
            torch.nn.Conv1d(i, c, k, stride=s, bias=False)
            for i, (c, k, s) in zip(ins, layers))
        self.norms = torch.nn.ModuleList(LayerNorm(c) for c, _, _ in layers)
        self.kernel_sizes = [k for _, k, _ in layers]
        self.strides = [s for _, _, s in layers]
        self.output_size = layers[-1][0]

    def get_output_lengths(self, n):
        """The frames a wave of ``n`` samples gives (VALID convolutions)."""
        for k, s in zip(self.kernel_sizes, self.strides):
            n = (n - k) // s + 1
        return n

    def forward(self, x):
        """x: (B, N) or (B, N, 1); returns (B, T, C) in x's dtype."""
        if x.dim() == 2:
            x = x[..., None]
        for conv, norm in zip(self.convs, self.norms):
            x = torch.nn.functional.conv1d(
                x.transpose(1, 2), conv.weight.to(x.dtype),
                stride=conv.stride).transpose(1, 2)
            x = torch.nn.functional.gelu(_ln(norm, x), approximate="tanh")
        return x


class W2VTargetQuantiser(torch.nn.Module):
    """Gumbel product quantiser and the targets' projection.

    ``quantiser`` is a ``GumbelVectorQuantizer`` (the JAX
    ``GumbelVectorQuantizer_0``), ``proj`` a ``Linear`` (``Dense_0``).
    Returns ``(targets (B, T, out_dim) in x's dtype, {"diversity_loss",
    "num_vars"})``, the diversity loss ``(num_vars - perplexity) /
    num_vars``.  The quantiser runs at its first temperature: the JAX
    module passes none, so nothing anneals it.

    Example
    -------
    >>> q = W2VTargetQuantiser(16, 8, quantiser_vars=4).eval()
    >>> targets, meta = q(torch.ones(2, 5, 16))
    >>> targets.shape, meta["num_vars"]
    (torch.Size([2, 5, 8]), 8)
    """

    def __init__(self, in_dim=512, out_dim=256, quantiser_vars=320,
                 quantiser_groups=2):
        super().__init__()
        self.quantiser = GumbelVectorQuantizer(
            in_dim, num_vars=quantiser_vars, groups=quantiser_groups,
            vq_dim=out_dim)
        self.proj = Linear(out_dim, out_dim)

    def forward(self, x, generator=None, uniform=None):
        """x (B, T, in_dim); the noise as ``GumbelVectorQuantizer``'s."""
        vq = self.quantiser(x, generator=generator, uniform=uniform)
        targets = self.proj(vq["x"].to(x.dtype))
        meta = {"diversity_loss": (vq["num_vars"] - vq["prob_perplexity"])
                / vq["num_vars"], "num_vars": vq["num_vars"]}
        return targets, meta


class EncoderWrapper(torch.nn.Module):
    """Latents -> contextual representations: a ``Linear`` to
    ``embedding_dim`` (``latent_proj``, the JAX ``Dense_0``), the learned
    ``mask_emb`` where ``mask`` is set, ``x + PositionalEncoding(x)``, then
    a pre-norm ``TransformerEncoder`` (regularMHA, relu FFN), with a key
    padding mask ``arange(T) >= wav_lens * T`` only when ``wav_lens`` is
    given.

    ``mask_emb=True`` builds the ``mask_emb`` parameter (the pretraining
    encoder's); without it a ``mask`` raises.  The JAX module's
    ``in_dim`` goes unused; here it sizes ``latent_proj``.

    Example
    -------
    >>> enc = EncoderWrapper(16, 32, num_layers=1, nhead=2, d_ffn=64).eval()
    >>> enc(torch.ones(2, 5, 16))["embeddings"].shape
    torch.Size([2, 5, 32])
    """

    def __init__(self, in_dim=512, embedding_dim=768, num_layers=12, nhead=8,
                 d_ffn=3072, dropout=0.1, mask_emb=False):
        super().__init__()
        self.latent_proj = Linear(in_dim, embedding_dim)
        if mask_emb:
            self.mask_emb = torch.nn.Parameter(
                torch.rand(embedding_dim) * 0.1)
        self.positional_encoding = PositionalEncoding(embedding_dim)
        self.encoder = TransformerEncoder(num_layers, nhead, d_ffn,
                                          embedding_dim, dropout,
                                          normalize_before=True)

    def forward(self, latents, wav_lens=None, mask=None):
        """latents (B, T, in_dim); ``wav_lens`` (B,) relative; ``mask``
        (B, T) bool.  Returns ``{"embeddings": (B, T, embedding_dim)}``."""
        x = self.latent_proj(latents)
        if mask is not None:
            if not hasattr(self, "mask_emb"):
                raise ValueError("a mask needs an EncoderWrapper built with "
                                 "mask_emb=True")
            x = torch.where(mask[..., None], self.mask_emb.to(x.dtype), x)
        x = x + self.positional_encoding(x)
        key_padding = None
        if wav_lens is not None:
            T = x.shape[1]
            key_padding = (torch.arange(T, device=x.device)[None, :]
                           >= (wav_lens.to(x.device) * T)[:, None])
        out, _ = self.encoder(x, src_key_padding_mask=key_padding)
        return {"embeddings": out}


def compute_mask(shape, sample_lens, mask_prob=0.65, mask_length=10, seed=0):
    """Boolean span mask (B, T) with ~mask_prob coverage (host-side numpy;
    the JAX function's draws, so one seed gives the same mask bit for
    bit)."""
    B, T = shape
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T), dtype=bool)
    num_spans = int(mask_prob * T / mask_length + rng.random())
    for b in range(B):
        limit = min(sample_lens[b] if sample_lens is not None else T, T)
        if limit <= mask_length:
            continue
        starts = rng.integers(0, limit - mask_length, size=num_spans)
        for s in starts:
            mask[b, s : s + mask_length] = True
    return mask


def negative_offsets(num_neg, B, T, generator=None, device=None):
    """(num_neg, B, T) int64 offsets in [1, max(T, 2)) drawn from
    ``generator``: each negative is another frame of the same utterance."""
    return torch.randint(1, max(T, 2), (num_neg, B, T), generator=generator,
                         device=device)


def gather_negatives(y, offsets):
    """y (B, T, C) and ``offsets`` (N, B, T) -> (N, B, T, C): frame
    ``(t + offset) mod T`` of the same row."""
    N, B, T = offsets.shape
    idx = (torch.arange(T, device=y.device)[None, None, :] + offsets) % T
    return y[torch.arange(B, device=y.device)[None, :, None], idx]


def sample_negatives(y, num_neg, generator=None):
    """``num_neg`` distractors a frame from other frames of the same
    utterance: y (B, T, C) -> (num_neg, B, T, C)."""
    B, T, _ = y.shape
    return gather_negatives(y, negative_offsets(num_neg, B, T, generator,
                                                y.device))


def w2v_mask_collate_fn(samples_lst, get_out_len_fn, mask_prob, mask_length,
                        seed=0):
    """Collate raw waveforms for wav2vec2 pretraining: right-pad, compute
    the latent lengths with ``get_out_len_fn`` and draw the batch's mask
    (``compute_mask``).  Returns ``((wavs, wav_lens, mask), ())`` as numpy
    arrays, the JAX function's (inputs, dummy targets).

    Example
    -------
    >>> out = w2v_mask_collate_fn(
    ...     [{"sig": np.ones(320)}, {"sig": np.ones(480)}],
    ...     get_out_len_fn=lambda n: n // 320,
    ...     mask_prob=0.5, mask_length=1)
    >>> (wavs, wav_lens, mask), _ = out
    >>> wavs.shape
    (2, 480)
    """
    wav_lens = [len(s["sig"]) for s in samples_lst]
    max_len = max(wav_lens)
    wavs = np.zeros((len(samples_lst), max_len), dtype=np.float32)
    for i, s in enumerate(samples_lst):
        wavs[i, : wav_lens[i]] = np.asarray(s["sig"], dtype=np.float32)
    out_lens = np.asarray([int(get_out_len_fn(n)) for n in wav_lens])
    T_out = int(out_lens.max())
    mask = compute_mask((len(samples_lst), T_out), out_lens,
                        mask_prob=mask_prob, mask_length=mask_length,
                        seed=seed)
    rel_lens = np.asarray(wav_lens, dtype=np.float32) / max_len
    return (wavs, rel_lens, np.asarray(mask)), ()
