"""Dual-path separation models: the SepFormer, its conformer-intra
variant and the DPRNN, and the other intra/inter blocks.

Counterpart of ``speechbrain_tpu/lobes/models/dual_path.py``
(``Encoder``, ``Decoder``, ``SBTransformerBlock``,
``SBConformerEncoderBlock``, ``SBRNNBlock``, ``Dual_Path_Model``,
``SepformerWrapper``, ``GlobalLayerNorm``, ``CumulativeLayerNorm``,
``select_norm``, ``PyTorchPositionalEncoding``,
``PytorchTransformerBlock``, ``DPTNetBlock``, ``Dual_Computation_Block``
and the ``FastTransformerBlock`` stub), channels-last as there.

The chunking and the overlap-add of ``Dual_Path_Model`` run without a
gather or a scatter: the chunk size K is even (250 in every yaml; an odd
K raises) and the hop K / 2, so the padded sequence is S + 1 blocks of
K / 2 frames, chunk s is blocks s and s + 1, and the overlap-add is the
sum of the chunks' first halves and the previous chunks' second halves.
Both directions and their gradients are then slices, concatenations and
sums, deterministic on CUDA (an ``index_add_`` accumulates with atomics
there).
"""

import math

import torch
import torch.nn.functional as F

from ...nnet.activations import PReLU
from ...nnet.attention import MultiheadAttention, RelPosEncXL
from ...nnet.CNN import Conv1d, ConvTranspose1d
from ...nnet.dropout import Dropout
from ...nnet.linear import Linear
from ...nnet.RNN import GRU, LSTM
from .transformer.Conformer import ConformerEncoder, LayerNorm, _ln
from .transformer.Transformer import PositionalEncoding, TransformerEncoder

__all__ = [
    "Encoder",
    "Decoder",
    "SBTransformerBlock",
    "SBConformerEncoderBlock",
    "SBRNNBlock",
    "Dual_Path_Model",
    "SepformerWrapper",
    "GlobalLayerNorm",
    "CumulativeLayerNorm",
    "select_norm",
    "PyTorchPositionalEncoding",
    "PytorchTransformerBlock",
    "DPTNetBlock",
    "FastTransformerBlock",
    "Dual_Computation_Block",
]


class Encoder(torch.nn.Module):
    """Waveform (B, T) -> latent (B, T', N): a bias-free convolution of
    ``kernel_size`` taps at stride ``kernel_size // 2``, no padding, then
    ReLU.

    Example
    -------
    >>> Encoder(kernel_size=16, out_channels=8)(torch.ones(2, 400)).shape
    torch.Size([2, 49, 8])
    """

    def __init__(self, kernel_size=16, out_channels=256, in_channels=1):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           stride=kernel_size // 2, padding="valid",
                           bias=False)

    def forward(self, x):
        return torch.relu(self.conv(x))


class Decoder(torch.nn.Module):
    """Latent (B, T', N) -> waveform (B, T''): a bias-free transposed
    convolution to one channel at stride ``kernel_size // 2``.

    Example
    -------
    >>> Decoder(kernel_size=16, in_channels=8)(torch.ones(2, 49, 8)).shape
    torch.Size([2, 400])
    """

    def __init__(self, kernel_size=16, in_channels=256):
        super().__init__()
        self.conv = ConvTranspose1d(in_channels, 1, kernel_size,
                                    stride=kernel_size // 2, bias=False)

    def forward(self, x):
        return self.conv(x)[..., 0]


class SBTransformerBlock(torch.nn.Module):
    """The sinusoidal positional encoding added, then a pre-norm
    ``TransformerEncoder`` (regular attention, ReLU FFN, final
    LayerNorm).

    Example
    -------
    >>> SBTransformerBlock(1, 16, 4, 32)(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, num_layers=2, d_model=256, nhead=8, d_ffn=1024,
                 dropout=0.0, use_positional_encoding=True):
        super().__init__()
        self.pos_enc = (PositionalEncoding(d_model)
                        if use_positional_encoding else None)
        self.mdl = TransformerEncoder(num_layers, nhead, d_ffn, d_model,
                                      dropout=dropout, normalize_before=True)

    def forward(self, x):
        if self.pos_enc is not None:
            x = x + self.pos_enc(x)
        return self.mdl(x)[0]


class SBConformerEncoderBlock(torch.nn.Module):
    """A ``ConformerEncoder`` over relative positional encodings
    (``RelPosEncXL``).  Its convolution modules run the depthwise
    convolution kernels on CUDA tensors; its attention takes the
    materialized path below the rel-pos kernel's gate (T % 128 == 0, T
    >= 512), as the chunks of 250 frames do.

    Example
    -------
    >>> blk = SBConformerEncoderBlock(1, 16, 4, d_ffn=32, kernel_size=3)
    >>> blk(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, num_layers, d_model, nhead, d_ffn=1024, kernel_size=31,
                 dropout=0.0):
        super().__init__()
        self.pos_enc = RelPosEncXL(d_model)
        self.mdl = ConformerEncoder(num_layers, d_model, d_ffn, nhead,
                                    kernel_size=kernel_size, dropout=dropout)

    def forward(self, x):
        return self.mdl(x, pos_embs=self.pos_enc(x))[0]


class SBRNNBlock(torch.nn.Module):
    """The DPRNN's block: a bidirectional ``LSTM`` of ``hidden_channels``
    units a direction (no output layer), (B, T, input_size) -> (B, T, 2
    hidden_channels).

    Example
    -------
    >>> SBRNNBlock(16, 8)(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, input_size, hidden_channels=128, num_layers=1):
        super().__init__()
        self.mdl = LSTM(input_size, hidden_channels, num_layers=num_layers,
                        bidirectional=True)

    def forward(self, x):
        return self.mdl(x)[0]


def _chunk(x, K):
    """(B, T, C) -> (B, S, K, C) chunks at hop K / 2: ``x`` padded with K / 2
    zeros in front and ``gap + K / 2`` behind, so that the chunks cover
    it, as JAX's gather takes them (the padded length is then a multiple
    of K / 2)."""
    B, T, C = x.shape
    P = K // 2
    gap = K - (P + T % K) % K
    blocks = F.pad(x, (0, 0, P, gap + P)).reshape(B, -1, P, C)  # S + 1
    return torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)


def _overlap_add(chunks, T):
    """The inverse of ``_chunk``: (B, S, K, C) -> (B, T, C), each frame the
    mean of the one or two chunks that hold it (JAX's scatter-add over the
    count)."""
    B, S, K, C = chunks.shape
    P = K // 2
    summed = (F.pad(chunks[:, :, :P], (0, 0, 0, 0, 0, 1))
              + F.pad(chunks[:, :, P:], (0, 0, 0, 0, 1, 0)))  # (B, S + 1, P, C)
    count = torch.full((S + 1, 1, 1), 2.0, device=chunks.device,
                       dtype=chunks.dtype)
    count[0] = count[-1] = 1.0
    return (summed / count).reshape(B, (S + 1) * P, C)[:, P:P + T]


class Dual_Path_Model(torch.nn.Module):
    """LayerNorm -> bias-free 1x1 conv -> chunks of K frames at 50 %
    overlap -> ``num_layers`` x (intra-chunk block over K, LayerNorm,
    residual; inter-chunk block over S, LayerNorm, residual) -> PReLU ->
    1x1 conv to ``num_spks`` x ``out_channels`` -> overlap-add -> ReLU.
    Takes (B, T, in_channels) and returns the masks (num_spks, B, T,
    out_channels).  ``K`` must be even.  ``intra_block``/``inter_block``:
    "transformer" (``SBTransformerBlock``), "conformer"
    (``SBConformerEncoderBlock``) or "rnn" (``SBRNNBlock`` of
    ``out_channels // 2`` units a direction, whatever the block's
    ``*_numlayers``, ``*_nhead`` and ``*_dffn``); ``use_rnn`` makes both
    "rnn" (the DPRNN).  The LayerNorms have Flax's eps (1e-6); the 1x1
    convolutions are ``Linear`` layers.

    Example
    -------
    >>> model = Dual_Path_Model(16, 16, num_layers=1, K=10, intra_numlayers=1,
    ...     inter_numlayers=1, intra_nhead=4, inter_nhead=4, intra_dffn=32,
    ...     inter_dffn=32)
    >>> model(torch.ones(1, 50, 16)).shape
    torch.Size([2, 1, 50, 16])
    """

    def __init__(self, in_channels=256, out_channels=256, num_layers=2, K=250,
                 num_spks=2, intra_numlayers=2, inter_numlayers=2,
                 intra_nhead=8, inter_nhead=8, intra_dffn=1024,
                 inter_dffn=1024, intra_block="transformer",
                 inter_block="transformer", conformer_kernel_size=31,
                 use_rnn=False):
        super().__init__()
        if use_rnn:
            intra_block = inter_block = "rnn"
        if K % 2:
            raise ValueError(f"chunk size {K}: an even one (hop K / 2)")
        self.K, self.num_spks, self.out_channels = K, num_spks, out_channels
        self.norm = LayerNorm(in_channels)
        self.conv1d = Linear(in_channels, out_channels, bias=False)

        def block(kind, numlayers, nhead, dffn):
            if kind == "conformer":
                return SBConformerEncoderBlock(
                    numlayers, out_channels, nhead, d_ffn=dffn,
                    kernel_size=conformer_kernel_size)
            if kind == "transformer":
                return SBTransformerBlock(numlayers, out_channels, nhead, dffn)
            if kind == "rnn":
                return SBRNNBlock(out_channels, out_channels // 2)
            raise ValueError(f"block {kind!r}: 'transformer', 'conformer' or "
                             "'rnn'")

        self.intra = torch.nn.ModuleList(
            block(intra_block, intra_numlayers, intra_nhead, intra_dffn)
            for _ in range(num_layers))
        self.inter = torch.nn.ModuleList(
            block(inter_block, inter_numlayers, inter_nhead, inter_dffn)
            for _ in range(num_layers))
        self.intra_norm = torch.nn.ModuleList(
            LayerNorm(out_channels) for _ in range(num_layers))
        self.inter_norm = torch.nn.ModuleList(
            LayerNorm(out_channels) for _ in range(num_layers))
        self.prelu = PReLU()
        self.conv_out = Linear(out_channels, out_channels * num_spks)

    def forward(self, x):
        B, T, _ = x.shape
        C = self.out_channels
        x = self.conv1d(_ln(self.norm, x))
        chunks = _chunk(x, self.K)
        S, K = chunks.shape[1], chunks.shape[2]
        for intra, intra_norm, inter, inter_norm in zip(
                self.intra, self.intra_norm, self.inter, self.inter_norm):
            y = _ln(intra_norm, intra(chunks.reshape(B * S, K, C)))
            chunks = chunks + y.reshape(B, S, K, C)
            y = inter(chunks.transpose(1, 2).reshape(B * K, S, C))
            y = _ln(inter_norm, y)
            chunks = chunks + y.reshape(B, K, S, C).transpose(1, 2)
        out = self.conv_out(self.prelu(chunks))  # (B, S, K, spks C)
        masks = torch.relu(_overlap_add(out, T))
        return masks.reshape(B, T, self.num_spks, C).permute(2, 0, 1, 3)


def decode_masked(decoder, w, masks, T):
    """Each source's mask of ``masks`` (num_spks, B, T', N) applied to the
    latent ``w`` (B, T', N), all decoded by ``decoder`` at once, cut or
    zero-padded to T samples -> (B, T, num_spks) estimates."""
    S, B = masks.shape[0], masks.shape[1]
    est = decoder((w[None] * masks).flatten(0, 1)).reshape(S, B, -1)
    if est.shape[-1] >= T:
        est = est[..., :T]
    else:
        est = F.pad(est, (0, T - est.shape[-1]))
    return est.permute(1, 2, 0)


class SepformerWrapper(torch.nn.Module):
    """The SepFormer (the DPRNN with ``use_rnn``): ``Encoder`` ->
    ``Dual_Path_Model`` masks -> each source's masked latent through the
    shared ``Decoder``, cut or zero-padded to the mixture's length.  (B,
    T) mixtures -> (B, T, num_spks) estimates.

    Example
    -------
    >>> model = SepformerWrapper(encoder_kernel_size=8,
    ...     encoder_out_nchannels=16, masknet_chunksize=10,
    ...     masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1,
    ...     intra_nhead=4, inter_nhead=4, intra_dffn=32, inter_dffn=32)
    >>> model(torch.ones(1, 400)).shape
    torch.Size([1, 400, 2])
    """

    def __init__(self, encoder_kernel_size=16, encoder_in_nchannels=1,
                 encoder_out_nchannels=256, masknet_chunksize=250,
                 masknet_numlayers=2, masknet_numspks=2, intra_numlayers=8,
                 inter_numlayers=8, intra_nhead=8, inter_nhead=8,
                 intra_dffn=1024, inter_dffn=1024, intra_block="transformer",
                 inter_block="transformer", conformer_kernel_size=31,
                 use_rnn=False):
        super().__init__()
        self.num_spks = masknet_numspks
        self.encoder = Encoder(encoder_kernel_size, encoder_out_nchannels,
                               encoder_in_nchannels)
        self.masknet = Dual_Path_Model(
            encoder_out_nchannels, encoder_out_nchannels,
            num_layers=masknet_numlayers, K=masknet_chunksize,
            num_spks=masknet_numspks, intra_numlayers=intra_numlayers,
            inter_numlayers=inter_numlayers, intra_nhead=intra_nhead,
            inter_nhead=inter_nhead, intra_dffn=intra_dffn,
            inter_dffn=inter_dffn, intra_block=intra_block,
            inter_block=inter_block,
            conformer_kernel_size=conformer_kernel_size, use_rnn=use_rnn)
        self.decoder = Decoder(encoder_kernel_size, encoder_out_nchannels)

    def forward(self, mix):
        w = self.encoder(mix)
        return decode_masked(self.decoder, w, self.masknet(w), mix.shape[1])


class GlobalLayerNorm(torch.nn.Module):
    """Normalization over every axis but the batch (biased variance, eps
    1e-8), with a per-channel ``weight`` and ``bias`` (JAX's ``gamma``
    and ``beta``).

    Example
    -------
    >>> GlobalLayerNorm(8)(torch.randn(2, 20, 8)).shape
    torch.Size([2, 20, 8])
    """

    def __init__(self, channels, eps=1e-8):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(channels))
        self.bias = torch.nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        dims = tuple(range(1, x.dim()))
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        return (self.weight.to(x.dtype) * (x - mean) / torch.sqrt(var + self.eps)
                + self.bias.to(x.dtype))


class CumulativeLayerNorm(torch.nn.LayerNorm):
    """Per-frame LayerNorm over the channels (eps 1e-8): nothing is
    cumulative, as in JAX and its reference.

    Example
    -------
    >>> CumulativeLayerNorm(8)(torch.randn(2, 20, 8)).shape
    torch.Size([2, 20, 8])
    """

    def __init__(self, channels, eps=1e-8):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return _ln(self, x)


def select_norm(norm, dim, eps=1e-8):
    """"gln" -> ``GlobalLayerNorm``, "cln" -> ``CumulativeLayerNorm``,
    anything else -> a LayerNorm over the channels, all over ``dim``
    channels with ``eps``.

    Example
    -------
    >>> type(select_norm("gln", 8)).__name__
    'GlobalLayerNorm'
    """
    if norm == "gln":
        return GlobalLayerNorm(dim, eps)
    if norm == "cln":
        return CumulativeLayerNorm(dim, eps)
    return torch.nn.LayerNorm(dim, eps=eps)


class PyTorchPositionalEncoding(torch.nn.Module):
    """The sinusoids of the PyTorch tutorial (sine on the even channels,
    cosine on the odd) for the input's T positions, added, then dropout.

    Example
    -------
    >>> PyTorchPositionalEncoding(16).eval()(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, d_model, dropout=0.1, max_len=5000):
        super().__init__()
        self.d_model = d_model
        self.drop = Dropout(dropout)

    def forward(self, x):
        T = x.shape[1]
        pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
        div = torch.exp(torch.arange(0, self.d_model, 2, dtype=torch.float32,
                                     device=x.device)
                        * (-math.log(10000.0) / self.d_model))
        pe = torch.zeros(T, self.d_model, device=x.device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return self.drop(x + pe[None].to(x.dtype))


class PytorchTransformerBlock(torch.nn.Module):
    """``PyTorchPositionalEncoding`` (``pos``, optional), then a post-norm
    ``TransformerEncoder`` (``encoder``: ReLU FFN, final LayerNorm), as a
    dual-path intra or inter block.

    Example
    -------
    >>> blk = PytorchTransformerBlock(16, num_layers=1, nhead=4, d_ffn=32)
    >>> blk.eval()(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, out_channels, num_layers=6, nhead=8, d_ffn=2048,
                 dropout=0.1, use_positional_encoding=True):
        super().__init__()
        self.pos = (PyTorchPositionalEncoding(out_channels, dropout)
                    if use_positional_encoding else None)
        self.encoder = TransformerEncoder(num_layers, nhead, d_ffn,
                                          out_channels, dropout=dropout,
                                          normalize_before=False)

    def forward(self, x):
        if self.pos is not None:
            x = self.pos(x)
        return self.encoder(x)[0]


class DPTNetBlock(torch.nn.Module):
    """The DPTNet layer: multi-head self-attention (``mha``), dropout,
    residual, LayerNorm (``norm1``); then a bidirectional ``GRU``
    (``rnn_ffn``) of ``dim_feedforward // 2`` units a direction, ReLU, a
    Linear back to ``d_model`` (``ffn_out``), dropout, residual, LayerNorm
    (``norm2``).

    Example
    -------
    >>> DPTNetBlock(16, 4)(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, d_model, nhead, dim_feedforward=256, dropout=0.0):
        super().__init__()
        self.mha = MultiheadAttention(nhead, d_model, dropout)
        self.norm1 = LayerNorm(d_model)
        self.rnn_ffn = GRU(d_model, dim_feedforward // 2, bidirectional=True)
        self.ffn_out = Linear(2 * (dim_feedforward // 2), d_model)
        self.norm2 = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = _ln(self.norm1, x + self.drop(self.mha(x, x, x)[0]))
        y = self.ffn_out(torch.relu(self.rnn_ffn(x)[0]))
        return _ln(self.norm2, x + self.drop(y))


class FastTransformerBlock:
    """Stands for the dual-path block over the ``fast_transformers``
    package (linear attention), which neither package depends on:
    building one raises ``ImportError``, as in JAX."""

    def __init__(self, *args, **kwargs):
        raise ImportError(
            "FastTransformerBlock needs the fast_transformers package; use "
            "SBTransformerBlock instead.")


class Dual_Computation_Block(torch.nn.Module):
    """One dual-path step on chunks (B, S, K, N): the intra-chunk
    ``SBTransformerBlock`` (``intra_mdl``) over K, an optional Linear
    (``intra_lin``, with ``linear_layer_after_inter_intra``), a
    LayerNorm (``intra_norm``, unless ``norm`` is None) and, with
    ``skip_around_intra``, the input added; then the inter-chunk block
    over S the same way (``inter_mdl``, ``inter_lin``, ``inter_norm``),
    plus the intra result.

    Example
    -------
    >>> blk = Dual_Computation_Block(16, nhead=4, d_ffn=32)
    >>> blk.eval()(torch.ones(2, 5, 10, 16)).shape
    torch.Size([2, 5, 10, 16])
    """

    def __init__(self, out_channels, nhead=8, d_ffn=1024, intra_numlayers=1,
                 inter_numlayers=1, norm="ln", skip_around_intra=True,
                 linear_layer_after_inter_intra=False):
        super().__init__()
        N = out_channels
        self.skip_around_intra = skip_around_intra
        self.intra_mdl = SBTransformerBlock(intra_numlayers, N, nhead, d_ffn)
        self.inter_mdl = SBTransformerBlock(inter_numlayers, N, nhead, d_ffn)
        lin = linear_layer_after_inter_intra
        self.intra_lin = Linear(N, N) if lin else None
        self.inter_lin = Linear(N, N) if lin else None
        self.intra_norm = LayerNorm(N) if norm is not None else None
        self.inter_norm = LayerNorm(N) if norm is not None else None

    def forward(self, x):
        B, S, K, N = x.shape
        intra = self.intra_mdl(x.reshape(B * S, K, N))
        if self.intra_lin is not None:
            intra = self.intra_lin(intra)
        intra = intra.reshape(B, S, K, N)
        if self.intra_norm is not None:
            intra = _ln(self.intra_norm, intra)
        if self.skip_around_intra:
            intra = intra + x
        inter = self.inter_mdl(intra.transpose(1, 2).reshape(B * K, S, N))
        if self.inter_lin is not None:
            inter = self.inter_lin(inter)
        inter = inter.reshape(B, K, S, N).transpose(1, 2)
        if self.inter_norm is not None:
            inter = _ln(self.inter_norm, inter)
        return inter + intra
