"""Resource-efficient separation: SkiM and the RE-SepFormer.

Counterpart of ``speechbrain_tpu/lobes/models/resepformer.py``
(``RESepformer``, ``SBTransformerBlock_wnormandskip``, ``SegLSTM``,
``MemLSTM``, ``ResourceEfficientSeparationPipeline``,
``ResourceEfficientSeparator``, ``SkiMSeparator`` and its alias
``ResepformerWrapper``), channels-last as there.  The recurrences are the
port's ``LSTM`` (one-layer ``torch.nn.LSTM``s: cuDNN on the card); JAX
runs them as ``lax.scan``s, with no kernel of its own.

What the JAX package does and the port copies:

- ``ResepformerWrapper`` is ``SkiMSeparator``: ``resepformer.yaml``
  reaches the pipeline's "av" mode through it, whose segment and memory
  blocks are one pre-norm transformer layer each (8 heads, d_ffn 256:
  the pipeline's defaults), so the yaml's ``unit`` is never used;
- both yamls set ``causal: false``, so every SegLSTM and MemLSTM is
  bidirectional;
- ``seg_overlap`` is accepted and unused: the segments do not overlap;
- the "av" memory's mean over a segment counts the last segment's
  padding frames (which the blocks have made nonzero);
- the memory is shifted by one segment (segment s gets what the memory
  made of segments before it; the first gets zeros), except with
  ``mem_type`` "id", which passes the states on as they are.
"""

import torch
import torch.nn.functional as F

from ...nnet.dropout import Dropout
from ...nnet.linear import Linear
from ...nnet.RNN import LSTM
from .dual_path import Decoder, Encoder, SBTransformerBlock, decode_masked
from .transformer.Conformer import LayerNorm, _ln

__all__ = [
    "RESepformer",
    "SBTransformerBlock_wnormandskip",
    "SegLSTM",
    "MemLSTM",
    "ResourceEfficientSeparationPipeline",
    "ResourceEfficientSeparator",
    "SkiMSeparator",
    "ResepformerWrapper",
]

_MEM_TYPES = ("hc", "h", "c", "id", "av", None)


def _segments(x, K):
    """(B, T, D) zero-padded at the end to S whole segments of K frames ->
    (B, S, K, D)."""
    B, T, D = x.shape
    x = F.pad(x, (0, 0, 0, (K - T % K) % K))
    return x.reshape(B, -1, K, D)


class RESepformer(torch.nn.Module):
    """``Encoder`` -> chunks of ``chunk_size`` frames (zero-padded at the
    end) -> ``num_blocks`` x (a shared intra-chunk ``SBTransformerBlock``
    with a residual; each chunk's mean through a one-layer
    ``SBTransformerBlock`` across chunks, added to every frame of its
    chunk) -> ReLU of a 1x1 convolution to ``num_spks`` x N masks ->
    ``Decoder``.  (B, T) mixtures -> (B, T, num_spks) estimates.  No yaml
    builds it.

    Example
    -------
    >>> model = RESepformer(encoder_out_nchannels=16, chunk_size=10,
    ...     num_blocks=1, intra_numlayers=1, intra_nhead=4, intra_dffn=32,
    ...     encoder_kernel_size=8)
    >>> model(torch.ones(1, 400)).shape
    torch.Size([1, 400, 2])
    """

    def __init__(self, encoder_kernel_size=16, encoder_out_nchannels=256,
                 chunk_size=130, num_blocks=4, num_spks=2, intra_numlayers=2,
                 intra_nhead=8, intra_dffn=1024):
        super().__init__()
        N = encoder_out_nchannels
        self.chunk_size, self.num_spks = chunk_size, num_spks
        self.encoder = Encoder(encoder_kernel_size, N)
        self.intra = torch.nn.ModuleList(
            SBTransformerBlock(intra_numlayers, N, intra_nhead, intra_dffn)
            for _ in range(num_blocks))
        self.inter = torch.nn.ModuleList(
            SBTransformerBlock(1, N, intra_nhead, intra_dffn)
            for _ in range(num_blocks))
        self.mask_out = Linear(N, N * num_spks)
        self.decoder = Decoder(encoder_kernel_size, N)

    def forward(self, mix):
        w = self.encoder(mix)
        B, T, N = w.shape
        x = _segments(w, self.chunk_size)
        S, K = x.shape[1], x.shape[2]
        for intra, inter in zip(self.intra, self.inter):
            x = x + intra(x.reshape(B * S, K, N)).reshape(B, S, K, N)
            x = x + inter(x.mean(dim=2))[:, :, None]
        masks = torch.relu(self.mask_out(x.reshape(B, S * K, N)))[:, :T]
        masks = masks.reshape(B, T, self.num_spks, N).permute(2, 0, 1, 3)
        return decode_masked(self.decoder, w, masks, mix.shape[1])


class SBTransformerBlock_wnormandskip(torch.nn.Module):
    """An ``SBTransformerBlock``, then a LayerNorm (``use_norm``) and a
    residual from the block's input (``use_skip``).

    Example
    -------
    >>> blk = SBTransformerBlock_wnormandskip(1, 16, 4)
    >>> blk(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, num_layers, d_model, nhead, d_ffn=2048, dropout=0.0,
                 use_norm=True, use_skip=True):
        super().__init__()
        self.block = SBTransformerBlock(num_layers, d_model, nhead, d_ffn,
                                        dropout=dropout)
        self.norm = LayerNorm(d_model) if use_norm else None
        self.use_skip = use_skip

    def forward(self, x):
        y = self.block(x)
        if self.norm is not None:
            y = _ln(self.norm, y)
        return y + x if self.use_skip else y


class SegLSTM(torch.nn.Module):
    """SkiM's segment LSTM: a one-layer ``LSTM`` over each segment from
    the states ``hc`` (None: zeros), dropout, a ``Linear`` back to
    ``input_size``, a LayerNorm, and a residual.  ``forward(x, hc=None)``
    returns ``(y, (h, c))``, the states (D, N, H).

    Example
    -------
    >>> seg = SegLSTM(16, 8, bidirectional=True)
    >>> y, (h, c) = seg(torch.ones(3, 20, 16))
    >>> y.shape, h.shape
    (torch.Size([3, 20, 16]), torch.Size([2, 3, 8]))
    """

    def __init__(self, input_size, hidden_size, dropout=0.0,
                 bidirectional=False):
        super().__init__()
        d = 2 if bidirectional else 1
        self.lstm = LSTM(input_size, hidden_size, bidirectional=bidirectional)
        self.drop = Dropout(dropout)
        self.proj = Linear(d * hidden_size, input_size)
        self.norm = LayerNorm(input_size)

    def forward(self, x, hc=None):
        out, hc = self.lstm(x, hx=hc)
        return x + _ln(self.norm, self.proj(self.drop(out))), hc


class MemLSTM(torch.nn.Module):
    """SkiM's memory: the SegLSTMs' last states (h, c), each (D, B S, H),
    read as sequences over the S segments, (B, S, D H); per ``mem_type``
    ("hc", "h" or "c") h and/or c through a one-layer ``LSTM`` (``h_net``/
    ``c_net``), a ``Linear`` and a LayerNorm, added to themselves; then
    both shifted by one segment.  ``mem_type`` "id" returns ``hc``
    unchanged.  ``forward(hc, S)``.

    Example
    -------
    >>> mem = MemLSTM(16)
    >>> h, c = mem((torch.ones(1, 5, 16), torch.ones(1, 5, 16)), 5)
    >>> h.shape, bool(h[0, 0].any())
    (torch.Size([1, 5, 16]), False)
    """

    def __init__(self, hidden_size, dropout=0.0, bidirectional=False,
                 mem_type="hc"):
        super().__init__()
        if mem_type not in ("hc", "h", "c", "id"):
            raise ValueError(f"unsupported mem_type {mem_type}")
        self.mem_type = mem_type
        d = 2 if bidirectional else 1
        H = hidden_size
        for part in ("h", "c"):
            if part in mem_type:
                setattr(self, f"{part}_net", LSTM(
                    d * H, H, bidirectional=bidirectional))
                setattr(self, f"{part}_proj", Linear(d * H, d * H))
                setattr(self, f"{part}_norm", LayerNorm(d * H))

    def forward(self, hc, S):
        if self.mem_type == "id":
            return hc
        d, BS, H = hc[0].shape
        B = BS // S
        out = []
        for part, x in zip("hc", hc):
            if part in self.mem_type:
                seq = x.reshape(d, B, S, H).permute(1, 2, 0, 3).reshape(
                    B, S, d * H)
                y, _ = getattr(self, f"{part}_net")(seq)
                y = _ln(getattr(self, f"{part}_norm"),
                        getattr(self, f"{part}_proj")(y))
                x = x + y.reshape(B, S, d, H).permute(2, 0, 1, 3).reshape(
                    d, BS, H)
            xs = x.reshape(d, B, S, H)  # segment s gets segment s - 1's
            out.append(F.pad(xs[:, :, :-1], (0, 0, 1, 0)).reshape(d, BS, H))
        return tuple(out)


class ResourceEfficientSeparationPipeline(torch.nn.Module):
    """(B, T, input_size) -> segments of ``segment_size`` frames
    (zero-padded at the end) -> ``num_blocks`` segment blocks with a
    memory between consecutive ones -> leaky ReLU (0.01) ->
    ``output_fc`` to ``output_size`` -> (B, T, output_size).  With
    ``mem_type`` "hc", "h", "c" or "id" (SkiM) the blocks are
    ``SegLSTM``s, the (h, c) states carried from block to block through
    ``MemLSTM``s; with "av" or None (RE-SepFormer) they are one-layer
    ``SBTransformerBlock_wnormandskip``s over each segment, and the memory
    is such a block over the segments' means, added to every frame.

    Example
    -------
    >>> pipe = ResourceEfficientSeparationPipeline(16, 16, 32, num_blocks=2,
    ...     segment_size=10, nhead=4)
    >>> pipe(torch.ones(2, 100, 16)).shape
    torch.Size([2, 100, 32])
    """

    def __init__(self, input_size, hidden_size, output_size, dropout=0.0,
                 num_blocks=2, segment_size=20, bidirectional=True,
                 mem_type="av", nhead=8, d_ffn=256):
        super().__init__()
        if mem_type not in _MEM_TYPES:
            raise ValueError(f"unsupported mem_type {mem_type}")
        self.segment_size = segment_size
        self.skim = mem_type not in ("av", None)
        D = input_size
        if self.skim:
            self.seg = torch.nn.ModuleList(
                SegLSTM(D, hidden_size, dropout, bidirectional)
                for _ in range(num_blocks))
            self.mem = torch.nn.ModuleList(
                MemLSTM(hidden_size, dropout, bidirectional, mem_type)
                for _ in range(num_blocks - 1))
        else:
            self.seg = torch.nn.ModuleList(
                SBTransformerBlock_wnormandskip(1, D, nhead, d_ffn, dropout)
                for _ in range(num_blocks))
            self.mem = torch.nn.ModuleList(
                SBTransformerBlock_wnormandskip(1, D, nhead, d_ffn, dropout)
                for _ in range(num_blocks - 1))
        self.output_fc = Linear(D, output_size)

    def forward(self, x):
        B, T, D = x.shape
        xs = _segments(x, self.segment_size)
        S, K = xs.shape[1], xs.shape[2]
        if self.skim:
            y, hc = xs.reshape(B * S, K, D), None
            for i, seg in enumerate(self.seg):
                y, hc = seg(y, hc)
                if i < len(self.mem):
                    hc = self.mem[i](hc, S)
        else:
            y = xs
            for i, seg in enumerate(self.seg):
                y = seg(y.reshape(B * S, K, D)).reshape(B, S, K, D)
                if i < len(self.mem):
                    y = y + self.mem[i](y.mean(dim=2))[:, :, None]
        y = F.leaky_relu(y.reshape(B, S * K, D), 0.01)
        return self.output_fc(y)[:, :T]


class ResourceEfficientSeparator(torch.nn.Module):
    """``num_spk`` masks over (B, T, input_dim) encoder features: the
    pipeline (``unit`` hidden units, ``layer`` blocks, bidirectional
    unless ``causal``) to ``num_spk`` x ``input_dim``, ReLU; returns a
    list of ``num_spk`` (B, T, input_dim) masks.

    Example
    -------
    >>> sep = ResourceEfficientSeparator(16, unit=16, segment_size=10)
    >>> masks = sep(torch.ones(2, 100, 16))
    >>> len(masks), masks[0].shape
    (2, torch.Size([2, 100, 16]))
    """

    def __init__(self, input_dim, num_spk=2, causal=True, unit=512,
                 segment_size=20, layer=3, mem_type="hc", seg_overlap=False):
        super().__init__()
        self.num_spk = num_spk
        self.pipeline = ResourceEfficientSeparationPipeline(
            input_dim, unit, input_dim * num_spk, num_blocks=layer,
            segment_size=segment_size, bidirectional=not causal,
            mem_type=mem_type)

    def forward(self, x):
        B, T, D = x.shape
        masks = torch.relu(self.pipeline(x)).reshape(B, T, self.num_spk, D)
        return list(masks.unbind(2))


class SkiMSeparator(torch.nn.Module):
    """SkiM (``skim.yaml``) and, as ``ResepformerWrapper`` with ``mem_type``
    "av", the RE-SepFormer (``resepformer.yaml``): ``Encoder`` ->
    ``ResourceEfficientSeparator`` masks -> each source's masked latent
    through the shared ``Decoder``, cut or zero-padded to the mixture's
    length.  (B, T) mixtures -> (B, T, num_spks) estimates.

    Example
    -------
    >>> model = SkiMSeparator(encoder_out_nchannels=16, unit=16,
    ...     segment_size=10, num_blocks=1, encoder_kernel_size=8)
    >>> model(torch.ones(1, 400)).shape
    torch.Size([1, 400, 2])
    """

    def __init__(self, encoder_kernel_size=16, encoder_out_nchannels=128,
                 num_spks=2, causal=True, unit=128, segment_size=150,
                 num_blocks=4, mem_type="hc", seg_overlap=False):
        super().__init__()
        N = encoder_out_nchannels
        self.encoder = Encoder(encoder_kernel_size, N)
        self.masknet = ResourceEfficientSeparator(
            N, num_spk=num_spks, causal=causal, unit=unit,
            segment_size=segment_size, layer=num_blocks, mem_type=mem_type,
            seg_overlap=seg_overlap)
        self.decoder = Decoder(encoder_kernel_size, N)

    def forward(self, mix):
        w = self.encoder(mix)
        masks = torch.stack(self.masknet(w))  # (spks, B, T', N)
        return decode_masked(self.decoder, w, masks, mix.shape[1])


ResepformerWrapper = SkiMSeparator
