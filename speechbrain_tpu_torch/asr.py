"""Serving entry point: joint CTC/attention conformer ASR.

``ConformerASR`` chains Fbank -> global input normalization -> conv
front end -> ``TransformerASR`` (conformer encoder, transformer
decoder) -> CTC and seq2seq heads, and ``transcribe`` runs the joint
CTC/attention beam search with the KV-cached decoder, as the
LibriSpeech transformer recipe serves it.  Weights are random from a
seed, or loaded with ``load_state_dict`` from ``bridge.py``'s output;
nothing is downloaded.
"""

import math

import torch

from .decoders.seq2seq import S2STransformerBeamSearch
from .device import resolve_device
from .lobes.features import Fbank
from .lobes.models.convolution import ConvolutionFrontEnd
from .lobes.models.transformer.TransformerASR import TransformerASR
from .nnet.linear import Linear
from .processing.features import InputNormalization

__all__ = ["CONFORMER_SMALL", "ConformerASR"]

# recipes/LibriSpeech/ASR/transformer/hparams/conformer_small.yaml
CONFORMER_SMALL = {
    "sample_rate": 16000,
    "n_fft": 400,
    "n_mels": 80,
    "win_length": 25,
    "hop_length": 10,
    "frontend_blocks": 2,
    "frontend_channels": (64, 32),
    "frontend_kernel_sizes": ((3, 3), (3, 3)),
    "frontend_strides": (2, 2),
    "input_size": 640,  # 20 frequency bins x 32 channels after the front end
    "d_model": 144,
    "nhead": 4,
    "num_encoder_layers": 12,
    "num_decoder_layers": 4,
    "d_ffn": 1024,
    "kernel_size": 31,
    "vocab_size": 5000,
    "activation": "relu",
    "normalize_before": True,
    "bos_index": 1,
    "eos_index": 2,
    "blank_index": 0,
    "min_decode_ratio": 0.0,
    "max_decode_ratio": 1.0,
}


class ConformerASR(torch.nn.Module):
    """Conformer joint CTC/attention ASR built from a dict of dims.

    Arguments
    ---------
    config : dict with the keys of ``CONFORMER_SMALL``.
    device : None for the CUDA card (raises without one), or e.g. "cpu".
    dtype : activation/parameter dtype of the network (float32 or
        bfloat16); features, normalization, softmaxes and the search
        scores stay float32.
    seed : seed of the random initial weights.

    ``set_kernels(False)`` routes every kernel call to its plain PyTorch
    version (the CUDA kernels are used on the card by default).

    Example
    -------
    >>> cfg = dict(CONFORMER_SMALL, frontend_channels=(4, 4), input_size=40,
    ...     d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
    ...     d_ffn=32, kernel_size=5, vocab_size=12, n_mels=40)
    >>> asr = ConformerASR(cfg, device="cpu")
    >>> hyps, scores = asr.transcribe(torch.zeros(1, 4000), torch.ones(1),
    ...     beam_size=2)
    >>> len(hyps), scores.shape
    (1, (1,))
    """

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        c = dict(config)
        self.config = c
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fbank = Fbank(
            sample_rate=c["sample_rate"], n_fft=c["n_fft"],
            n_mels=c["n_mels"], win_length=c["win_length"],
            hop_length=c["hop_length"],
        )
        self.normalize = InputNormalization(c["n_mels"])
        self.frontend = ConvolutionFrontEnd(
            num_blocks=c["frontend_blocks"],
            out_channels=c["frontend_channels"],
            kernel_sizes=c["frontend_kernel_sizes"],
            strides=c["frontend_strides"],
        )
        self.transformer = TransformerASR(
            tgt_vocab=c["vocab_size"], input_size=c["input_size"],
            d_model=c["d_model"], nhead=c["nhead"],
            num_encoder_layers=c["num_encoder_layers"],
            num_decoder_layers=c["num_decoder_layers"], d_ffn=c["d_ffn"],
            activation=c["activation"],
            normalize_before=c["normalize_before"],
            kernel_size=c["kernel_size"],
        )
        self.ctc_lin = Linear(c["d_model"], c["vocab_size"])
        self.seq_lin = Linear(c["d_model"], c["vocab_size"])
        self._random_init(torch.Generator().manual_seed(seed))
        self.to(self.device)
        for m in (self.frontend, self.transformer, self.ctc_lin, self.seq_lin):
            m.to(dtype)
        self.eval()

    def _random_init(self, gen):
        """Lecun-normal weights (std 1/sqrt(fan_in)) from one generator;
        every bias zero, norms' scales one, ``pos_bias_u``/``v`` zero (as
        the JAX modules initialise them).  Nothing is left to the global
        RNG, so a seed gives the same weights in every process."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "depthwise_kernel":
                    fan_in = p.shape[0]
                elif leaf == "weight" and p.dim() >= 2:
                    fan_in = p[0].numel()
                else:
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                    continue
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))

    def set_kernels(self, flag=True):
        """Route kernel calls to the CUDA kernels (True) or to their
        plain PyTorch versions (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = bool(flag)
        return self

    @torch.no_grad()
    def encode(self, sig, sig_lens):
        """sig (B, samples) float32, sig_lens (B,) relative -> encoder
        states (B, T_enc, d_model), raw (as the CTC head sees them)."""
        sig = sig.to(self.device, torch.float32)
        sig_lens = sig_lens.to(self.device, torch.float32)
        feats = self.normalize(self.fbank(sig), sig_lens)
        src = self.frontend(feats.to(self.dtype))
        return self.transformer.encode(src, sig_lens)

    def make_searcher(self, beam_size=10, ctc_weight=0.4):
        """The joint CTC/attention beam searcher over this model, with
        the recipe's decode settings (partial CTC scoring, length
        normalization, no eos threshold)."""
        c = self.config
        return S2STransformerBeamSearch(
            step_fn=lambda tok, cache, pos, el, rows: (
                self.transformer.decode_step(tok, cache, pos, el, rows=rows)
            ),
            cache_init_fn=self.transformer.decode_cache_init,
            linear_fn=self.seq_lin,
            ctc_linear_fn=self.ctc_lin,
            bos_index=c["bos_index"],
            eos_index=c["eos_index"],
            blank_index=c["blank_index"],
            min_decode_ratio=c["min_decode_ratio"],
            max_decode_ratio=c["max_decode_ratio"],
            beam_size=beam_size,
            ctc_weight=ctc_weight,
        )

    @torch.no_grad()
    def transcribe(self, sig, sig_lens, beam_size=10, ctc_weight=0.4):
        """Returns ``(hyps, scores)``: per utterance the best token list
        (bos/eos stripped) and its length-normalized score (numpy)."""
        enc = self.encode(sig, sig_lens)
        searcher = self.make_searcher(beam_size, ctc_weight)
        return searcher(enc, sig_lens.to(self.device, torch.float32))
