"""Entry points of the conformer ASR models: the joint CTC/attention
model (serving and the training step) and the conformer-transducer
(the training step).

``ConformerASR`` chains Fbank -> global input normalization -> conv
front end -> ``TransformerASR`` (conformer encoder, transformer
decoder) -> CTC and seq2seq heads, and ``transcribe`` runs the joint
CTC/attention beam search with the KV-cached decoder, as the
LibriSpeech transformer recipe serves it: full-vocabulary CTC scoring,
and with a ``TransformerLM`` (``build_transformer_lm``, the recipe's
``TRANSFORMER_LM`` dims) fused at ``lm_weight`` 0.6.
``ConformerASRBrain`` trains the same modules with the recipe's step
(``recipes/LibriSpeech/ASR/transformer/train.py``: SpecAugment in
training, and the beam search's error rate in validation and test).
Weights are random from a seed, or loaded with ``load_state_dict`` from
``bridge.py``'s output; nothing is downloaded.

``ConformerTransducer`` chains the same features, front end and
conformer encoder (no decoder) with ``enc_lin``, the prediction network
(``emb`` -> one-layer ``GRU`` -> ``dec_lin``), the sum joiner with tanh
and ``out_lin``, and ``transcribe`` decodes it as the transducer recipe's
test stage does (``recipes/LibriSpeech/ASR/transducer/train.py:103-145``:
``decoders.transducer.TransducerBeamSearcher`` at beam 4, state_beam and
expand_beam 2.3; also greedy and the fixed-shape device beam);
``ConformerTransducerBrain`` trains it with the recipe's step
(``train.py:27-100``, SpecAugment included) on the RNN-T loss, whose
lattice runs in the kernels K8/K9 on the card, and scores the test
search's error rate.  With a tokenizer (``tokenizers.SentencePiece``)
the error rates are over the words it decodes, as the recipes score
them; without one, over token ids.  ``recipes/librispeech_asr.py`` runs
the conformer recipe end to end (data, tokenizer, ``Brain.fit`` with
checkpoints, ``evaluate``).

``CRDNNTransducer`` and ``CRDNNTransducerBrain`` are the same transducer
with the transducer recipe's other encoder (``hparams/train.yaml``: a
``CRDNN`` with a bidirectional LiGRU, ``CRDNN_TRANSDUCER``); as in the
recipe (``train.py:42-52``) the encoder is the one difference, so both
models share ``_Transducer`` and both Brains ``_TransducerBrain``.
``recipes/librispeech_transducer.py`` runs that recipe end to end with
either hparams file.

The wav2vec 2.0 yamls swap the features and front end for the native
wav2vec stack (``W2V_BASE``: ``W2VLatentExtractor`` -> ``EncoderWrapper``,
``wav2vec_encoder``): ``ConformerASR`` with ``front_end`` "wav2vec" feeds
the extractor's latents to ``TransformerASR`` (AISHELL-1's
``train_with_wav2vect.py``), and ``W2VTransducer`` is the transducer
over the wav2vec encoder (TIMIT's ``transducer/train_wav2vec.py``).
"""

import math
import re

import torch

from .core import Brain, Stage
from .decoders.seq2seq import S2STransformerBeamSearch
from .decoders.transducer import TransducerBeamSearcher
from .device import resolve_device
from .lobes.augment import SpecAugment
from .lobes.features import Fbank
from .lobes.models.convolution import ConvolutionFrontEnd
from .lobes.models.CRDNN import CRDNN
from .lobes.models.transformer.TransformerASR import TransformerASR
from .lobes.models.transformer.TransformerLM import TransformerLM
from .lobes.models.wav2vec import EncoderWrapper, W2VLatentExtractor
from .nnet.embedding import Embedding
from .nnet.linear import Linear
from .nnet.losses import ctc_loss, kldiv_loss, transducer_loss
from .nnet.normalization import LayerNorm
from .nnet.RNN import GRU
from .nnet.schedulers import NoamScheduler
from .nnet.transducer.transducer_joint import Transducer_joint
from .processing.features import InputNormalization
from .utils.data_utils import undo_padding
from .utils.metric_stats import ErrorRateStats

__all__ = ["CONFORMER_SMALL", "ConformerASR", "ConformerASRBrain",
           "TRANSFORMER_LM", "build_transformer_lm",
           "CONFORMER_TRANSDUCER", "ConformerTransducer",
           "ConformerTransducerBrain", "CRDNN_TRANSDUCER", "CRDNNTransducer",
           "CRDNNTransducerBrain", "W2V_BASE", "wav2vec_encoder",
           "W2VTransducer", "at_least_f32"]

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
    "encoder_module": "conformer",
    "attention_type": "RelPosMHAXL",
    "bos_index": 1,
    "eos_index": 2,
    "blank_index": 0,
    "min_decode_ratio": 0.0,
    "max_decode_ratio": 1.0,
    # training (conformer_small.yaml)
    "transformer_dropout": 0.1,
    "update_until_epoch": 4,
    "ctc_weight": 0.3,
    "label_smoothing": 0.1,
    "lr_adam": 8e-4,
    "n_warmup_steps": 25000,
    "max_grad_norm": 5.0,
    # conformer_small.yaml:83-92 (SpecAugment's arguments; None: off)
    "augmentation": {
        "time_warp": True, "time_warp_window": 5, "freq_mask": True,
        "n_freq_mask": 2, "time_mask": True, "n_time_mask": 4,
        "replace_with_zero": False, "freq_mask_width": (0, 30),
        "time_mask_width": (0, 40),
    },
    # the validation and test search (conformer_small.yaml:59, :66)
    "valid_beam_size": 10,
    "ctc_weight_decode": 0.4,
}

# recipes/LibriSpeech/ASR/transformer/hparams/conformer_small.yaml:121-126
# (lm_model; the other arguments are the JAX TransformerLM's defaults)
TRANSFORMER_LM = {
    "vocab": 5000,
    "d_model": 768,
    "nhead": 12,
    "num_encoder_layers": 12,
    "d_ffn": 3072,
    "activation": "gelu",
    "normalize_before": False,
}

# recipes/LibriSpeech/ASR/transducer/hparams/conformer_transducer.yaml
CONFORMER_TRANSDUCER = {
    "sample_rate": 16000,
    "n_fft": 400,
    "n_mels": 80,
    "win_length": 25,
    "hop_length": 10,
    "frontend_blocks": 2,
    "frontend_channels": (64, 32),
    "frontend_kernel_sizes": ((3, 3), (3, 3)),
    "frontend_strides": (2, 2),
    "input_size": 640,
    "d_model": 144,
    "nhead": 4,
    "num_encoder_layers": 12,
    "num_decoder_layers": 0,  # encoder only: the transducer has its own
    "d_ffn": 1024,
    "kernel_size": 31,
    "vocab_size": 1000,
    "activation": "relu",
    "normalize_before": False,
    "blank_index": 0,
    "dec_emb_dim": 128,
    "dec_neurons": 256,
    "joint_dim": 320,
    # training
    "transformer_dropout": 0.1,
    "update_until_epoch": 4,
    "lr_adam": 8e-4,
    "n_warmup_steps": 25000,
    "max_grad_norm": 5.0,
    # conformer_transducer.yaml:63-68 (SpecAugment's arguments; None: off)
    "augmentation": {
        "time_warp": False, "n_freq_mask": 2, "n_time_mask": 4,
        "freq_mask_width": (0, 27), "time_mask_width": (0, 40),
    },
    # the test search (conformer_transducer.yaml:47-49)
    "beam_size": 4,
    "state_beam": 2.3,
    "expand_beam": 2.3,
}

# recipes/LibriSpeech/ASR/transducer/hparams/train.yaml (the CRDNN encoder
# with rnn_class ligru; the transducer head and training values as above)
CRDNN_TRANSDUCER = {
    "sample_rate": 16000,
    "n_fft": 400,
    "n_mels": 80,
    "win_length": 25,
    "hop_length": 10,
    "cnn_blocks": 2,
    "cnn_channels": (64, 128),
    "inter_layer_pooling_size": (2, 2),
    "rnn_layers": 4,
    "rnn_neurons": 512,
    "rnn_bidirectional": True,
    "dnn_blocks": 2,
    "dnn_neurons": 512,
    "dropout": 0.15,
    "vocab_size": 1000,
    "blank_index": 0,
    "dec_emb_dim": 128,
    "dec_neurons": 256,
    "joint_dim": 320,
    # training
    "update_until_epoch": 4,
    "lr_adam": 8e-4,
    "n_warmup_steps": 25000,
    "max_grad_norm": 5.0,
    # train.yaml:65-70 (SpecAugment's arguments; None: off)
    "augmentation": {
        "time_warp": False, "n_freq_mask": 2, "n_time_mask": 4,
        "freq_mask_width": (0, 27), "time_mask_width": (0, 40),
    },
    # the test search (train.yaml:49-51)
    "beam_size": 4,
    "state_beam": 2.3,
    "expand_beam": 2.3,
}


# the wav2vec 2.0 base encoder the fine-tuning yamls build: seven
# convolutions of 512 (W2VLatentExtractor's default kernels and strides)
# and 12 pre-norm layers at d 768 (EncoderWrapper's dropout 0.1)
W2V_BASE = {
    "latent_channels": (512,) * 7,
    "kernel_sizes": (11, 3, 3, 3, 3, 3, 3),
    "strides": (5, 2, 2, 2, 2, 2, 2),
    "embedding_dim": 768,
    "encoder_layers": 12,
    "nhead": 8,
    "d_ffn": 3072,
    "encoder_dropout": 0.1,
}


def wav2vec_encoder(c):
    """The ``extractor`` (``W2VLatentExtractor``) and ``encoder``
    (``EncoderWrapper`` without ``mask_emb``) of a dict with
    ``W2V_BASE``'s keys."""
    extractor = W2VLatentExtractor(c["latent_channels"], c["kernel_sizes"],
                                   c["strides"])
    return {"extractor": extractor,
            "encoder": EncoderWrapper(
                extractor.output_size, c["embedding_dim"],
                c["encoder_layers"], c["nhead"], c["d_ffn"],
                c["encoder_dropout"])}


def _feature_width(c):
    """The features' width: ``n_mels``, three times that with ``deltas``."""
    return c["n_mels"] * (3 if c.get("deltas", False) else 1)


def _features(c):
    """Fbank (with the deltas and their deltas when ``c["deltas"]``) and
    the global input normalization of a config dict."""
    fbank = Fbank(sample_rate=c["sample_rate"], n_fft=c["n_fft"],
                  n_mels=c["n_mels"], win_length=c["win_length"],
                  hop_length=c["hop_length"], deltas=c.get("deltas", False))
    normalize = InputNormalization(
        _feature_width(c), update_until_epoch=c.get("update_until_epoch", 3))
    return fbank, normalize


def _conv_front_end(c):
    """The conv front end of a config dict."""
    return ConvolutionFrontEnd(
        num_blocks=c["frontend_blocks"], out_channels=c["frontend_channels"],
        kernel_sizes=c["frontend_kernel_sizes"],
        strides=c["frontend_strides"])


def _transformer(c):
    return TransformerASR(
        tgt_vocab=c["vocab_size"], input_size=c["input_size"],
        d_model=c["d_model"], nhead=c["nhead"],
        num_encoder_layers=c["num_encoder_layers"],
        num_decoder_layers=c["num_decoder_layers"], d_ffn=c["d_ffn"],
        activation=c["activation"], normalize_before=c["normalize_before"],
        kernel_size=c["kernel_size"],
        dropout=c.get("transformer_dropout", 0.0),
        encoder_module=c.get("encoder_module", "conformer"),
        attention_type=c.get("attention_type", "RelPosMHAXL"),
    )


# the recurrent weights: the LiGRU's, and torch.nn.GRU/LSTM/RNN's per layer
# and direction
_RECURRENT = re.compile(r"weight_hh(_l\d+(_reverse)?)?")


def _random_init(module, gen):
    """Lecun-normal weights (std 1/sqrt(fan_in); the depthwise taps, a
    cosine classifier's centroids and the ``weight`` of a module that sets
    ``weight_in_out``, such as the ECAPA head's, are (in, out)) from one
    generator, but
    orthogonal recurrent weights, as the JAX modules initialise every
    ``u``: the LiGRU's ``weight_hh`` and each ``weight_hh_l{k}`` and
    ``weight_hh_l{k}_reverse`` of a ``torch.nn.GRU``/``LSTM``/``RNN``,
    and the ``weight`` of a module that sets ``recurrent`` (the cells'
    ``u`` Linears) (JAX's ``u`` is (H, G H) with orthonormal rows,
    torch's ``weight_hh`` its transpose, whose orthonormal columns are the
    same distribution; a Gaussian (2H, H) matrix's largest singular values
    exceed 1 and the LiGRU's relu recurrence can blow up over hundreds of
    frames at narrow widths); every bias zero (the recurrent ones too, as in
    JAX), norms' scales one (the CRDNN's LayerNorms have (F, C) scales),
    ``pos_bias_u``/``v`` zero (as the JAX modules initialise them). Nothing
    is left to the global RNG, so a seed gives the same weights in every
    process."""
    norms = {id(p) for m in module.modules() if isinstance(m, LayerNorm)
             for p in m.parameters()}
    in_out = {id(m.weight) for m in module.modules()
              if getattr(m, "weight_in_out", False)}
    recurrent = {id(m.weight) for m in module.modules()
                 if getattr(m, "recurrent", False)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if id(p) in norms:
                p.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            if _RECURRENT.fullmatch(leaf) or id(p) in recurrent:
                torch.nn.init.orthogonal_(p, generator=gen)
                continue
            if leaf in ("depthwise_kernel", "centroids") or id(p) in in_out:
                fan_in = p.shape[0]
            elif leaf.startswith("weight") and p.dim() >= 2:
                fan_in = p[0].numel()
            else:
                p.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))


def build_transformer_lm(config=TRANSFORMER_LM, device=None, seed=0):
    """A ``TransformerLM`` of ``config``'s dims in eval mode on ``device``
    (None: the CUDA card) with random weights from ``seed``, for
    ``ConformerASR.transcribe(lm=...)``.

    Example
    -------
    >>> lm = build_transformer_lm(dict(TRANSFORMER_LM, vocab=12, d_model=16,
    ...     nhead=2, num_encoder_layers=1, d_ffn=32), device="cpu")
    >>> lm(torch.zeros(1, 3, dtype=torch.long)).shape
    torch.Size([1, 3, 12])
    """
    lm = TransformerLM(**config)
    _random_init(lm, torch.Generator().manual_seed(seed))
    return lm.to(resolve_device(device)).eval()


def at_least_f32(x):
    """bfloat16 -> float32; float32 and float64 as they are (the dtype of
    the log-softmax and the losses)."""
    return x if x.dtype == torch.float64 else x.float()


def _set_kernels(module, flag):
    for m in module.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = bool(flag)


class ConformerASR(torch.nn.Module):
    """Conformer joint CTC/attention ASR built from a dict of dims.

    Arguments
    ---------
    config : dict with the keys of ``CONFORMER_SMALL`` (the training
        keys are optional; ``transformer_dropout`` only acts in training
        mode).
    device : None for the CUDA card (raises without one), or e.g. "cpu".
    dtype : activation dtype of the network (float32 or bfloat16); the
        parameters stay float32 and each module casts them to the
        activation dtype per op, as the JAX modules do.  Features,
        normalization, softmaxes and the search scores stay float32.
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
        if c.get("front_end") == "wav2vec":
            self.extractor = W2VLatentExtractor(
                c["latent_channels"], c["kernel_sizes"], c["strides"])
        else:
            self.fbank, self.normalize = _features(c)
            self.frontend = _conv_front_end(c)
        self.transformer = _transformer(c)
        self.ctc_lin = Linear(c["d_model"], c["vocab_size"])
        self.seq_lin = Linear(c["d_model"], c["vocab_size"])
        _random_init(self, torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.eval()

    def set_kernels(self, flag=True):
        """Route kernel calls to the CUDA kernels (True) or to their
        plain PyTorch versions (False)."""
        _set_kernels(self, flag)
        return self

    @torch.no_grad()
    def encode(self, sig, sig_lens):
        """sig (B, samples) float32, sig_lens (B,) relative -> encoder
        states (B, T_enc, d_model), raw (as the CTC head sees them)."""
        sig = sig.to(self.device, torch.float32)
        sig_lens = sig_lens.to(self.device, torch.float32)
        return self.transformer.encode(self.source(sig, sig_lens), sig_lens)

    def source(self, sig, sig_lens, epoch=0, augment=None):
        """The transformer's input in ``self.dtype``: Fbank -> the
        normalization (``epoch``: the epoch it sees) -> ``augment`` (the
        features -> the features, or None) -> the front end; or, with
        ``front_end`` "wav2vec", the extractor's float32 latents cast
        after it (``train_with_wav2vect.py:35-38``)."""
        if hasattr(self, "extractor"):
            return self.extractor(sig).to(self.dtype)
        feats = self.normalize(self.fbank(sig), sig_lens, epoch=epoch)
        if augment is not None:
            feats = augment(feats)
        return self.frontend(feats.to(self.dtype))

    def make_searcher(self, beam_size=10, ctc_weight=0.4, lm=None,
                      lm_weight=None, ctc_score_mode="full",
                      using_eos_threshold=False, length_normalization=True,
                      **options):
        """The joint CTC/attention beam searcher over this model, with
        the recipe's decode settings by default: full-vocabulary CTC
        scoring, no eos threshold, length normalization, and with ``lm``
        (a ``TransformerLM``, run in this model's dtype) shallow fusion at
        ``lm_weight`` 0.6.  ``options`` go to ``S2STransformerBeamSearch``
        (``topk``, ``eos_threshold``, ``length_rewarding``,
        ``temperature``, ``temperature_lm``)."""
        c = self.config
        if lm_weight is None:
            lm_weight = 0.6 if lm is not None else 0.0
        if lm_weight > 0 and lm is None:
            raise ValueError("lm_weight > 0 needs an lm")
        return S2STransformerBeamSearch(
            step_fn=lambda tok, cache, pos, el, rows: (
                self.transformer.decode_step(tok, cache, pos, el, rows=rows)
            ),
            cache_init_fn=self.transformer.decode_cache_init,
            linear_fn=self.seq_lin,
            ctc_linear_fn=self.ctc_lin,
            lm_fn=None if lm is None else (
                lambda prefix: lm(prefix, dtype=self.dtype)),
            bos_index=c["bos_index"],
            eos_index=c["eos_index"],
            blank_index=c["blank_index"],
            min_decode_ratio=c["min_decode_ratio"],
            max_decode_ratio=c["max_decode_ratio"],
            beam_size=beam_size,
            ctc_weight=ctc_weight,
            lm_weight=lm_weight,
            ctc_score_mode=ctc_score_mode,
            using_eos_threshold=using_eos_threshold,
            length_normalization=length_normalization,
            **options,
        )

    @torch.no_grad()
    def transcribe(self, sig, sig_lens, beam_size=10, ctc_weight=0.4,
                   **search_options):
        """Returns ``(hyps, scores)``: per utterance the best token list
        (bos/eos stripped) and its score (numpy; with ``topk`` > 1 also
        the top hypotheses, as ``S2SBeamSearcher.finalize`` returns them).
        ``search_options`` are ``make_searcher``'s (``lm``,
        ``lm_weight``, ``ctc_score_mode``, ...)."""
        enc = self.encode(sig, sig_lens)
        searcher = self.make_searcher(beam_size, ctc_weight, **search_options)
        return searcher(enc, sig_lens.to(self.device, torch.float32))


class _ModelBrain(Brain):
    """A ``Brain`` over the modules of one model (``self.model``, built
    from ``DEFAULTS`` updated with ``config``), with the recipes' AdamW
    and the Noam schedule stepped after each optimizer step.  The first
    step runs at ``hparams["lr"]`` (1e-3 when not given), as in the JAX
    ``Brain``.  ``config["augmentation"]`` holds SpecAugment's arguments
    (None: no augmentation); it acts on the normalized features in
    ``Stage.TRAIN`` only, with draws from ``self.generator``.  With a
    ``checkpointer``, the Noam schedule is registered with it as
    ``"noam_annealing"`` (as the recipes register it).  ``tokenizer``
    (optional) decodes the hypotheses and references to words for the
    error rate."""

    MODEL, DEFAULTS, MODULES = None, None, ()

    def __init__(self, config, opt_class=None, device=None, seed=0,
                 run_opts=None, hparams=None, checkpointer=None,
                 tokenizer=None):
        c = dict(self.DEFAULTS, **config)
        run_opts = dict(run_opts or {})
        run_opts.setdefault("device", device)
        run_opts.setdefault("seed", seed)
        run_opts.setdefault("max_grad_norm", c["max_grad_norm"])
        self.model = self.MODEL(c, device=resolve_device(run_opts["device"]),
                                seed=seed)
        if opt_class is None:
            def opt_class(params):
                return torch.optim.AdamW(params, betas=(0.9, 0.98), eps=1e-9,
                                         weight_decay=1e-4)
        super().__init__(
            modules={name: getattr(self.model, name) for name in self.MODULES},
            opt_class=opt_class, hparams=hparams, run_opts=run_opts,
            checkpointer=checkpointer,
        )
        self.config = c
        self.tokenizer = tokenizer
        self.model.dtype = self.dtype
        aug = c.get("augmentation")
        self.augment = None if aug is None else SpecAugment(**aug)
        self._init_schedule(c, checkpointer)
        self.epoch = 0
        self.stage_stats = {}
        self.use_kernels = True

    def _init_schedule(self, c, checkpointer):
        """The Noam schedule (``lr_adam``, ``n_warmup_steps``), stepped
        after each optimizer step, registered as ``"noam_annealing"``."""
        self.noam = NoamScheduler(c["lr_adam"], c["n_warmup_steps"])
        if (checkpointer is not None
                and "noam_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("noam_annealing", self.noam)

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        if should_step:
            _, self.lr = self.noam()

    def set_kernels(self, flag=True):
        """Route kernel calls (the modules' and the loss's) to the CUDA
        kernels or to the plain versions."""
        self.model.set_kernels(flag)
        self.use_kernels = bool(flag)
        return self

    def _augment(self, stage):
        """The features' transform in ``stage``: SpecAugment with the
        brain's generator in training, else None."""
        if stage != Stage.TRAIN or self.augment is None:
            return None
        return lambda feats: self.augment(feats, self.generator)

    def _score_hyps(self, hyps, batch):
        """Append the real rows' hypotheses and references to
        ``self.wer_metric``: as words decoded by ``self.tokenizer``
        (``recipes/LibriSpeech/ASR/transformer/train.py:91-104``), or as
        token ids without one."""
        real = int(batch["batch_mask"].sum())
        tokens = batch["tokens"][:real].cpu().numpy()
        lens = batch["tokens_lens"][:real].cpu().numpy()
        ids = [str(i) for i in range(real)]
        if self.tokenizer is None:
            self.wer_metric.append(ids, hyps[:real], undo_padding(tokens, lens))
            return
        predicted = [self.tokenizer([h], task="decode_from_list")[0]
                     for h in hyps[:real]]
        targets = self.tokenizer(tokens.tolist(), lens, task="decode")
        self._score_words(ids, predicted, targets)

    def _score_words(self, ids, predicted, targets):
        """Append the decoded words to the metrics (the WER here; a
        recipe's Brain also normalizes them or scores their characters)."""
        self.wer_metric.append(ids, predicted, targets)


class ConformerASRBrain(_ModelBrain):
    """The LibriSpeech conformer recipe's training step on the modules of
    ``ConformerASR``.

    ``compute_forward``: Fbank -> ``InputNormalization`` (its statistics
    updated in training, frozen after ``update_until_epoch``) ->
    SpecAugment (training only) -> cast to the activation dtype -> front
    end (BatchNorm statistics updated in training) ->
    ``TransformerASR.forward`` -> ``ctc_lin`` and
    ``seq_lin``, each with a float32 ``log_softmax``.
    ``compute_objectives``: ``ctc_weight`` x CTC (``batchmean``) +
    (1 - ``ctc_weight``) x label-smoothed KL (``batchmean``).  After each
    optimizer step the Noam schedule (``lr_adam``, ``n_warmup_steps``)
    sets the learning rate, as the recipe's ``on_fit_batch_end`` does;
    the first step runs at ``hparams["lr"]`` (1e-3 when not given), as in
    the JAX ``Brain``.

    ``self.model`` is the ``ConformerASR`` that owns the modules, so
    ``self.modules.state_dict()`` loads into a ``ConformerASR`` for
    serving.  After ``on_stage_start(Stage.VALID)`` or ``(Stage.TEST)``,
    ``evaluate_batch`` also runs the recipe's search (``transcribe`` at
    ``valid_beam_size``, CTC weight ``ctc_weight_decode``) and appends
    its hypotheses to ``self.wer_metric``, an ``ErrorRateStats`` over
    words (with a tokenizer) or token ids.  A batch is a dict (or a
    ``PaddedBatch``) of ``sig`` (B, samples) and ``sig_lens`` (B,)
    relative, ``tokens`` (B, U), ``tokens_bos``/``tokens_eos`` (B, U+1),
    the relative ``tokens_lens``/``tokens_eos_lens`` and, where it has
    dummy rows, ``batch_mask``.  ``epoch`` is the epoch the
    normalization sees: the epoch counter's, which ``fit`` passes to
    ``on_stage_start`` (0 before any).

    With ``lm`` (a ``TransformerLM``) the search fuses it at
    ``config["lm_weight"]`` (0.6 when not given), as the recipe does once
    trained LM parameters are attached (``train.py:108-116``).

    ``on_stage_end`` does what the recipe's does (``train.py:204-223``):
    at VALID it writes the logger's line (``hparams["train_logger"]``,
    a ``FileTrainLogger``, when given) and, with a checkpointer, saves
    one with ``meta={"WER": wer}`` and keeps the best by WER; at TEST it
    writes the test line with the epoch loaded
    (``hparams["epoch_counter"]``) and, when ``hparams["wer_file"]`` is
    set, the details (``write_stats``).  The last stats of each stage are
    in ``self.stage_stats``.  The recipes' Brains change the scoring
    through ``score_batch`` (the search), ``_score_words`` (the decoded
    words' metrics), ``stage_metrics`` (the first one keeps the best
    checkpoint) and ``write_stats``.

    Arguments
    ---------
    config : dict with the keys of ``CONFORMER_SMALL``.
    opt_class : callable(params) -> optimizer; default AdamW(b1 0.9,
        b2 0.98, eps 1e-9, weight decay 1e-4), the recipe's optax adamw.
    device, seed : as for ``ConformerASR``; ``seed`` also seeds dropout.
    run_opts, hparams : as for ``Brain`` (``precision`` "bf16" is the
        recipe's).
    lm : a ``TransformerLM`` to fuse into the search, or None.

    Example
    -------
    >>> import numpy as np
    >>> cfg = dict(CONFORMER_SMALL, frontend_channels=(4, 4), input_size=40,
    ...     d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
    ...     d_ffn=32, kernel_size=5, vocab_size=12, n_mels=40)
    >>> brain = ConformerASRBrain(cfg, device="cpu")
    >>> tok = np.array([[3, 4, 5]])
    >>> batch = {"sig": np.zeros((1, 4000), np.float32),
    ...     "sig_lens": np.ones(1, np.float32), "tokens": tok,
    ...     "tokens_bos": np.array([[1, 3, 4, 5]]),
    ...     "tokens_eos": np.array([[3, 4, 5, 2]]),
    ...     "tokens_lens": np.ones(1, np.float32),
    ...     "tokens_eos_lens": np.ones(1, np.float32)}
    >>> brain.step += 1
    >>> bool(torch.isfinite(brain.fit_batch(batch)))
    True
    """

    MODEL, DEFAULTS = ConformerASR, CONFORMER_SMALL

    @property
    def MODULES(self):
        front = (("extractor",) if hasattr(self.model, "extractor")
                 else ("normalize", "frontend"))
        return (*front, "transformer", "ctc_lin", "seq_lin")

    def __init__(self, config, *args, lm=None, **kwargs):
        super().__init__(config, *args, **kwargs)
        self.lm = None if lm is None else lm.to(self.device).eval()

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch; a new ``ErrorRateStats`` for the
        validation and test stages."""
        if epoch is not None:
            self.epoch = epoch
        if stage != Stage.TRAIN:
            self.wer_metric = ErrorRateStats()

    def stage_metrics(self):
        """The stage's error rates by name; the first is the one the
        checkpoints keep the best of (here the WER)."""
        return {"WER": self.wer_metric.summarize("error_rate")}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The recipe's logging and keep-best checkpoint (see above)."""
        if stage == Stage.TRAIN:
            return
        metrics = self.stage_metrics()
        key = next(iter(metrics))
        stats = {"loss": stage_loss, **metrics}
        self.stage_stats[stage.name] = stats
        train_logger = getattr(self.hparams, "train_logger", None)
        if stage == Stage.VALID:
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats=stats,
                )
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(
                    meta={key: metrics[key]}, min_keys=[key])
            return
        if train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats,
            )
        wer_file = getattr(self.hparams, "wer_file", None)
        if wer_file:
            with open(wer_file, "w") as w:
                self.write_stats(w)

    def write_stats(self, stream):
        """The TEST stage's per-utterance details, written to
        ``hparams["wer_file"]`` when one is given."""
        self.wer_metric.write_stats(stream)

    def compute_forward(self, batch, stage):
        """Returns the CTC and seq2seq log-probabilities, float32."""
        m = self.modules
        src = self.model.source(batch["sig"], batch["sig_lens"], self.epoch,
                                self._augment(stage))
        enc, dec = m.transformer(src, batch["tokens_bos"],
                                 wav_len=batch["sig_lens"],
                                 pad_idx=self.config["blank_index"])
        ctc_logp = torch.log_softmax(at_least_f32(m.ctc_lin(enc)), -1)
        seq_logp = torch.log_softmax(at_least_f32(m.seq_lin(dec)), -1)
        return ctc_logp, seq_logp

    def compute_objectives(self, predictions, batch, stage):
        """0.3 CTC + 0.7 label-smoothed KL, both ``batchmean``."""
        ctc_logp, seq_logp = predictions
        mask = batch["batch_mask"]
        c = self.config
        loss_ctc = ctc_loss(
            ctc_logp, batch["tokens"], batch["sig_lens"] * mask,
            batch["tokens_lens"] * mask, blank_index=c["blank_index"],
            reduction="batchmean", use_kernels=self.use_kernels,
        )
        loss_seq = kldiv_loss(
            seq_logp, batch["tokens_eos"],
            length=batch["tokens_eos_lens"] * mask,
            label_smoothing=c["label_smoothing"], reduction="batchmean",
        )
        if stage != Stage.TRAIN and hasattr(self, "wer_metric"):
            self.score_batch(predictions, batch)
        return c["ctc_weight"] * loss_ctc + (1 - c["ctc_weight"]) * loss_seq

    def score_batch(self, predictions, batch):
        """Outside training: the recipe's search on the batch's real rows,
        its hypotheses scored by ``_score_hyps``."""
        c = self.config
        hyps, _ = self.model.transcribe(
            batch["sig"], batch["sig_lens"], beam_size=c["valid_beam_size"],
            ctc_weight=c["ctc_weight_decode"], lm=self.lm,
            lm_weight=None if self.lm is None else c.get("lm_weight"))
        self._score_hyps(hyps, batch)


class _Transducer(torch.nn.Module):
    """The transducer of ``recipes/LibriSpeech/ASR/transducer/train.py``
    around an encoder that a subclass builds (``_build_encoder``, which
    returns the encoder's output width) and runs (``_encode``): Fbank ->
    global input normalization -> the encoder -> ``enc_lin``; the
    prediction network (``emb`` -> one-layer ``GRU`` -> ``dec_lin``); the
    sum joiner with tanh and ``out_lin``.

    ``forward(sig, sig_lens, tokens_blank, dtype, epoch)`` runs the
    recipe's ``compute_forward``: the features and the encoder in
    ``dtype`` (the encoder states and ``enc_lin`` in bfloat16 under the
    recipe's bf16), the prediction network in float32, so the joint and
    ``out_lin`` (the step's largest product) run in float32, as in JAX.
    ``transcribe`` encodes and runs a ``TransducerBeamSearcher`` over
    ``pred_step`` and ``joint_step``, the recipe's
    ``transducer_searcher``.  ``set_kernels(False)`` routes the kernel
    calls of the model (the conformer's depthwise conv, K1) to their
    plain versions."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        c = dict(config)
        self.config = c
        self.device = resolve_device(device)
        self.dtype = dtype
        if self.FEATURES:
            self.fbank, self.normalize = _features(c)
        width = self._build_encoder(c)
        self.enc_lin = Linear(width, c["joint_dim"])
        self.emb = Embedding(c["vocab_size"], c["dec_emb_dim"])
        self.dec = GRU(c["dec_emb_dim"], c["dec_neurons"], num_layers=1)
        self.dec_lin = Linear(c["dec_neurons"], c["joint_dim"])
        self.joint = Transducer_joint("sum", c["joint_dim"], "tanh")
        self.out_lin = Linear(c["joint_dim"], c["vocab_size"])
        _random_init(self, torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.eval()

    # whether the encoder reads the Fbank features (False: the wave)
    FEATURES = True

    def _build_encoder(self, c):
        raise NotImplementedError

    def _encode(self, feats, sig_lens):
        """Normalized features in the activation dtype -> encoder states."""
        raise NotImplementedError

    def _encoder_states(self, sig, sig_lens, dtype, epoch=0, augment=None):
        """The wave -> Fbank -> the normalization (``epoch``: the epoch it
        sees) -> ``augment`` -> cast to ``dtype`` -> the encoder."""
        feats = self.normalize(self.fbank(sig), sig_lens, epoch=epoch)
        if augment is not None:
            feats = augment(feats)
        return self._encode(feats.to(dtype), sig_lens)

    def set_kernels(self, flag=True):
        """Route kernel calls to the CUDA kernels (True) or to their
        plain PyTorch versions (False)."""
        _set_kernels(self, flag)
        return self

    def forward(self, sig, sig_lens, tokens_blank, dtype=None, epoch=0,
                augment=None):
        """sig (B, samples), sig_lens (B,) relative, tokens_blank (B, U+1)
        = [blank] + tokens -> ``(logits (B, T_enc, U+1, vocab) float32,
        enc (B, T_enc, joint_dim))``.  The normalization updates its
        statistics in training mode (``epoch`` is the epoch it sees);
        ``augment`` (the features -> the features, e.g. SpecAugment) runs
        between the normalization and the cast to ``dtype``."""
        dtype = self.dtype if dtype is None else dtype
        enc = self.enc_lin(self._encoder_states(sig, sig_lens, dtype, epoch,
                                                augment))
        pred, _ = self.dec(self.emb(tokens_blank))
        joint = self.joint(enc, self.dec_lin(pred))  # bf16 + f32 -> f32
        return self.out_lin(joint).float(), enc

    @torch.no_grad()
    def encode(self, sig, sig_lens):
        """sig (B, samples) float32, sig_lens (B,) relative -> the joint's
        encoder side, ``enc_lin`` of the encoder states (B, T_enc,
        joint_dim), in ``self.dtype``."""
        sig = sig.to(self.device, torch.float32)
        sig_lens = sig_lens.to(self.device, torch.float32)
        return self.enc_lin(self._encoder_states(sig, sig_lens, self.dtype))

    def pred_step(self, tokens, state, n):
        """One prediction-network step for n rows: tokens (n,) and the
        GRU state (n, layers, H), batch-leading, or ``None`` and ``None``
        for the start, whose input is the blank token's embedding and
        which has no ``hx``.  Returns ``(dec_lin output (n, joint_dim)
        float32, state (n, layers, H))``."""
        if tokens is None:
            blank = torch.full((n, 1), self.config["blank_index"],
                               dtype=torch.long, device=self.device)
            out, hx = self.dec(self.emb(blank))
        else:
            out, hx = self.dec(self.emb(tokens[:, None]),
                               hx=state.transpose(0, 1))
        return self.dec_lin(out[:, 0]), hx.transpose(0, 1)

    def joint_step(self, enc, pred):
        """``out_lin(tanh(enc + pred))``: the recipe's joint on the
        encoder side and the prediction side (float32 when either is)."""
        return self.out_lin(torch.tanh(enc + pred))

    def make_searcher(self, **options):
        """The recipe's ``TransducerBeamSearcher`` over this model:
        ``beam_size``, ``state_beam`` and ``expand_beam`` from the config
        (4, 2.3, 2.3) unless ``options`` give them (beam 1 is greedy);
        the other ``options`` go to the searcher too (``nbest``,
        ``lm_fn``, ``lm_weight``, ``max_expand_per_frame``)."""
        c = self.config
        kw = {k: c[k] for k in ("beam_size", "state_beam", "expand_beam")}
        kw.update(options)
        return TransducerBeamSearcher(self.pred_step, self.joint_step,
                                      c["blank_index"], **kw)

    @torch.no_grad()
    def transcribe(self, sig, sig_lens, **search_options):
        """Returns ``(hyps, scores)``: per utterance the best token list
        and its normalised score (numpy), from the host lockstep beam
        search (greedy at ``beam_size=1``).  ``search_options`` are
        ``make_searcher``'s."""
        enc = self.encode(sig, sig_lens)
        searcher = self.make_searcher(**search_options)
        return searcher(enc, sig_lens.to(self.device, torch.float32))


class ConformerTransducer(_Transducer):
    """Conformer-transducer (RNN-T) built from a dict of dims: the conv
    front end and the conformer encoder (no decoder) of the
    ``_Transducer`` (``conformer_transducer.yaml``).

    Arguments
    ---------
    config : dict with the keys of ``CONFORMER_TRANSDUCER``.
    device : None for the CUDA card (raises without one), or e.g. "cpu".
    dtype : activation dtype of the features and the encoder (float32 or
        bfloat16); the prediction network runs in float32, so the joint
        does too.
    seed : seed of the random initial weights.

    Example
    -------
    >>> cfg = dict(CONFORMER_TRANSDUCER, frontend_channels=(4, 4),
    ...     input_size=40, d_model=16, nhead=2, num_encoder_layers=1,
    ...     d_ffn=32, kernel_size=5, vocab_size=12, n_mels=40,
    ...     dec_emb_dim=8, dec_neurons=8, joint_dim=8)
    >>> model = ConformerTransducer(cfg, device="cpu")
    >>> logits, enc = model(torch.zeros(2, 4000), torch.ones(2),
    ...     torch.tensor([[0, 3, 4], [0, 5, 0]]))
    >>> logits.shape, logits.dtype, enc.shape
    (torch.Size([2, 7, 3, 12]), torch.float32, torch.Size([2, 7, 8]))
    >>> hyps, scores = model.transcribe(torch.zeros(2, 4000), torch.ones(2))
    >>> len(hyps), scores.shape
    (2, (2,))
    """

    def _build_encoder(self, c):
        self.frontend = _conv_front_end(c)
        self.transformer = _transformer(c)
        return c["d_model"]

    def _encode(self, feats, sig_lens):
        return self.transformer.encode(self.frontend(feats), sig_lens)


class CRDNNTransducer(_Transducer):
    """CRDNN-transducer (RNN-T) built from a dict of dims: the
    ``_Transducer`` with the ``CRDNN`` encoder of the transducer recipe's
    ``hparams/train.yaml`` (2 CNN blocks of 64 and 128 channels pooling
    the frequencies 80 -> 20, a bidirectional LiGRU of 4 x 512, 2 DNN
    blocks of 512; no time pooling, so T_enc is the feature frames).
    Arguments as for ``ConformerTransducer``, with the keys of
    ``CRDNN_TRANSDUCER``; ``dropout`` acts in training mode only.

    Example
    -------
    >>> cfg = dict(CRDNN_TRANSDUCER, n_mels=16, cnn_channels=(4, 4),
    ...     rnn_layers=1, rnn_neurons=8, dnn_neurons=8, vocab_size=12,
    ...     dec_emb_dim=8, dec_neurons=8, joint_dim=8)
    >>> model = CRDNNTransducer(cfg, device="cpu")
    >>> logits, enc = model(torch.zeros(2, 4000), torch.ones(2),
    ...     torch.tensor([[0, 3, 4], [0, 5, 0]]))
    >>> logits.shape, enc.shape
    (torch.Size([2, 26, 3, 12]), torch.Size([2, 26, 8]))
    >>> hyps, scores = model.transcribe(torch.zeros(2, 4000), torch.ones(2),
    ...     beam_size=1)
    >>> len(hyps), scores.shape
    (2, (2,))
    """

    def _build_encoder(self, c):
        self.enc = CRDNN(
            input_size=_feature_width(c), cnn_blocks=c["cnn_blocks"],
            cnn_channels=c["cnn_channels"],
            inter_layer_pooling_size=c["inter_layer_pooling_size"],
            rnn_class="ligru", rnn_layers=c["rnn_layers"],
            rnn_neurons=c["rnn_neurons"],
            rnn_bidirectional=c["rnn_bidirectional"],
            dnn_blocks=c["dnn_blocks"], dnn_neurons=c["dnn_neurons"],
            dropout=c["dropout"])
        return self.enc.output_size

    def _encode(self, feats, sig_lens):
        return self.enc(feats, lengths=sig_lens)


class W2VTransducer(_Transducer):
    """The transducer over the wav2vec 2.0 encoder (TIMIT's
    ``transducer/train_wav2vec.py``): the wave in the activation dtype ->
    ``W2VLatentExtractor`` -> ``EncoderWrapper`` (no ``wav_lens``, no mask)
    -> ``enc_lin``; no features, no normalization.  Arguments as for
    ``ConformerTransducer``, with ``W2V_BASE``'s keys beside the
    transducer's.

    Example
    -------
    >>> cfg = dict(CRDNN_TRANSDUCER, **W2V_BASE)
    >>> cfg.update(latent_channels=(8, 8), embedding_dim=8,
    ...     encoder_layers=1, nhead=2, d_ffn=16, vocab_size=12,
    ...     dec_emb_dim=8, dec_neurons=8, joint_dim=8)
    >>> model = W2VTransducer(cfg, device="cpu")
    >>> logits, enc = model(torch.zeros(2, 4000), torch.ones(2),
    ...     torch.tensor([[0, 3, 4], [0, 5, 0]]))
    >>> logits.shape, enc.shape
    (torch.Size([2, 398, 3, 12]), torch.Size([2, 398, 8]))
    """

    FEATURES = False

    def _build_encoder(self, c):
        for name, module in wav2vec_encoder(c).items():
            setattr(self, name, module)
        return c["embedding_dim"]

    def _encoder_states(self, sig, sig_lens, dtype, epoch=0, augment=None):
        return self.encoder(self.extractor(sig.to(dtype)))["embeddings"]


class _TransducerBrain(_ModelBrain):
    """The LibriSpeech transducer recipe's ``Transducer`` Brain
    (``recipes/LibriSpeech/ASR/transducer/train.py:27-164``) on the
    modules of a ``_Transducer``.

    ``compute_forward``: the model's ``forward`` (Fbank ->
    ``InputNormalization``, updated in training until
    ``update_until_epoch`` -> SpecAugment (training only) -> cast to the
    activation dtype -> the encoder -> ``enc_lin``; ``emb`` of
    ``tokens_blank`` -> GRU -> ``dec_lin``; tanh joint -> ``out_lin``).
    ``compute_objectives``: ``transducer_loss`` (``mean``) with the
    lengths ``sig_lens * batch_mask`` and ``tokens_lens * batch_mask``,
    whose lattice runs in K8 (forward) and K9 (backward) on the card.
    After each optimizer step the Noam schedule sets the learning rate
    (``on_fit_batch_end``, l.98-100).  The validation stage computes the
    loss only; after ``on_stage_start(Stage.TEST)``, ``evaluate_batch``
    also runs the recipe's test search (``make_searcher``: beam 4,
    state_beam and expand_beam 2.3) on the batch's encoder side and
    appends its hypotheses to ``self.wer_metric``, an ``ErrorRateStats``
    over words (with a tokenizer) or token ids.

    ``on_stage_end`` does what the recipe's does (l.147-164): at VALID it
    writes the logger's line (``{"epoch", "lr"}``, the train and valid
    loss; ``hparams["train_logger"]`` when given) and, with a
    checkpointer, saves one with ``meta={"loss": loss}`` and keeps the
    best by loss; at TEST it writes the test line (``{"Epoch loaded"}``
    from ``hparams["epoch_counter"]``, the loss and the WER).  The last
    stats of each stage are in ``self.stage_stats``.  ``epoch`` (what the
    normalization sees) is the one ``fit`` passes to ``on_stage_start``,
    the epoch counter's, as the recipe passes ``epoch_counter.current``.

    A batch is a dict of ``sig`` (B, samples) and ``sig_lens`` (B,)
    relative, ``tokens`` (B, U) (padding: the pad id 0), the relative
    ``tokens_lens`` and ``tokens_blank`` (B, U+1) = [blank] + tokens.
    Arguments as for ``ConformerASRBrain``.
    """

    SEARCH_STAGES = (Stage.TEST,)

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch; the test stage's ``ErrorRateStats``
        and searcher."""
        if epoch is not None:
            self.epoch = epoch
        if stage == Stage.TEST:
            self.wer_metric = ErrorRateStats()
            self.searcher = self.model.make_searcher()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The recipe's logging and keep-best-by-loss checkpoint."""
        if stage == Stage.TRAIN:
            return
        stats = {"loss": stage_loss}
        if stage == Stage.TEST and hasattr(self, "wer_metric"):
            stats["WER"] = self.wer_metric.summarize("error_rate")
        self.stage_stats[stage.name] = stats
        train_logger = getattr(self.hparams, "train_logger", None)
        if stage == Stage.VALID:
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats=stats,
                )
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(
                    meta={"loss": stage_loss}, min_keys=["loss"])
        elif train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats,
            )

    def compute_forward(self, batch, stage):
        """Returns ``(logits float32, enc)``."""
        return self.model(batch["sig"], batch["sig_lens"],
                          batch["tokens_blank"], dtype=self.dtype,
                          epoch=self.epoch, augment=self._augment(stage))

    def compute_objectives(self, predictions, batch, stage):
        """The RNN-T loss, ``mean`` over the batch; in ``SEARCH_STAGES``
        (the test) the search's hypotheses scored too."""
        logits, enc = predictions
        mask = batch["batch_mask"]
        loss = transducer_loss(
            logits, batch["tokens"], batch["sig_lens"] * mask,
            batch["tokens_lens"] * mask,
            blank_index=self.config["blank_index"], reduction="mean",
            use_kernels=self.use_kernels)
        if stage in self.SEARCH_STAGES and hasattr(self, "wer_metric"):
            hyps, _ = self.searcher(enc, batch["sig_lens"])
            self._score_hyps(hyps, batch)
        return loss


class ConformerTransducerBrain(_TransducerBrain):
    """The transducer recipe's ``Transducer`` Brain
    (``_TransducerBrain``) on the modules of ``ConformerTransducer``
    (``conformer_transducer.yaml``: 12 conformer layers).  Arguments as
    for ``ConformerASRBrain``, with the keys of ``CONFORMER_TRANSDUCER``.

    Example
    -------
    >>> import numpy as np
    >>> cfg = dict(CONFORMER_TRANSDUCER, frontend_channels=(4, 4),
    ...     input_size=40, d_model=16, nhead=2, num_encoder_layers=1,
    ...     d_ffn=32, kernel_size=5, vocab_size=12, n_mels=40,
    ...     dec_emb_dim=8, dec_neurons=8, joint_dim=8)
    >>> brain = ConformerTransducerBrain(cfg, device="cpu")
    >>> batch = {"sig": np.zeros((1, 4000), np.float32),
    ...     "sig_lens": np.ones(1, np.float32),
    ...     "tokens": np.array([[3, 4]]), "tokens_lens": np.ones(1, np.float32),
    ...     "tokens_blank": np.array([[0, 3, 4]])}
    >>> brain.step += 1
    >>> bool(torch.isfinite(brain.fit_batch(batch)))
    True
    """

    MODEL, DEFAULTS = ConformerTransducer, CONFORMER_TRANSDUCER
    MODULES = ("normalize", "frontend", "transformer", "enc_lin", "emb", "dec",
               "dec_lin", "out_lin")


class CRDNNTransducerBrain(_TransducerBrain):
    """The transducer recipe's ``Transducer`` Brain
    (``_TransducerBrain``) on the modules of ``CRDNNTransducer``
    (``hparams/train.yaml``).  Arguments as for ``ConformerASRBrain``,
    with the keys of ``CRDNN_TRANSDUCER``.

    Example
    -------
    >>> import numpy as np
    >>> cfg = dict(CRDNN_TRANSDUCER, n_mels=16, cnn_channels=(4, 4),
    ...     rnn_layers=1, rnn_neurons=8, dnn_neurons=8, vocab_size=12,
    ...     dec_emb_dim=8, dec_neurons=8, joint_dim=8)
    >>> brain = CRDNNTransducerBrain(cfg, device="cpu")
    >>> batch = {"sig": np.zeros((2, 4000), np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "tokens": np.array([[3, 4], [5, 0]]),
    ...     "tokens_lens": np.array([1.0, 0.5], np.float32),
    ...     "tokens_blank": np.array([[0, 3, 4], [0, 5, 0]])}
    >>> brain.step += 1
    >>> bool(torch.isfinite(brain.fit_batch(batch)))
    True
    """

    MODEL, DEFAULTS = CRDNNTransducer, CRDNN_TRANSDUCER
    MODULES = ("normalize", "enc", "enc_lin", "emb", "dec", "dec_lin",
               "out_lin")
