"""Entry points of the speech translation models: the model (serving and
the training step) that the Taigi and Fisher-Callhome recipes share.

``SpeechTranslator`` chains Fbank -> global input normalization -> conv
front end -> ``TransformerST`` -> ``seq_lin`` (the translation head),
plus the auxiliary ASR heads its config turns on: ``ctc_lin`` over the
encoder states when ``ctc_weight > 0``, and ``asr_lin`` over
``TransformerST.forward_asr`` when ``ctc_weight < 1 and asr_weight >
0`` (the JAX module's condition for its ASR decoder).  ``translate`` runs
the recipes' beam search (no CTC, no eos threshold, length
normalization) on the KV-cached decoder, whose self-attention step is
the kernel K7 on the card.  ``STBrain`` trains its modules under the
Noam schedule with Adam (the yamls' ``optax.adam``); the recipes' Brains
(``recipes/taigi_st.py``, ``recipes/fisher_st.py``) add their losses'
weights and their scoring.  Weights are random from a seed, or loaded
with ``load_state_dict`` from ``bridge.py``'s output.
"""

import torch

from .asr import (_ModelBrain, _conv_front_end, _features, _random_init,
                  _set_kernels)
from .core import Stage
from .decoders.seq2seq import S2STransformerBeamSearch
from .device import resolve_device
from .lobes.models.transformer.TransformerST import TransformerST
from .nnet.linear import Linear

__all__ = ["ST_DEFAULTS", "SpeechTranslator", "STBrain"]

# the model and training values both ST yamls share (the Taigi yaml's
# where they differ); the recipes' dicts are built on top
ST_DEFAULTS = {
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
    "d_model": 256,
    "nhead": 4,
    "num_encoder_layers": 12,
    "num_decoder_layers": 6,
    "d_ffn": 2048,
    "kernel_size": 31,
    "vocab_size": 5000,
    "activation": "relu",
    "normalize_before": True,
    "encoder_module": "transformer",
    "attention_type": "regularMHA",
    "ctc_weight": 0.0,
    "asr_weight": 0.0,
    "mt_weight": 0.0,
    "bos_index": 1,
    "eos_index": 2,
    "blank_index": 0,
    "pad_index": 0,
    "min_decode_ratio": 0.0,
    "max_decode_ratio": 1.0,
    "transformer_dropout": 0.1,
    "update_until_epoch": 3,
    "label_smoothing": 0.1,
    "lr_adam": 0.25,
    "n_warmup_steps": 25000,
    "max_grad_norm": 5.0,
    "augmentation": None,
}


class SpeechTranslator(torch.nn.Module):
    """Speech translation model built from a dict of dims.

    Arguments
    ---------
    config : dict with the keys of ``ST_DEFAULTS`` (``asr_tgt_vocab``
        for the ASR decoder's transcripts: ``vocab_size`` when absent,
        since the recipes encode both languages with one tokenizer).
    device : None for the CUDA card (raises without one), or e.g. "cpu".
    dtype : activation dtype (float32 or bfloat16); parameters stay
        float32, and features, normalization and softmaxes float32.
    seed : seed of the random initial weights.

    ``set_kernels(False)`` routes every kernel call to its plain PyTorch
    version.

    Example
    -------
    >>> cfg = dict(ST_DEFAULTS, frontend_channels=(4, 4), input_size=40,
    ...     n_mels=40, d_model=16, nhead=2, num_encoder_layers=1,
    ...     num_decoder_layers=1, d_ffn=32, vocab_size=12)
    >>> st = SpeechTranslator(cfg, device="cpu")
    >>> hyps, scores = st.translate(torch.zeros(1, 4000), torch.ones(1),
    ...                             beam_size=2)
    >>> len(hyps), scores.shape
    (1, (1,))
    """

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        c = dict(config)
        self.config = c
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fbank, self.normalize = _features(c)
        self.frontend = _conv_front_end(c)
        self.transformer = TransformerST(
            c["vocab_size"], c["input_size"], d_model=c["d_model"],
            nhead=c["nhead"], num_encoder_layers=c["num_encoder_layers"],
            num_decoder_layers=c["num_decoder_layers"], d_ffn=c["d_ffn"],
            dropout=c["transformer_dropout"], activation=c["activation"],
            normalize_before=c["normalize_before"],
            kernel_size=c["kernel_size"], encoder_module=c["encoder_module"],
            attention_type=c["attention_type"], ctc_weight=c["ctc_weight"],
            asr_weight=c["asr_weight"], mt_weight=c["mt_weight"],
            asr_tgt_vocab=c.get("asr_tgt_vocab", c["vocab_size"]),
            mt_src_vocab=c.get("mt_src_vocab", c["vocab_size"]),
        )
        self.seq_lin = Linear(c["d_model"], c["vocab_size"])
        self.heads = ["seq_lin"]
        if c["ctc_weight"] > 0:
            self.ctc_lin = Linear(c["d_model"], c["vocab_size"])
            self.heads.append("ctc_lin")
        if hasattr(self.transformer, "asr_decoder"):
            self.asr_lin = Linear(c["d_model"], c["vocab_size"])
            self.heads.append("asr_lin")
        _random_init(self, torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.eval()

    def set_kernels(self, flag=True):
        """Route kernel calls to the CUDA kernels (True) or to their
        plain PyTorch versions (False)."""
        _set_kernels(self, flag)
        return self

    @torch.no_grad()
    def encode(self, sig, sig_lens, dtype=None):
        """sig (B, samples) float32, sig_lens (B,) relative -> raw encoder
        states (B, T_enc, d_model), computed in ``dtype`` (the model's
        when None)."""
        sig = sig.to(self.device, torch.float32)
        sig_lens = sig_lens.to(self.device, torch.float32)
        feats = self.normalize(self.fbank(sig), sig_lens)
        src = self.frontend(feats.to(dtype or self.dtype))
        return self.transformer.encode(src, sig_lens)

    def make_searcher(self, beam_size=10):
        """The recipes' beam search over the KV-cached translation
        decoder: no CTC, no eos threshold, length normalization."""
        c = self.config
        t = self.transformer
        return S2STransformerBeamSearch(
            step_fn=lambda tok, cache, pos, el, rows: t.decode_step(
                tok, cache, pos, el, rows=rows),
            cache_init_fn=t.decode_cache_init,
            linear_fn=self.seq_lin,
            bos_index=c["bos_index"],
            eos_index=c["eos_index"],
            blank_index=c["blank_index"],
            min_decode_ratio=c["min_decode_ratio"],
            max_decode_ratio=c["max_decode_ratio"],
            beam_size=beam_size,
            ctc_weight=0.0,
            using_eos_threshold=False,
            length_normalization=True,
        )

    @torch.no_grad()
    def translate(self, sig, sig_lens, beam_size=10, dtype=None):
        """Returns ``(hyps, scores)``: per utterance the best token list
        (bos/eos stripped) and its score (numpy); ``dtype`` as for
        ``encode``."""
        enc = self.encode(sig, sig_lens, dtype)
        searcher = self.make_searcher(beam_size)
        return searcher(enc, sig_lens.to(self.device, torch.float32))


class STBrain(_ModelBrain):
    """The speech translation recipes' training step on the modules of
    ``SpeechTranslator``: Fbank -> ``InputNormalization`` (its statistics
    updated in training until ``update_until_epoch``) -> cast to the
    activation dtype -> front end -> ``TransformerST.forward`` over
    ``<prefix>tokens_bos`` -> ``seq_lin`` with a float32 log-softmax; with
    the ASR heads, ``ctc_lin`` over the encoder states ``forward`` returns
    and ``asr_lin`` over ``forward_asr`` of ``src_tokens_bos``.  Adam
    (b1 0.9, b2 0.999, eps 1e-8: the yamls' ``optax.adam``) at the Noam
    rate after each optimizer step (the first at ``hparams["lr"]``, 1e-3
    when not given, as in the JAX ``Brain``).

    A recipe's Brain sets ``TARGET`` (the batch keys' prefix of the
    translation: ``tokens`` for Taigi, ``trans_tokens`` for Fisher) and
    gives ``compute_objectives`` and the stages' hooks.  ``self.model``
    is the ``SpeechTranslator`` that owns the modules.

    Arguments
    ---------
    config : dict with the keys of ``ST_DEFAULTS``.
    opt_class : callable(params) -> optimizer; default Adam as above.
    device, seed, run_opts, hparams, checkpointer, tokenizer : as for
        ``asr.ConformerASRBrain``.
    """

    MODEL, DEFAULTS = SpeechTranslator, ST_DEFAULTS
    TARGET = "tokens"

    @property
    def MODULES(self):
        return ("normalize", "frontend", "transformer", *self.model.heads)

    def __init__(self, config, opt_class=None, **kwargs):
        if opt_class is None:
            def opt_class(params):
                return torch.optim.Adam(params)
        super().__init__(config, opt_class=opt_class, **kwargs)

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch."""
        if epoch is not None:
            self.epoch = epoch

    def compute_forward(self, batch, stage):
        """Returns the float32 log-probabilities of the translation, and
        of the CTC and ASR-decoder heads (None without them)."""
        m = self.modules
        feats = m.normalize(self.model.fbank(batch["sig"]), batch["sig_lens"],
                            epoch=self.epoch)
        src = m.frontend(feats.to(self.dtype))
        pad = self.config["pad_index"]
        enc, dec = m.transformer(src, batch[f"{self.TARGET}_bos"],
                                 wav_len=batch["sig_lens"], pad_idx=pad)
        st_logp = torch.log_softmax(m.seq_lin(dec).float(), -1)
        ctc_logp = asr_logp = None
        if "ctc_lin" in m:
            ctc_logp = torch.log_softmax(m.ctc_lin(enc).float(), -1)
        if "asr_lin" in m:
            asr_dec = m.transformer.forward_asr(
                enc, batch["src_tokens_bos"], batch["sig_lens"], pad)
            asr_logp = torch.log_softmax(m.asr_lin(asr_dec).float(), -1)
        return st_logp, ctc_logp, asr_logp

    def log_and_keep(self, stage, stage_loss, epoch, stats):
        """The stage's stats in ``self.stage_stats``; at VALID the logger's
        line (``hparams["train_logger"]``, when given) and, with a
        checkpointer, a checkpoint with ``meta={"BLEU": stats["BLEU"]}``
        (0.0 when the stage has none), keeping the best BLEU; at TEST the
        test line with the epoch loaded."""
        self.stage_stats[stage.name] = stats
        train_logger = getattr(self.hparams, "train_logger", None)
        if stage == Stage.VALID:
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats=stats)
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(
                    meta={"BLEU": stats.get("BLEU", 0.0)}, max_keys=["BLEU"])
            return
        if train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats)
