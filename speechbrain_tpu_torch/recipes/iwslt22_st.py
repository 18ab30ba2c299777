"""The IWSLT 2022 low-resource speech translation recipe (Tamasheq speech
-> French text) end to end, on the port.

Does what ``recipes/IWSLT22_lowresource/train.py`` does with
``hparams/train_w2v2_st.yaml`` (``HPARAMS``): the corpus's manifests
(``iwslt22_prepare.data_proc``) -> a unigram ``SentencePiece`` of
``vocab_size`` 1000 pieces trained on the train manifest's ``trans`` ->
batches of 2 read from disk (the train loader shuffled) -> ``ST.fit``:
the wave -> ``W2VLatentExtractor`` (seven convolutions of 512) ->
``EncoderWrapper`` (the first ``keep_n_layers`` 6 layers at d 768, called
without ``wav_lens``) -> ``enc``, a ``Linear`` to d_model 256 ->
``TransformerST.forward_mt_decoder_only`` (3 post-norm decoder layers, 4
heads, d_ffn 1024, over the tokens' embeddings and the absolute PE) ->
``seq_lin`` -> log-softmax; the NLL of ``tokens_eos`` with label smoothing
0.1; Adam (optax's defaults) at the Noam rate (``lr_adam`` 1e-3, 10000
warmup steps), gradients accumulated over 4 batches and clipped at 5 ->
outside training the BLEU of the teacher-forced argmax -> the checkpoint
with the best BLEU -> the test from it.  No port kernel lies on this
path.  A killed run resumes from its latest checkpoint when ``run`` is
called again on the same output folder.

The yaml's values are ``HPARAMS`` (the file is not read; its wav2vec dims
keep their names: ``features_dim``, ``keep_n_layers``, ``nhead_w2v``,
``d_ffn_w2v``); ``overrides`` replace any of them, e.g. toy widths on the
CPU::

    from speechbrain_tpu_torch.recipes import iwslt22_st
    brain = iwslt22_st.run("/data/iwslt22_tamasheq", "results/w2v2_st",
                           run_opts={"device": "cpu"},
                           overrides={"features_dim": 32, ...})

Properties of the JAX script that the port copies (ROADMAP Queue 3 pins
each): the encoder reads the padded frames of a batch's shorter clips (no
``wav_lens``); the decoder attends to every encoder frame (no memory
mask); the preparation keys rows by the wav's basename
(``iwslt22_prepare``); the BLEU's hypotheses are the argmax over the
whole padded row of the teacher-forced decoder.  And those it does not
copy: the JAX script appends a batch's references as one segment
(``[refs]``, ``train.py:71-73``) and its hypotheses and references as
joined strings, so its BLEU counts character n-grams, pairs each batch's
first hypothesis with all of the batch's references and the others with
none; the port holds each hypothesis's words to its own reference's, as
``fisher_st`` does.  The port registers the Noam schedule with the
checkpointer (the JAX script registers none, so its resumed runs restart
the warmup).
"""

import numpy as np
import torch

from ..asr import _random_init, wav2vec_encoder
from ..core import Brain, Stage
from ..dataio.dataloader import SaveableDataLoader
from ..lobes.models.transformer.TransformerST import TransformerST
from ..nnet.linear import Linear
from ..nnet.losses import nll_loss
from ..nnet.schedulers import NoamScheduler
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.bleu import BLEUStats
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import at_least_f32, recipe_hparams
from .fisher_st import teacher_forced_words
from .iwslt22_prepare import data_proc
from .librispeech_seq2seq import wav2vec_states
from .taigi_st import make_datasets

__all__ = ["HPARAMS", "build_modules", "ST", "build", "run"]

# recipes/IWSLT22_lowresource/hparams/train_w2v2_st.yaml (with the JAX
# Brain's fp32 and clip 5, W2VLatentExtractor's kernels and strides,
# EncoderWrapper's dropout 0.1 and TransformerST's post-norm relu layers,
# which the yaml leaves as they are)
HPARAMS = dict(
    seed=7777,
    sample_rate=16000,
    lang="fr",
    vocab_size=1000,
    token_type="unigram",
    pad_index=0,
    bos_index=1,
    eos_index=2,
    batch_size=2,
    grad_accumulation_factor=4,
    number_of_epochs=100,
    lr_adam=0.001,
    n_warmup_steps=10000,
    label_smoothing=0.1,
    precision="fp32",
    max_grad_norm=5.0,
    latent_channels=(512,) * 7,
    kernel_sizes=(11, 3, 3, 3, 3, 3, 3),
    strides=(5, 2, 2, 2, 2, 2, 2),
    features_dim=768,
    keep_n_layers=6,
    nhead_w2v=8,
    d_ffn_w2v=3072,
    encoder_dropout=0.1,
    d_model=256,
    nhead=4,
    num_encoder_layers=1,
    num_decoder_layers=3,
    d_ffn=1024,
    transformer_dropout=0.1,
    activation="relu",
    normalize_before=False,
)


def build_modules(hparams, seed=0):
    """The yaml's modules with Lecun-normal weights from ``seed``
    (``asr._random_init``): ``extractor`` and ``encoder``
    (``asr.wav2vec_encoder`` at ``keep_n_layers``), ``enc`` (``Linear`` to
    d_model), ``Transformer`` (``TransformerST``: its one encoder layer is
    built and never run, as the yaml builds it) and ``seq_lin``."""
    hp = dict(HPARAMS, **hparams)
    modules = wav2vec_encoder(dict(
        hp, embedding_dim=hp["features_dim"],
        encoder_layers=hp["keep_n_layers"], nhead=hp["nhead_w2v"],
        d_ffn=hp["d_ffn_w2v"]))
    modules["enc"] = Linear(hp["features_dim"], hp["d_model"])
    modules["Transformer"] = TransformerST(
        hp["vocab_size"], hp["d_model"], d_model=hp["d_model"],
        nhead=hp["nhead"], num_encoder_layers=hp["num_encoder_layers"],
        num_decoder_layers=hp["num_decoder_layers"], d_ffn=hp["d_ffn"],
        dropout=hp["transformer_dropout"], activation=hp["activation"],
        normalize_before=hp["normalize_before"])
    modules["seq_lin"] = Linear(hp["d_model"], hp["vocab_size"])
    gen = torch.Generator().manual_seed(seed)
    for module in modules.values():
        _random_init(module, gen)
    return modules


class ST(Brain):
    """The script's ``ST`` Brain (``train.py:27-111``).

    ``compute_forward``: the wave in the activation dtype -> the wav2vec
    encoder (``librispeech_seq2seq.wav2vec_states``) -> ``enc`` ->
    ``Transformer.forward_mt_decoder_only`` over ``tokens_bos`` (keys at
    ``pad_index`` masked) -> ``seq_lin`` -> float32 (float64 under a
    float64 ``self.dtype``) log-softmax.  ``compute_objectives``: the NLL
    of ``tokens_eos`` (``label_smoothing``, lengths ``tokens_eos_lens *
    batch_mask``); outside training the real rows' argmax over their
    whole padded rows, decoded by ``tokenizer`` to words, each against
    its reference's words in the BLEU.  Adam (b1 0.9, b2 0.999, eps 1e-8)
    after the clip to ``max_grad_norm``, at ``hparams["lr"]`` (1e-3 when
    not given, as in the JAX ``Brain``) for the first optimizer step and
    the Noam rate after each (``"noam_annealing"`` in the checkpointer).
    ``on_stage_end`` keeps the stage's ``loss`` and ``BLEU`` in
    ``self.stage_stats``; at VALID it logs them and keeps the checkpoint
    with the best BLEU, at TEST it logs them.

    Example
    -------
    >>> hp = dict(HPARAMS, latent_channels=(8, 8), features_dim=8,
    ...           keep_n_layers=1, nhead_w2v=2, d_ffn_w2v=16, d_model=8,
    ...           nhead=2, num_decoder_layers=1, d_ffn=16, vocab_size=9)
    >>> brain = ST(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(2, 1600)).astype(np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "tokens_bos": np.array([[1, 3, 4], [1, 5, 0]]),
    ...     "tokens_eos": np.array([[3, 4, 2], [5, 2, 0]]),
    ...     "tokens_eos_lens": np.array([1.0, 2 / 3], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    def __init__(self, hparams=None, run_opts=None, checkpointer=None,
                 tokenizer=None):
        hp = dict(HPARAMS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])
        super().__init__(modules=build_modules(hp, run_opts["seed"]),
                         opt_class=torch.optim.Adam, hparams=hp,
                         run_opts=run_opts, checkpointer=checkpointer)
        self.tokenizer = tokenizer
        self.noam = NoamScheduler(hp["lr_adam"], hp["n_warmup_steps"])
        if (checkpointer is not None
                and "noam_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("noam_annealing", self.noam)
        self.stage_stats = {}

    def compute_forward(self, batch, stage):
        """Returns the (B, U, vocab) log-probabilities."""
        m = self.modules
        src = m.enc(wav2vec_states(m, batch["sig"], self.dtype))
        dec = m.Transformer.forward_mt_decoder_only(
            src, batch["tokens_bos"], pad_idx=self.hparams.pad_index)
        return torch.log_softmax(at_least_f32(m.seq_lin(dec)), -1)

    def compute_objectives(self, predictions, batch, stage):
        """The NLL; outside training, the BLEU's segments."""
        loss = nll_loss(predictions, batch["tokens_eos"],
                        length=batch["tokens_eos_lens"] * batch["batch_mask"],
                        label_smoothing=self.hparams.label_smoothing)
        if stage != Stage.TRAIN and hasattr(self, "bleu_metric"):
            hyps, refs = teacher_forced_words(predictions, batch,
                                              self.tokenizer, "tokens")
            self.bleu_metric.append([str(i) for i in range(len(hyps))], hyps,
                                    [[r] for r in refs])
        return loss

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """The Noam rate after each optimizer step."""
        if should_step:
            _, self.lr = self.noam()

    def on_stage_start(self, stage, epoch=None):
        """A BLEU metric outside training."""
        if stage != Stage.TRAIN:
            self.bleu_metric = BLEUStats(lang=self.hparams.lang)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The stage's stats; at VALID the log line and the keep-best
        checkpoint, at TEST the log line with the epoch loaded."""
        if stage == Stage.TRAIN:
            return
        stats = {"loss": stage_loss,
                 "BLEU": self.bleu_metric.summarize("BLEU")}
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
                    meta={"BLEU": stats["BLEU"]}, max_keys=["BLEU"])
        elif train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the script's ``__main__``
    builds it (``train.py:143-194``): the manifests in ``<output_folder>/
    save`` (``data_proc``, kept when they exist), the tokenizer (trained
    on the train manifest's ``trans`` unless its model file exists there),
    the datasets (``taigi_st.make_datasets`` on ``trans``), loaders of
    ``batch_size`` (the train loader shuffled), an ``EpochCounter`` and an
    ``ST`` Brain with a ``Checkpointer`` on ``<output_folder>/save`` and a
    ``FileTrainLogger`` on ``<output_folder>/train_log.txt``.

    ``overrides`` replace values of ``hparams``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU).  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader``, ``test_loader``, ``tokenizer``
    and ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "valid"),
        ("test_json", "test")))
    run_on_main(data_proc, kwargs={"dataset_folder": hp["data_folder"],
                                   "output_folder": hp["save_folder"]})
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="trans",
        model_type=hp["token_type"], annotation_format="json",
        character_coverage=1.0)
    datasets = make_datasets(hp, tokenizer, text_key="trans")
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = ST(dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                    epoch_counter=epoch_counter),
               run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]),
               tokenizer=tokenizer)
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "tokenizer": tokenizer, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The script's ``__main__``: ``build``, ``fit`` (resuming from the
    latest checkpoint in ``<output_folder>/save``), then ``evaluate`` on
    the test set from the checkpoint with the best BLEU.  Arguments as for
    ``build``; returns the Brain (``brain.stage_stats`` holds the last
    VALID and TEST loss and BLEU)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], max_key="BLEU")
    return brain
