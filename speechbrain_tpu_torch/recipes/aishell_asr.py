"""The AISHELL-1 ASR recipes end to end, on the port: character-level
joint CTC/attention models over the manifests of ``aishell_prepare.
prepare_aishell``, scored by the character error rate of a greedy CTC
decode.

- ``HPARAMS_SEQ2SEQ`` (``ASR/seq2seq/hparams/train.yaml``):
  ``CharSeq2SeqBrain``, the LibriSpeech seq2seq recipe's modules
  (``librispeech_seq2seq.build_modules``: Fbank, 80 mels -> global
  normalization -> a CRDNN of 3 CNN blocks and a bidirectional 5 x 1024
  LSTM -> a location-attention GRU decoder of 1024) with 0.3 CTC + 0.7
  NLL (no label smoothing, CTC in every epoch), no augmentation,
  Adadelta at the NewBob rate annealed on the validation CER, batches of
  12.
- ``HPARAMS_CONFORMER`` (``ASR/transformer/hparams/conformer_small.yaml``)
  and ``HPARAMS_TRANSFORMER`` (``train_ASR_transformer.yaml``: the
  transformer encoder with regularMHA at d_model 256): ``CharCTCBrain``,
  the LibriSpeech conformer step without SpecAugment, at 4300 outputs,
  on the transformer recipes' bucketed batches (tokens padded to 16-128).
- ``HPARAMS_WAV2VECT`` (``train_ASR_transformer_with_wav2vect.yaml``,
  ``train_with_wav2vect.py``): ``CharCTCBrain`` with the conformer_small
  model over ``W2VLatentExtractor``'s latents (seven convolutions of 512)
  in place of the Fbank, the normalization and the conv front end
  (``asr.ConformerASR`` with ``front_end`` "wav2vec": ``input_size`` 512,
  the latents cast to bf16 after the extractor, as the script casts
  them).

The characters are those of the transcripts with their spaces removed,
indexed by a ``CTCTextEncoder`` (``<blank>`` at 0, ``<bos>`` and
``<eos>`` at the yamls' ``bos_index`` 1 and ``eos_index`` 2, and the
characters of all three splits, saved to ``<save_folder>/
label_encoder.txt``); the yamls' output layers keep their sizes (5000 and
4300) whatever the inventory's (``train.yaml:38`` says it is "set at
runtime", but the JAX script never sets it; copied), and a greedy
hypothesis on an index outside the inventory scores as ``<id=N>``.

``run_seq2seq`` (with ``HPARAMS_SEQ2SEQ``) and ``run_transformer`` (with
``HPARAMS_CONFORMER`` or ``HPARAMS_TRANSFORMER``) train, validate, keep
the checkpoint with the best CER (a killed run resumes) and test from
it.  Differences from the JAX recipes:

- The JAX scripts' label encoder appends ``<bos>`` and ``<eos>`` after
  the characters (``seq2seq/train.py:161-173``), so the bos 1 and eos 2
  that the batches carry are characters, and the decoder learns to end a
  transcript on one; the port puts ``<bos>`` and ``<eos>`` at 1 and 2, as
  ``timit_ctc.dataio_prep`` does for TIMIT.
- The Noam schedule is registered with the checkpointer, so a resumed
  run continues its warmup; the JAX transformer script registers none
  (``ASR/transformer/train.py:231-238``), and its resumed runs restart
  the warmup.
"""

import collections

import numpy as np

from ..asr import CONFORMER_SMALL, W2V_BASE, ConformerASRBrain
from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..dataio.encoder import CTCTextEncoder
from ..decoders.ctc import ctc_greedy_decode
from ..nnet.losses import ctc_loss, nll_loss
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from . import librispeech_asr
from .aishell_prepare import prepare_aishell
from .common import recipe_hparams
from .librispeech_seq2seq import Seq2SeqBrain

__all__ = ["HPARAMS_SEQ2SEQ", "HPARAMS_CONFORMER", "HPARAMS_TRANSFORMER",
           "HPARAMS_WAV2VECT",
           "Corpus", "AISHELL", "CharSeq2SeqBrain", "CharCTCBrain",
           "make_datasets",
           "build_seq2seq", "build_transformer", "fit_and_test",
           "run_seq2seq", "run_transformer"]

# recipes/AISHELL-1/ASR/seq2seq/hparams/train.yaml (the JAX Brain's clip
# 5 and precision fp32; ``vocab_size`` is the yaml's output_neurons)
HPARAMS_SEQ2SEQ = dict(
    seed=1234,
    sample_rate=16000,
    n_mels=80,
    batch_size=12,
    number_of_epochs=25,
    lr=1.0,
    ctc_weight=0.3,
    blank_index=0,
    bos_index=1,
    eos_index=2,
    cnn_blocks=3,
    cnn_channels=(128, 200, 256),
    inter_layer_pooling_size=(2, 2, 2),
    rnn_layers=5,
    rnn_neurons=1024,
    dnn_blocks=2,
    dnn_neurons=1024,
    emb_size=128,
    dec_neurons=1024,
    attn_dim=512,
    vocab_size=5000,
    dropout=0.15,
    label_smoothing=0.0,
    augmentation=None,
    precision="fp32",
    rho=0.95,
    eps=1e-8,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)

# recipes/AISHELL-1/ASR/transformer/hparams/conformer_small.yaml: the
# LibriSpeech conformer_small values at 4300 outputs, no SpecAugment
HPARAMS_CONFORMER = dict(
    CONFORMER_SMALL,
    seed=7775,
    vocab_size=4300,
    max_batch_length=200,
    num_buckets=10,
    num_workers=4,
    number_of_epochs=120,
    grad_accumulation_factor=2,
    precision="bf16",
    augmentation=None,
    token_buckets=(16, 32, 64, 128),
)

# train_ASR_transformer.yaml: the transformer encoder at d_model 256
HPARAMS_TRANSFORMER = dict(
    HPARAMS_CONFORMER,
    d_model=256,
    encoder_module="transformer",
    attention_type="regularMHA",
)


# train_ASR_transformer_with_wav2vect.yaml: conformer_small.yaml's values
# over W2VLatentExtractor's latents (its default kernels and strides) in
# place of the features and the front end
HPARAMS_WAV2VECT = dict(
    {k: v for k, v in HPARAMS_CONFORMER.items()
     if k not in ("n_fft", "n_mels", "win_length", "hop_length",
                  "update_until_epoch") and not k.startswith("frontend_")},
    **{k: W2V_BASE[k] for k in ("latent_channels", "kernel_sizes",
                                "strides")},
    front_end="wav2vec",
    input_size=512,
)


class _CharCER:
    """The recipes' CER: a greedy CTC decode of the real rows against
    their targets, both mapped to characters by ``self.label_encoder``
    (``train.py:85-106``)."""

    def _score_ctc(self, ctc_logp, batch):
        real = int(batch["batch_mask"].sum())
        hyps = ctc_greedy_decode(ctc_logp, batch["sig_lens"],
                                 blank_id=self.hparams.blank_index)[:real]
        targets = batch["tokens"][:real].cpu().numpy().tolist()
        t_lens = batch["tokens_lens"][:real].cpu().numpy()
        U = len(targets[0]) if targets else 0
        targets = [t[:int(round(float(l) * U))]
                   for t, l in zip(targets, t_lens)]
        self.cer_metric.append([str(i) for i in range(real)], hyps, targets,
                               ind2lab=self.label_encoder.decode_ndim)


class CharSeq2SeqBrain(_CharCER, Seq2SeqBrain):
    """The AISHELL-1 seq2seq recipe's ``ASR`` Brain (``ASR/seq2seq/
    train.py:23-121``): ``Seq2SeqBrain``'s forward and optimizer, with
    ``ctc_weight`` x CTC + (1 - ``ctc_weight``) x NLL in every epoch, the
    greedy CTC CER outside training (no beam search), NewBob on the
    validation CER and checkpoints keeping the best CER.  ``label_encoder``
    maps the indices to characters."""

    metric = "CER"

    def __init__(self, hparams=None, run_opts=None, checkpointer=None,
                 label_encoder=None):
        super().__init__(dict(HPARAMS_SEQ2SEQ, **(hparams or {})), run_opts,
                         checkpointer)
        self.label_encoder = label_encoder

    def compute_objectives(self, predictions, batch, stage):
        """The joint loss; outside training, the CER."""
        ctc_logp, seq_logp, _ = predictions
        hp = self.hparams
        mask = batch["batch_mask"]
        loss_ctc = ctc_loss(ctc_logp, batch["tokens"],
                            batch["sig_lens"] * mask,
                            batch["tokens_lens"] * mask,
                            blank_index=hp.blank_index,
                            use_kernels=self.use_kernels)
        loss_seq = nll_loss(seq_logp, batch["tokens_eos"],
                            length=batch["tokens_eos_lens"] * mask)
        if stage != Stage.TRAIN and hasattr(self, "cer_metric"):
            self._score_ctc(ctc_logp, batch)
        return hp.ctc_weight * loss_ctc + (1 - hp.ctc_weight) * loss_seq

    def summarize_metric(self):
        """The stage's CER."""
        return self.cer_metric.summarize("error_rate")

    def extra_stats(self):
        """None beside the CER."""
        return {}


class CharCTCBrain(_CharCER, ConformerASRBrain):
    """The AISHELL-1 transformer recipe's ``ASR`` Brain (``ASR/
    transformer/train.py:27-125``): ``ConformerASRBrain``'s step, and
    outside training the greedy CTC CER instead of the beam search; the
    checkpoints keep the best CER.  ``label_encoder`` maps the indices to
    characters."""

    def __init__(self, config, *args, label_encoder=None, **kwargs):
        super().__init__(config, *args, **kwargs)
        self.label_encoder = label_encoder

    def on_stage_start(self, stage, epoch=None):
        """``ConformerASRBrain``'s, and a new CER metric outside
        training."""
        super().on_stage_start(stage, epoch)
        if stage != Stage.TRAIN:
            self.cer_metric = ErrorRateStats()

    def score_batch(self, predictions, batch):
        """The greedy CTC CER of the batch."""
        self._score_ctc(predictions[0], batch)

    def stage_metrics(self):
        """The stage's CER."""
        return {"CER": self.cer_metric.summarize("error_rate")}


# What a corpus gives the character recipes: ``prepare(hp)`` writes the
# manifests ``hp["<split>_json"]`` (unless they exist), ``text_key`` names
# their text field and ``chars(text)`` gives its characters.
Corpus = collections.namedtuple("Corpus", "prepare text_key chars")


def _chars_without_spaces(text):
    return [c for c in text if not c.isspace()]


AISHELL = Corpus(
    lambda hp: prepare_aishell(hp["data_folder"], hp["save_folder"]),
    "transcript", _chars_without_spaces)


def make_datasets(hparams, corpus=AISHELL):
    """The train, valid and test datasets (``hparams["<split>_json"]``:
    ``sig``, and the characters of ``corpus``' text field (for AISHELL-1
    the transcript without its spaces) as
    ``tokens``/``tokens_bos``/``tokens_eos`` through a ``CTCTextEncoder``
    built over all three splits with ``<blank>`` at 0, ``<bos>`` at
    ``bos_index`` and ``<eos>`` at ``eos_index`` (the characters that held
    them move to the end), or loaded from ``<save_folder>/
    label_encoder.txt``).  Returns ``(datasets by split, encoder)``."""
    label_encoder = CTCTextEncoder()
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(corpus.chars, takes=corpus.text_key,
                            provides="char_list")

        def tokens_pipeline(char_list):
            tokens = label_encoder.encode_sequence(char_list)
            return (np.asarray(tokens, np.int64),
                    np.asarray([hparams["bos_index"]] + tokens, np.int64),
                    np.asarray(tokens + [hparams["eos_index"]], np.int64))

        ds.add_dynamic_item(tokens_pipeline, takes="char_list",
                            provides=["tokens", "tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "sig", "tokens", "tokens_bos",
                            "tokens_eos"])
        datasets[split] = ds
    path = hparams["save_folder"] + "/label_encoder.txt"
    label_encoder.load_or_create(
        path=path,
        from_didatasets=[datasets[s] for s in ("train", "valid", "test")],
        output_key="char_list", sequence_input=True,
        special_labels={"blank_label": "<blank>"},
    )
    if "<bos>" not in label_encoder.lab2ind:
        label_encoder.insert_bos_eos("<bos>", "<eos>", hparams["bos_index"],
                                     hparams["eos_index"])
        label_encoder.save(path)
    return datasets, label_encoder


def _prepare(data_folder, output_folder, overrides, hparams, corpus):
    """What both builds share: the recipe's values, the manifests of
    ``corpus`` (prepared unless they exist), the datasets and the label
    encoder, an
    ``EpochCounter``, the Brain's values with a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt``, and a ``Checkpointer`` on
    ``<output_folder>/save``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev"),
        ("test_json", "test")))
    run_on_main(corpus.prepare, args=(hp,))
    datasets, label_encoder = make_datasets(hp, corpus)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    train_hp = dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                    epoch_counter=epoch_counter)
    return (hp, datasets, label_encoder, epoch_counter, train_hp,
            Checkpointer(hp["save_folder"]))


def build_seq2seq(data_folder, output_folder, overrides=None, run_opts=None,
                  hparams=HPARAMS_SEQ2SEQ, corpus=AISHELL):
    """Everything ``run_seq2seq`` trains with, built as the seq2seq
    script's ``__main__`` builds it: the manifests (prepared unless they
    exist), the datasets and the label encoder, loaders of ``batch_size``
    (the train loader shuffled), an ``EpochCounter`` and a
    ``CharSeq2SeqBrain`` with a ``Checkpointer`` on ``<output_folder>/
    save`` and a ``FileTrainLogger`` on ``<output_folder>/train_log.txt``.

    ``overrides`` replace values of ``hparams``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU); ``corpus`` (a ``Corpus``) prepares the manifests and reads
    their text.  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader``, ``test_loader``, ``label_encoder``
    and ``hparams``."""
    hp, datasets, label_encoder, epoch_counter, train_hp, checkpointer = (
        _prepare(data_folder, output_folder, overrides, hparams, corpus))
    brain = CharSeq2SeqBrain(train_hp, run_opts=run_opts,
                             checkpointer=checkpointer,
                             label_encoder=label_encoder)
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "label_encoder": label_encoder, "hparams": hp}


def build_transformer(data_folder, output_folder, overrides=None,
                      run_opts=None, hparams=HPARAMS_CONFORMER,
                      corpus=AISHELL):
    """``build_seq2seq``'s parts for the transformer script
    (``HPARAMS_CONFORMER`` or ``HPARAMS_TRANSFORMER``): a ``CharCTCBrain``
    on ``librispeech_asr.make_loaders``' loaders, tokens padded to
    ``token_buckets``."""
    hp, datasets, label_encoder, epoch_counter, train_hp, checkpointer = (
        _prepare(data_folder, output_folder, overrides, hparams, corpus))
    brain = CharCTCBrain(hp, seed=hp["seed"], run_opts=run_opts,
                         hparams=train_hp, checkpointer=checkpointer,
                         label_encoder=label_encoder)
    train_loader, valid_loader, tests = librispeech_asr.make_loaders(
        hp, datasets["train"], datasets["valid"],
        {"test": datasets["test"]}, token_buckets=hp["token_buckets"])
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": train_loader, "valid_loader": valid_loader,
            "test_loader": tests["test"], "label_encoder": label_encoder,
            "hparams": hp}


def fit_and_test(parts):
    """``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` on the test set from the checkpoint with
    the lowest validation CER.  Returns the Brain (``brain.stage_stats``
    holds the last VALID and TEST loss and CER)."""
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="CER")
    return brain


def run_seq2seq(data_folder, output_folder, overrides=None, run_opts=None,
                hparams=HPARAMS_SEQ2SEQ, corpus=AISHELL):
    """The seq2seq script's ``__main__``: ``build_seq2seq``, ``fit``, then
    the test.  Arguments as for ``build_seq2seq``; returns the Brain."""
    return fit_and_test(build_seq2seq(data_folder, output_folder,
                                       overrides, run_opts, hparams, corpus))


def run_transformer(data_folder, output_folder, overrides=None,
                    run_opts=None, hparams=HPARAMS_CONFORMER, corpus=AISHELL):
    """The transformer script's ``__main__``: ``build_transformer``,
    ``fit``, then the test.  Arguments as for ``build_transformer``;
    returns the Brain."""
    return fit_and_test(build_transformer(data_folder, output_folder,
                                           overrides, run_opts, hparams,
                                           corpus))
