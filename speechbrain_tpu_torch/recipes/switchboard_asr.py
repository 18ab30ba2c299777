"""The Switchboard ASR recipes end to end, on the port.

Two families over the manifests of ``switchboard_prepare.
prepare_switchboard`` (segments of 2-channel 8 kHz SPHERE conversations,
each row naming its side's ``channel``) and a unigram ``SentencePiece``
tokenizer of 2000 pieces trained on the train manifest's ``words``:

- ``HPARAMS_SEQ2SEQ`` (``ASR/seq2seq/hparams/train_BPE_2000.yaml``):
  the LibriSpeech CRDNN seq2seq recipe at 2000 tokens
  (``librispeech_seq2seq.Seq2SeqBrain``: CRDNN with a bidirectional LSTM,
  location-attention GRU decoder, CTC for 5 epochs, SpecAugment, the
  beam search's WER and CER, NewBob on the WER; an ``RNNLM`` fused when
  ``run_opts["lm_ckpt"]`` names its ``state_dict``).
- ``HPARAMS_TRANSFORMER`` and ``HPARAMS_TRANSFORMER_FINETUNED_LM``
  (``ASR/transformer/hparams/transformer.yaml`` and
  ``transformer_finetuned_LM.yaml``, the same values): the KsponSpeech
  conformer recipe (d_model 256) at 2000 tokens on 8 kHz features,
  ``SwitchboardASRBrain`` scoring the WER after ``normalize_words``
  (contractions expanded, hesitations removed), each test split's
  details in ``<output_folder>/wer_<split>.txt``; a ``TransformerLM``
  (d_model 768) fused from ``run_opts["lm_ckpt"]``, e.g. the
  ``lm.ckpt`` of ``lm_training.run`` with ``HPARAMS_SWITCHBOARD``.

``run_seq2seq`` and ``run_transformer`` train, validate, checkpoint (a
killed run resumes) and test on ``eval2000`` when its manifest was
prepared.

Differences from the JAX recipes (each pinned by a test in
``tests/test_torch_switchboard.py``):

- Every dataset reads the row's own side of the stereo conversation.
  The JAX seq2seq script reads both channels (``ASR/seq2seq/
  train.py:221``), and its features' normalization then raises on the
  (B, T, n_mels, 2) stereo features; the JAX transformer script picks
  the channel (``ASR/transformer/train.py:235-240``), as here.
- The seq2seq recipe tests on the prepared ``eval2000.json`` when there
  is one, as the transformer recipe does; the JAX seq2seq yaml names a
  ``test.json`` (``train_BPE_2000.yaml:19``) that the prepare script
  never writes, so its script stops there.
- Copied: the seq2seq yaml's ``sample_rate`` 16000 (``train_BPE_2000.
  yaml:25``) on the 8 kHz audio (nothing resamples: its Fbank's 25 ms
  window and 10 ms hop span 50 ms and 20 ms of the audio); the
  "finetuned" yaml's LibriSpeech LM, which no script loads (the yaml is
  ``transformer.yaml``'s values).
"""

import os

from ..asr import ConformerASRBrain
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from . import librispeech_asr, librispeech_seq2seq
from .common import recipe_hparams
from .ksponspeech_asr import HPARAMS as _KSPON
from .switchboard_prepare import normalize_words, prepare_switchboard

__all__ = ["HPARAMS_SEQ2SEQ", "HPARAMS_TRANSFORMER",
           "HPARAMS_TRANSFORMER_FINETUNED_LM", "read_channel",
           "SwitchboardASRBrain", "build_seq2seq", "build_transformer",
           "run_seq2seq", "run_transformer"]

_LIBRISPEECH_ONLY = ("train_splits", "dev_splits", "test_splits")

# recipes/Switchboard/ASR/seq2seq/hparams/train_BPE_2000.yaml: the
# LibriSpeech seq2seq yaml at 2000 tokens
HPARAMS_SEQ2SEQ = dict(
    {k: v for k, v in librispeech_seq2seq.HPARAMS.items()
     if k not in _LIBRISPEECH_ONLY},
    dev_conversations=20,
    vocab_size=2000,
)

# recipes/Switchboard/ASR/transformer/hparams/transformer.yaml: the
# KsponSpeech conformer_medium yaml at 2000 tokens and 8 kHz
HPARAMS_TRANSFORMER = dict(
    {k: v for k, v in _KSPON.items() if k not in _LIBRISPEECH_ONLY},
    dev_conversations=20,
    test_splits=["eval2000"],
    vocab_size=2000,
    sample_rate=8000,
)

# transformer_finetuned_LM.yaml: the same values (see the module)
HPARAMS_TRANSFORMER_FINETUNED_LM = dict(HPARAMS_TRANSFORMER)


def read_channel(wav, channel):
    """A manifest row's audio: its segment of the conversation, on its
    side's channel when the file is stereo."""
    sig = read_audio(wav)
    if sig.ndim > 1:
        sig = sig[:, int(channel)]
    return sig


class SwitchboardASRBrain(ConformerASRBrain):
    """``ConformerASRBrain`` with the Switchboard transformer recipe's
    metric: the WER after ``normalize_words`` on both sides
    (``train.py:98-108``)."""

    def _score_words(self, ids, predicted, targets):
        self.wer_metric.append(ids, normalize_words(predicted),
                               normalize_words(targets))


def _dataset(path, hp, tokenizer):
    return librispeech_asr.make_dataset(path, hp, tokenizer,
                                        audio=read_channel,
                                        audio_keys=["wav", "channel"])


def _test_sets(hp, tokenizer, splits):
    """The test splits whose manifest was prepared."""
    out = {}
    for split in splits:
        path = os.path.join(hp["save_folder"], split + ".json")
        if os.path.exists(path):
            out[split] = _dataset(path, hp, tokenizer)
    return out


def _prepare(data_folder, output_folder, overrides, hparams):
    """What both builds share: the recipe's values, the manifests
    (prepared unless they exist), the tokenizer (trained on the train
    manifest unless its model file exists), an ``EpochCounter``, a
    ``FileTrainLogger`` on ``<output_folder>/train_log.txt``, a
    ``Checkpointer`` on ``<output_folder>/save``, and the train and valid
    datasets."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev")))
    run_on_main(prepare_switchboard, kwargs={
        "data_folder": hp["data_folder"],
        "save_folder": hp["save_folder"],
        "dev_conversations": hp["dev_conversations"],
    })
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="words",
        model_type=hp["token_type"], annotation_format="json",
    )
    return (hp, tokenizer, EpochCounter(hp["number_of_epochs"]),
            FileTrainLogger(hp["train_log"]), Checkpointer(hp["save_folder"]),
            _dataset(hp["train_json"], hp, tokenizer),
            _dataset(hp["valid_json"], hp, tokenizer))


def build_seq2seq(data_folder, output_folder, overrides=None, run_opts=None,
                  hparams=HPARAMS_SEQ2SEQ):
    """Everything ``run_seq2seq`` trains with: the manifests, the
    tokenizer, loaders of ``batch_size`` (the train loader shuffled), an
    ``EpochCounter``, and a ``librispeech_seq2seq.Seq2SeqBrain`` with a
    ``Checkpointer`` on ``<output_folder>/save``, a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt``, the tokenizer and the ``RNNLM`` of
    ``run_opts["lm_ckpt"]``.

    ``overrides`` replace values of ``hparams``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU) and ``lm_ckpt``.  Returns a dict with ``brain``,
    ``epoch_counter``, ``train_loader``, ``valid_loader``,
    ``test_loaders`` (by split) and ``hparams``."""
    hp, tokenizer, epoch_counter, logger, checkpointer, train, valid = (
        _prepare(data_folder, output_folder, overrides, hparams))
    hp.setdefault("wer_file", os.path.join(output_folder, "wer.txt"))
    run_opts = dict(run_opts or {})
    lm = librispeech_seq2seq.load_lm(hp, run_opts)
    brain = librispeech_seq2seq.Seq2SeqBrain(
        dict(hp, train_logger=logger, epoch_counter=epoch_counter),
        run_opts=run_opts, checkpointer=checkpointer, tokenizer=tokenizer,
        lm=lm)
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(train, batch_size=bs,
                                               shuffle=True),
            "valid_loader": SaveableDataLoader(valid, batch_size=bs),
            "test_loaders": {k: SaveableDataLoader(ds, batch_size=bs)
                             for k, ds in _test_sets(
                                 hp, tokenizer, ["eval2000"]).items()},
            "hparams": hp}


def build_transformer(data_folder, output_folder, overrides=None,
                      run_opts=None, hparams=HPARAMS_TRANSFORMER):
    """``build_seq2seq``'s parts for the transformer script
    (``HPARAMS_TRANSFORMER`` or ``HPARAMS_TRANSFORMER_FINETUNED_LM``): a
    ``SwitchboardASRBrain`` on ``librispeech_asr.make_loaders``' loaders,
    the ``TransformerLM`` of ``run_opts["lm_ckpt"]`` fused."""
    hp, tokenizer, epoch_counter, logger, checkpointer, train, valid = (
        _prepare(data_folder, output_folder, overrides, hparams))
    run_opts = dict(run_opts or {})
    lm = librispeech_asr.load_lm(hp, run_opts)
    brain = SwitchboardASRBrain(
        hp, seed=hp["seed"], run_opts=run_opts,
        hparams=dict(hp, train_logger=logger, epoch_counter=epoch_counter),
        checkpointer=checkpointer, tokenizer=tokenizer, lm=lm)
    train_loader, valid_loader, test_loaders = librispeech_asr.make_loaders(
        hp, train, valid, _test_sets(hp, tokenizer, hp["test_splits"]))
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": train_loader, "valid_loader": valid_loader,
            "test_loaders": test_loaders, "hparams": hp}


def run_seq2seq(data_folder, output_folder, overrides=None, run_opts=None,
                hparams=HPARAMS_SEQ2SEQ):
    """The seq2seq script's ``__main__``: ``build_seq2seq``, ``fit``
    (resuming from the latest checkpoint in ``<output_folder>/save``),
    then each prepared test split from the checkpoint with the best
    validation WER, the details in ``<output_folder>/wer.txt``.
    Arguments as for ``build_seq2seq``.  Returns the Brain;
    ``brain.test_stats`` holds each split's TEST stats."""
    parts = build_seq2seq(data_folder, output_folder, overrides, run_opts,
                          hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.test_stats = {}
    for split, loader in parts["test_loaders"].items():
        brain.evaluate(loader, min_key="WER")
        brain.test_stats[split] = dict(brain.stage_stats["TEST"])
    return brain


def run_transformer(data_folder, output_folder, overrides=None,
                    run_opts=None, hparams=HPARAMS_TRANSFORMER):
    """The transformer script's ``__main__``: ``build_transformer``, then
    ``librispeech_asr.fit_and_test`` (each split's details in
    ``<output_folder>/wer_<split>.txt``).  Arguments as for
    ``build_transformer``.  Returns the Brain."""
    return librispeech_asr.fit_and_test(build_transformer(
        data_folder, output_folder, overrides, run_opts, hparams))
