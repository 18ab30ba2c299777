"""The CommonVoice ASR recipes end to end, on the port: character-level
models over the manifests of ``common_voice_prepare.prepare_common_voice``
(one language folder: ``clips/`` and the tsv files).

- ``HPARAMS_SEQ2SEQ`` (``ASR/seq2seq/hparams/train.yaml``) and
  ``HPARAMS_SEQ2SEQ_{DE,EN,FR,IT,RW}`` (``train_<language>.yaml``: the
  same model; ``language`` and ``accented_letters``, true but for
  English, change the manifests): AISHELL-1's seq2seq recipe
  (``aishell_asr.CharSeq2SeqBrain``: Fbank 80 -> the CRDNN of 3 CNN
  blocks (128, 200, 256) and a bidirectional LSTM of 5 x 1024, DNN 2 x
  1024 -> a GRU decoder of 1024 with location attention; 0.3 CTC (K3/K4)
  + 0.7 NLL; Adadelta under NewBob on the greedy CTC CER) at 500 outputs,
  over the characters of the manifests' words, spaces included
  (``seq2seq/train.py:135-138``).
- ``HPARAMS_WAV2VEC_{EN,FR,IT,RW}`` (``ASR/seq2seq/hparams/
  train_<language>_with_wav2vec.yaml``, ``seq2seq/train_with_wav2vec.py``):
  the seq2seq recipe with the wav2vec 2.0 base encoder in place of the
  Fbank and the CRDNN (``CharSeq2SeqBrain`` with ``encoder`` "wav2vec":
  the wave -> ``W2VLatentExtractor`` -> ``EncoderWrapper``, 12 layers at d
  768, called without ``wav_lens`` -> the location-attention GRU decoder
  of 1024 (attention 512), ``ctc_lin`` and ``seq_lin`` on the 768-wide
  states; 0.3 CTC (K3/K4) + 0.7 NLL; Adadelta under NewBob on the greedy
  CTC CER; float32, the yamls set no precision) at 500 outputs over the
  same characters.  ``build_wav2vec`` raises when the inventory passes
  them, naming its size (the JAX script never checks: a label past the
  heads is an index past the CTC head's width).
- ``HPARAMS_TRANSFORMER_FR`` (``ASR/transformer/hparams/train_fr.yaml``):
  AISHELL-1's ``conformer_small.yaml`` recipe (``aishell_asr.
  CharCTCBrain``: d 144, 4 heads, 12 + 4 layers, d_ffn 1024; 0.3 CTC +
  0.7 KL, Noam, accumulation 2, bf16, bucketed dynamic batches) at 4300
  outputs, over the words' characters without spaces.  The yaml's
  comments ("~4230 Mandarin chars") and the script's docstring are
  AISHELL-1's; its numbers are the ones copied.
- ``HPARAMS_TRANSDUCER_FR`` (``ASR/transducer/hparams/train_fr.yaml``):
  ``CharTransducerBrain``, the CRDNN transducer (Fbank 40 with deltas,
  120 features -> the CRDNN of CNN (128, 256) and a bidirectional LiGRU
  of 4 x 512, DNN 2 x 512 -> ``enc_lin`` 256; an embedding of 256 -> a
  GRU of 256 -> ``dec_lin`` 256; the tanh joint -> 40 outputs; the RNN-T
  loss on K8/K9), Adadelta under NewBob on the validation PER from the
  greedy search, the test at beam 4 (``state_beam``/``expand_beam``
  2.3), the best checkpoint by PER.

The characters of the seq2seq and conformer recipes span all three
splits, with ``<blank>`` at 0 and ``<bos>``/``<eos>`` at the yamls' 1 and
2 (``aishell_asr.make_datasets``; JAX appends them after the characters,
the fault recorded for AISHELL-1).  Differences from the JAX transducer
script (``transducer/train.py``):

- Its label encoder reads the train split alone (l.189-195), so a
  character that only the dev or test split holds raises there; the port
  reads train, then dev and test, so the train characters keep JAX's
  indices and the others follow.
- ``output_neurons`` is 40 ("39 phonemes + blank"), but the targets are
  the words' characters (l.168), accents and all; a corpus whose
  inventory passes 40 gives ids past the embedding's table, which Flax
  turns to NaN rows without a word.  The port's ``build_transducer``
  raises instead, naming the inventory's size.
- NewBob is registered with the checkpointer, so a resumed run continues
  its annealing (the JAX scripts register no schedule).

``run_seq2seq``, ``run_wav2vec``, ``run_transformer`` and
``run_transducer`` train,
validate, keep the best checkpoint (a killed run resumes) and test from
it.  The yamls' values are the dicts; ``overrides`` replace any of them,
e.g. toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import commonvoice_asr as cv
    cv.run_transducer("/data/cv/fr", "results/transducer_fr",
                      overrides={"rnn_layers": 1, "rnn_neurons": 16, ...},
                      run_opts={"device": "cpu"})
"""

import os

import numpy as np
import torch

from ..asr import W2V_BASE, CRDNN_TRANSDUCER, CRDNNTransducerBrain
from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..dataio.encoder import CTCTextEncoder
from ..nnet.schedulers import NewBobScheduler
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from . import aishell_asr
from .common import recipe_hparams
from .common_voice_prepare import prepare_common_voice

__all__ = ["HPARAMS_SEQ2SEQ", "HPARAMS_SEQ2SEQ_DE", "HPARAMS_SEQ2SEQ_EN",
           "HPARAMS_SEQ2SEQ_FR", "HPARAMS_SEQ2SEQ_IT", "HPARAMS_SEQ2SEQ_RW",
           "HPARAMS_WAV2VEC_EN", "HPARAMS_WAV2VEC_FR", "HPARAMS_WAV2VEC_IT",
           "HPARAMS_WAV2VEC_RW", "WAV2VEC_YAMLS", "HPARAMS_TRANSFORMER_FR",
           "HPARAMS_TRANSDUCER_FR", "SEQ2SEQ_YAMLS", "CharTransducerBrain",
           "transducer_datasets", "build_seq2seq", "build_wav2vec",
           "build_transformer", "build_transducer", "run_seq2seq",
           "run_wav2vec", "run_transformer", "run_transducer"]

# the keys of every CommonVoice yaml that say which corpus it reads
_CORPUS = dict(accented_letters=False, language="en",
               duration_threshold=10.0)

# recipes/CommonVoice/ASR/seq2seq/hparams/train.yaml: AISHELL-1's seq2seq
# values at 500 outputs
HPARAMS_SEQ2SEQ = dict(aishell_asr.HPARAMS_SEQ2SEQ, vocab_size=500,
                       **_CORPUS)
# train_{de,en,fr,it,rw}.yaml: English folds the accents, the others keep
# them; nothing else differs but the output folder
HPARAMS_SEQ2SEQ_DE = dict(HPARAMS_SEQ2SEQ, language="de",
                          accented_letters=True)
HPARAMS_SEQ2SEQ_EN = dict(HPARAMS_SEQ2SEQ)
HPARAMS_SEQ2SEQ_FR = dict(HPARAMS_SEQ2SEQ, language="fr",
                          accented_letters=True)
HPARAMS_SEQ2SEQ_IT = dict(HPARAMS_SEQ2SEQ, language="it",
                          accented_letters=True)
HPARAMS_SEQ2SEQ_RW = dict(HPARAMS_SEQ2SEQ, language="rw",
                          accented_letters=True)
SEQ2SEQ_YAMLS = {"train.yaml": HPARAMS_SEQ2SEQ,
                 "train_de.yaml": HPARAMS_SEQ2SEQ_DE,
                 "train_en.yaml": HPARAMS_SEQ2SEQ_EN,
                 "train_fr.yaml": HPARAMS_SEQ2SEQ_FR,
                 "train_it.yaml": HPARAMS_SEQ2SEQ_IT,
                 "train_rw.yaml": HPARAMS_SEQ2SEQ_RW}

# recipes/CommonVoice/ASR/seq2seq/hparams/train_fr_with_wav2vec.yaml (the
# JAX Brain's fp32 and clip 5; EncoderWrapper's dropout 0.1;
# ``vocab_size`` is the yaml's output_neurons)
HPARAMS_WAV2VEC_FR = dict(
    W2V_BASE,
    **dict(_CORPUS, language="fr", accented_letters=True),
    encoder="wav2vec",
    seed=1234,
    sample_rate=16000,
    batch_size=12,
    number_of_epochs=25,
    lr=1.0,
    ctc_weight=0.3,
    blank_index=0,
    bos_index=1,
    eos_index=2,
    emb_size=128,
    dec_neurons=1024,
    attn_dim=512,
    vocab_size=500,
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
# train_{en,it,rw}_with_wav2vec.yaml: the language and its accents apart,
# the same values
HPARAMS_WAV2VEC_EN = dict(HPARAMS_WAV2VEC_FR, language="en",
                          accented_letters=False)
HPARAMS_WAV2VEC_IT = dict(HPARAMS_WAV2VEC_FR, language="it")
HPARAMS_WAV2VEC_RW = dict(HPARAMS_WAV2VEC_FR, language="rw")
WAV2VEC_YAMLS = {f"train_{lang}_with_wav2vec.yaml":
                 globals()[f"HPARAMS_WAV2VEC_{lang.upper()}"]
                 for lang in ("en", "fr", "it", "rw")}

# recipes/CommonVoice/ASR/transformer/hparams/train_fr.yaml: AISHELL-1's
# conformer_small.yaml values (its comments name AISHELL-1's corpus too)
HPARAMS_TRANSFORMER_FR = dict(aishell_asr.HPARAMS_CONFORMER,
                              **dict(_CORPUS, language="fr",
                                     accented_letters=True))

# recipes/CommonVoice/ASR/transducer/hparams/train_fr.yaml (the JAX
# Brain's clip 5; ``vocab_size`` is the yaml's output_neurons; the
# embedding and the prediction GRU are joint_dim wide)
HPARAMS_TRANSDUCER_FR = dict(
    CRDNN_TRANSDUCER,
    **dict(_CORPUS, language="fr", accented_letters=True),
    seed=1234,
    n_mels=40,
    deltas=True,
    batch_size=8,
    number_of_epochs=50,
    lr=1.0,
    precision="bf16",
    blank_index=0,
    vocab_size=40,
    cnn_blocks=2,
    cnn_channels=(128, 256),
    inter_layer_pooling_size=(2, 2),
    rnn_layers=4,
    rnn_neurons=512,
    dnn_blocks=2,
    dnn_neurons=512,
    joint_dim=256,
    dec_emb_dim=256,
    dec_neurons=256,
    dropout=0.15,
    update_until_epoch=3,
    augmentation=None,
    valid_beam_size=1,
    beam_size=4,
    state_beam=2.3,
    expand_beam=2.3,
    rho=0.95,
    eps=1e-8,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)


def _prepare(hp):
    """``prepare_common_voice`` with a recipe's values."""
    prepare_common_voice(
        hp["data_folder"], hp["save_folder"],
        train_tsv_file=hp.get("train_tsv_file"),
        dev_tsv_file=hp.get("dev_tsv_file"),
        test_tsv_file=hp.get("test_tsv_file"),
        accented_letters=hp["accented_letters"], language=hp["language"],
        duration_threshold=hp["duration_threshold"])


# the seq2seq script's characters keep the spaces
# (``seq2seq/train.py:135-138``); the transformer script's drop them
# (``transformer/train.py:150-153``)
SEQ2SEQ_CORPUS = aishell_asr.Corpus(_prepare, "words", list)
TRANSFORMER_CORPUS = aishell_asr.Corpus(
    _prepare, "words", aishell_asr.AISHELL.chars)


def build_seq2seq(data_folder, output_folder, overrides=None, run_opts=None,
                  hparams=HPARAMS_SEQ2SEQ):
    """``aishell_asr.build_seq2seq`` on a CommonVoice language folder
    (``hparams``: ``HPARAMS_SEQ2SEQ`` or a language's dict).  Returns
    its dict."""
    return aishell_asr.build_seq2seq(data_folder, output_folder, overrides,
                                     run_opts, hparams, SEQ2SEQ_CORPUS)


def build_wav2vec(data_folder, output_folder, overrides=None, run_opts=None,
                  hparams=HPARAMS_WAV2VEC_FR):
    """``build_seq2seq``'s parts for a wav2vec yaml (``hparams``: one of
    ``WAV2VEC_YAMLS``' dicts).  Raises ``ValueError`` when the inventory
    (the blank, ``<bos>``, ``<eos>`` and the characters) passes
    ``vocab_size`` (the yaml's ``output_neurons``)."""
    parts = build_seq2seq(data_folder, output_folder, overrides, run_opts,
                          hparams)
    n, V = len(parts["label_encoder"]), parts["hparams"]["vocab_size"]
    if n > V:
        raise ValueError(f"{n} labels (the blank, <bos>, <eos> and the "
                         f"characters) pass output_neurons {V}")
    return parts


def build_transformer(data_folder, output_folder, overrides=None,
                      run_opts=None, hparams=HPARAMS_TRANSFORMER_FR):
    """``aishell_asr.build_transformer`` on a CommonVoice language folder.
    Returns its dict."""
    return aishell_asr.build_transformer(data_folder, output_folder,
                                         overrides, run_opts, hparams,
                                         TRANSFORMER_CORPUS)


def run_seq2seq(data_folder, output_folder, overrides=None, run_opts=None,
                hparams=HPARAMS_SEQ2SEQ):
    """The seq2seq script's ``__main__``: ``build_seq2seq``, ``fit``, then
    the test from the best CER.  Returns the Brain."""
    return aishell_asr.run_seq2seq(data_folder, output_folder, overrides,
                                   run_opts, hparams, SEQ2SEQ_CORPUS)


def run_wav2vec(data_folder, output_folder, overrides=None, run_opts=None,
                hparams=HPARAMS_WAV2VEC_FR):
    """``seq2seq/train_with_wav2vec.py``'s ``__main__``: ``build_wav2vec``,
    ``fit``, then the test from the best CER.  Returns the Brain."""
    return aishell_asr.fit_and_test(build_wav2vec(
        data_folder, output_folder, overrides, run_opts, hparams))


def run_transformer(data_folder, output_folder, overrides=None,
                    run_opts=None, hparams=HPARAMS_TRANSFORMER_FR):
    """The transformer script's ``__main__``: ``build_transformer``,
    ``fit``, then the test from the best CER.  Returns the Brain."""
    return aishell_asr.run_transformer(data_folder, output_folder,
                                       overrides, run_opts, hparams,
                                       TRANSFORMER_CORPUS)


class CharTransducerBrain(CRDNNTransducerBrain):
    """The CommonVoice transducer script's ``Transducer`` Brain
    (``transducer/train.py:27-175``): ``CRDNNTransducerBrain``'s forward
    and RNN-T loss (K8/K9 on the card), with ``torch.optim.Adadelta(rho,
    eps)`` at ``self.lr`` (``hparams["lr"]``, then NewBob's on the
    validation PER, registered with the checkpointer as
    ``"lr_annealing"``; no Noam).  Outside training the search decodes the
    batch's encoder side: greedy at VALID (``valid_beam_size`` 1), the
    beam at TEST (``beam_size`` 4, ``state_beam``/``expand_beam``), and
    ``self.wer_metric`` (an ``ErrorRateStats``) scores its characters
    through ``label_encoder`` as the PER.  ``on_stage_end`` at VALID
    anneals, logs and keeps the checkpoint with the lowest PER; at TEST
    it logs and writes ``hparams["per_file"]`` (when given).  Arguments as
    for ``CRDNNTransducerBrain``, with the keys of
    ``HPARAMS_TRANSDUCER_FR`` and ``label_encoder``.

    Example
    -------
    >>> cfg = dict(HPARAMS_TRANSDUCER_FR, n_mels=8, cnn_channels=(2, 2),
    ...     rnn_layers=1, rnn_neurons=4, dnn_neurons=4, vocab_size=6,
    ...     dec_emb_dim=4, dec_neurons=4, joint_dim=4, precision="fp32")
    >>> brain = CharTransducerBrain(cfg, run_opts={"device": "cpu"},
    ...                             hparams=cfg)
    >>> type(brain.optimizer).__name__, brain.lr
    ('Adadelta', 1.0)
    """

    SEARCH_STAGES = (Stage.VALID, Stage.TEST)

    def __init__(self, config, seed=0, run_opts=None, hparams=None,
                 checkpointer=None, label_encoder=None):
        c = dict(HPARAMS_TRANSDUCER_FR, **config)

        def opt_class(params):
            return torch.optim.Adadelta(params, lr=c["lr"], rho=c["rho"],
                                        eps=c["eps"], weight_decay=0)

        super().__init__(c, opt_class=opt_class, seed=seed,
                         run_opts=run_opts, hparams=hparams,
                         checkpointer=checkpointer)
        self.label_encoder = label_encoder

    def _init_schedule(self, c, checkpointer):
        """NewBob on the validation PER, registered as ``"lr_annealing"``."""
        self.lr_annealing = NewBobScheduler(
            c["lr"], annealing_factor=c["annealing_factor"],
            improvement_threshold=c["improvement_threshold"],
            patient=c["patient"])
        if (checkpointer is not None
                and "lr_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("lr_annealing", self.lr_annealing)

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """Nothing: the rate changes once an epoch."""

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch; outside training a new PER and the
        stage's searcher."""
        if epoch is not None:
            self.epoch = epoch
        if stage != Stage.TRAIN:
            self.wer_metric = ErrorRateStats()
            beam = (self.config["valid_beam_size"] if stage == Stage.VALID
                    else self.config["beam_size"])
            self.searcher = self.model.make_searcher(beam_size=beam)

    def _score_hyps(self, hyps, batch):
        """The real rows' characters against their targets
        (``transducer/train.py:63-72``)."""
        real = int(batch["batch_mask"].sum())
        self.wer_metric.append(
            [str(i) for i in range(real)], hyps[:real],
            batch["tokens"][:real].cpu().numpy().tolist(),
            target_len=batch["tokens_lens"][:real].cpu().numpy(),
            ind2lab=self.label_encoder.decode_ndim)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """NewBob, the log line and the keep-best checkpoint at VALID; the
        log line and the PER file at TEST."""
        if stage == Stage.TRAIN:
            return
        per = self.wer_metric.summarize("error_rate")
        stats = {"loss": stage_loss, "PER": per}
        self.stage_stats[stage.name] = stats
        train_logger = getattr(self.hparams, "train_logger", None)
        if stage == Stage.VALID:
            _, self.lr = self.lr_annealing(per)
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats=stats)
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(meta={"PER": per},
                                                     min_keys=["PER"])
            return
        if train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats)
        per_file = getattr(self.hparams, "per_file", None)
        if per_file is not None:
            with open(per_file, "w") as f:
                self.wer_metric.write_stats(f)


def transducer_datasets(hparams, corpus=SEQ2SEQ_CORPUS):
    """The transducer script's datasets (``transducer/train.py:165-196``):
    ``sig``, and the labels ``corpus.chars`` gives of ``corpus.text_key``
    (CommonVoice's: the characters of ``words``, spaces included) as
    ``tokens`` and ``tokens_blank`` = [blank] + tokens through a
    ``CTCTextEncoder``: the train split's labels with ``<blank>`` at 0, as
    JAX builds it, then those that only dev or test hold (JAX reads train
    alone); loaded from ``<save_folder>/label_encoder.txt`` when it
    exists.  Returns ``(datasets by split, encoder)``."""
    label_encoder = CTCTextEncoder()
    blank = hparams["blank_index"]
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(corpus.chars, takes=corpus.text_key,
                            provides="char_list")

        def tokens_pipeline(char_list):
            tokens = label_encoder.encode_sequence(char_list)
            return (np.asarray(tokens, np.int64),
                    np.asarray([blank] + tokens, np.int64))

        ds.add_dynamic_item(tokens_pipeline, takes="char_list",
                            provides=["tokens", "tokens_blank"])
        ds.set_output_keys(["id", "sig", "tokens", "tokens_blank"])
        datasets[split] = ds
    path = os.path.join(hparams["save_folder"], "label_encoder.txt")
    label_encoder.load_or_create(
        path=path, from_didatasets=[datasets["train"]],
        output_key="char_list", sequence_input=True,
        special_labels={"blank_label": "<blank>"})
    n_train = len(label_encoder)
    for split in ("valid", "test"):
        label_encoder.update_from_didataset(datasets[split], "char_list",
                                            sequence_input=True)
    if len(label_encoder) > n_train:
        label_encoder.save(path)
    return datasets, label_encoder


def build_transducer(data_folder, output_folder, overrides=None,
                     run_opts=None, hparams=HPARAMS_TRANSDUCER_FR,
                     corpus=SEQ2SEQ_CORPUS, brain_class=CharTransducerBrain):
    """Everything ``run_transducer`` trains with, built as the transducer
    script's ``__main__`` builds it: the manifests (prepared unless they
    exist), the datasets and label encoder (``transducer_datasets``),
    loaders of ``batch_size`` (the train loader shuffled), an
    ``EpochCounter`` and a ``CharTransducerBrain`` with a
    ``Checkpointer`` on ``<output_folder>/save``, a ``FileTrainLogger``
    on ``<output_folder>/train_log.txt`` and the PER file
    ``<output_folder>/per.txt``.  Raises ``ValueError`` when the
    inventory passes ``vocab_size`` (the yaml's ``output_neurons``).

    ``overrides`` replace values of ``hparams``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU); ``corpus`` (an ``aishell_asr.Corpus``) prepares the manifests
    ``train``, ``dev`` and ``test`` and reads their labels, and
    ``brain_class`` (a ``CharTransducerBrain``) trains.
    Returns a dict with ``brain``, ``epoch_counter``, ``train_loader``,
    ``valid_loader``, ``test_loader``, ``label_encoder`` and
    ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev"),
        ("test_json", "test")))
    hp.setdefault("per_file", os.path.join(output_folder, "per.txt"))
    run_on_main(corpus.prepare, args=(hp,))
    datasets, label_encoder = transducer_datasets(hp, corpus)
    if len(label_encoder) > hp["vocab_size"]:
        raise ValueError(
            f"{len(label_encoder)} labels (the blank and the labels of "
            f"the manifests) past the {hp['vocab_size']} outputs "
            "(output_neurons); set vocab_size to at least the inventory")
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = brain_class(
        hp, seed=hp["seed"], run_opts=run_opts,
        hparams=dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                     epoch_counter=epoch_counter),
        checkpointer=Checkpointer(hp["save_folder"]),
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


def run_transducer(data_folder, output_folder, overrides=None, run_opts=None,
                   hparams=HPARAMS_TRANSDUCER_FR, corpus=SEQ2SEQ_CORPUS,
                   brain_class=CharTransducerBrain):
    """The transducer script's ``__main__``: ``build_transducer``,
    ``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` at beam 4 from the checkpoint with the
    lowest validation PER.  Arguments as for ``build_transducer``.
    Returns the Brain (``brain.stage_stats`` holds the last VALID and
    TEST loss and PER)."""
    parts = build_transducer(data_folder, output_folder, overrides, run_opts,
                             hparams, corpus, brain_class)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="PER")
    return brain
