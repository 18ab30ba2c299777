"""The wav2vec 2.0 + CTC fine-tuning recipes end to end, on the port:
LibriSpeech ``ASR/CTC/train_with_wav2vec.py``, DVoice
``train_with_wav2vec2.py``, CommonVoice, AISHELL-1 and Switchboard
``ASR/CTC/train_with_wav2vec.py``, one script with another ``prepare``
call, and their 15 yamls.

A corpus's manifests (``CORPORA``: the preparation, the manifests' names,
the text field, the audio reader) -> the characters of each transcript
(spaces included) through a ``CTCTextEncoder`` of all three splits with
``<blank>`` at 0 -> ``ASR.fit``: the raw wave -> ``W2VLatentExtractor``
(7 convolutions of 512) -> ``EncoderWrapper`` (12 pre-norm layers at d
768, 8 heads, d_ffn 3072; no mask, no key padding) -> ``VanillaNN`` (2 x
1024, leaky relu) -> ``Linear`` to ``output_neurons`` -> ``log_softmax``
-> CTC on the kernels K3/K4 (``mean`` over the relative ``sig_lens``);
Adadelta (rho 0.95, eps 1e-8) at the NewBob-annealed rate; off training,
the greedy CTC decode's CER on characters and WER on the joined words;
checkpoints keep the best WER -> ``evaluate(min_key="WER")`` writes
``wer_file``.  A killed run resumes from its latest checkpoint when
``run`` is called again on the same output folder.

The dicts (``YAMLS`` maps each yaml to its dict) hold the yamls' values
(the files are not read) and name their corpus; ``overrides`` replace any
value, e.g. toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import wav2vec_ctc
    wav2vec_ctc.run("/data/DVOICE/darija", "results/dar",
                    hparams=wav2vec_ctc.HPARAMS_DVOICE_DAR,
                    run_opts={"device": "cpu"},
                    overrides={"latent_channels": (32, 32), ...})

Differences from the JAX scripts:

- They never cast to the LibriSpeech yamls' bf16 (the modules run in the
  input's float32); the port runs the Brain's ``precision``, the
  log-softmax and the loss in float32.
- A character inventory past ``output_neurons`` gives labels past the
  CTC head's width, which the JAX scripts do not check; ``build`` raises,
  naming the inventory's size.
- Switchboard's manifest rows name a segment of a stereo SPHERE file and
  its ``channel``; the JAX script reads the segment whole, so a (B, N, 2)
  batch reaches the extractor, which takes the two sides as its first
  convolution's input channels.  The port reads the row's channel, as its
  other Switchboard recipes do (``switchboard_asr.read_channel``).  The
  Switchboard yaml names a ``test.json`` that ``switchboard_prepare``
  never writes; the port tests on ``eval2000.json``.
- NewBob is registered with the checkpointer (the JAX scripts register no
  schedule, so their resumed runs restart the annealing).

Copied as they are: the encoder runs without ``wav_lens``, so its
attention reads the padded frames of the shorter clips of a batch
(``train_with_wav2vec.py:41``).
"""

import collections

import numpy as np
import torch

from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..dataio.encoder import CTCTextEncoder
from ..decoders.ctc import ctc_greedy_decode
from ..lobes.models.VanillaNN import VanillaNN
from ..lobes.models.wav2vec import EncoderWrapper, W2VLatentExtractor
from ..nnet.linear import Linear
from ..nnet.losses import ctc_loss
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from .aishell_prepare import prepare_aishell
from .common import NewBobBrain, at_least_f32, recipe_hparams
from .common_voice_prepare import prepare_common_voice
from .dvoice_prepare import prepare_dvoice
from .librispeech_asr import prepare_librispeech
from .switchboard_asr import read_channel
from .switchboard_prepare import prepare_switchboard
from .wav2vec_pretrain import KERNEL_SIZES, STRIDES, init_wav2vec

__all__ = ["HPARAMS_LIBRISPEECH", "HPARAMS_LIBRISPEECH_SB",
           "HPARAMS_DVOICE_AMH", "HPARAMS_DVOICE_DAR", "HPARAMS_DVOICE_FON",
           "HPARAMS_DVOICE_MULTI", "HPARAMS_DVOICE_SW", "HPARAMS_DVOICE_WOL",
           "HPARAMS_COMMONVOICE_DE", "HPARAMS_COMMONVOICE_EN",
           "HPARAMS_COMMONVOICE_FR", "HPARAMS_COMMONVOICE_IT",
           "HPARAMS_COMMONVOICE_RW", "HPARAMS_AISHELL",
           "HPARAMS_SWITCHBOARD", "YAMLS", "Corpus", "CORPORA",
           "build_modules", "ASR", "make_datasets", "build", "run"]

# recipes/LibriSpeech/ASR/CTC/hparams/train_en_with_wav2vec.yaml (with the
# JAX Brain's clip 5.0 and EncoderWrapper's dropout 0.1 and the extractor's
# kernels and strides, which the yaml leaves as they are; its latent_dim is
# the last of latent_channels, and its sample_rate goes unread: nothing
# resamples)
HPARAMS_LIBRISPEECH = dict(
    seed=1986,
    corpus="librispeech",
    train_splits=["train-clean-100", "train-clean-360", "train-other-500"],
    dev_splits=["dev-clean"],
    test_splits=["test-clean"],
    batch_size=6,
    number_of_epochs=1,
    lr=0.9,
    blank_index=0,
    precision="bf16",
    embedding_dim=768,
    encoder_layers=12,
    nhead=8,
    d_ffn=3072,
    dnn_blocks=2,
    dnn_neurons=1024,
    output_neurons=29,
    latent_channels=(512,) * 7,
    kernel_sizes=KERNEL_SIZES,
    strides=STRIDES,
    encoder_dropout=0.1,
    rho=0.95,
    eps=1e-8,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)

# train_sb_wav2vec.yaml: the same values (its output folder apart)
HPARAMS_LIBRISPEECH_SB = dict(HPARAMS_LIBRISPEECH)

# recipes/DVoice/ASR/CTC/hparams/train_<language>_with_wav2vec.yaml: the
# six are equal but for their folders; float32, 76 outputs
_DVOICE = dict(
    {k: v for k, v in HPARAMS_LIBRISPEECH.items()
     if k not in ("train_splits", "dev_splits", "test_splits")},
    seed=1234, corpus="dvoice", batch_size=8, number_of_epochs=30, lr=1.0,
    precision="fp32", output_neurons=76)
HPARAMS_DVOICE_AMH = dict(_DVOICE)
HPARAMS_DVOICE_DAR = dict(_DVOICE)
HPARAMS_DVOICE_FON = dict(_DVOICE)
HPARAMS_DVOICE_MULTI = dict(_DVOICE)
HPARAMS_DVOICE_SW = dict(_DVOICE)
HPARAMS_DVOICE_WOL = dict(_DVOICE)

# recipes/CommonVoice/ASR/CTC/hparams/train_<language>_with_wav2vec.yaml:
# DVoice's values on a CommonVoice language folder (the tsv files at
# <data_folder>/<split>.tsv)
_CV = dict(_DVOICE, corpus="commonvoice")
HPARAMS_COMMONVOICE_DE = dict(_CV, accented_letters=True, language="de")
HPARAMS_COMMONVOICE_EN = dict(_CV, accented_letters=False, language="en")
HPARAMS_COMMONVOICE_FR = dict(_CV, accented_letters=True, language="fr")
HPARAMS_COMMONVOICE_IT = dict(_CV, accented_letters=True, language="it")
HPARAMS_COMMONVOICE_RW = dict(_CV, accented_letters=True, language="rw")

# recipes/AISHELL-1/ASR/CTC/hparams/train_with_wav2vec.yaml
HPARAMS_AISHELL = dict(_DVOICE, corpus="aishell", output_neurons=5000)

# recipes/Switchboard/ASR/CTC/hparams/train_with_wav2vec.yaml
HPARAMS_SWITCHBOARD = dict(_DVOICE, corpus="switchboard",
                           dev_conversations=20)

YAMLS = {
    "LibriSpeech/ASR/CTC/hparams/train_en_with_wav2vec.yaml":
        HPARAMS_LIBRISPEECH,
    "LibriSpeech/ASR/CTC/hparams/train_sb_wav2vec.yaml":
        HPARAMS_LIBRISPEECH_SB,
    **{f"DVoice/ASR/CTC/hparams/train_{lang}_with_wav2vec.yaml":
       globals()[f"HPARAMS_DVOICE_{lang.upper()}"]
       for lang in ("amh", "dar", "fon", "multi", "sw", "wol")},
    **{f"CommonVoice/ASR/CTC/hparams/train_{lang}_with_wav2vec.yaml":
       globals()[f"HPARAMS_COMMONVOICE_{lang.upper()}"]
       for lang in ("de", "en", "fr", "it", "rw")},
    "AISHELL-1/ASR/CTC/hparams/train_with_wav2vec.yaml": HPARAMS_AISHELL,
    "Switchboard/ASR/CTC/hparams/train_with_wav2vec.yaml":
        HPARAMS_SWITCHBOARD,
}

# What a corpus gives the recipe: ``prepare(hp)`` writes the manifests
# (unless they exist), ``manifests(hp)`` names the train, valid and test
# ones (under ``save_folder``, without ".json"), ``text_key`` is their text
# field, and ``audio``/``audio_keys`` read a row's wave.
Corpus = collections.namedtuple("Corpus",
                                "prepare manifests text_key audio audio_keys")

CORPORA = {
    "librispeech": Corpus(
        lambda hp: prepare_librispeech(
            hp["data_folder"], hp["save_folder"],
            tr_splits=hp["train_splits"], dev_splits=hp["dev_splits"],
            te_splits=hp["test_splits"], merge_lst=hp["train_splits"],
            merge_name="train.json"),
        lambda hp: ("train", hp["dev_splits"][0], hp["test_splits"][0]),
        "words", read_audio, "wav"),
    "dvoice": Corpus(
        lambda hp: prepare_dvoice(hp["data_folder"], hp["save_folder"]),
        lambda hp: ("train", "dev", "test"), "words", read_audio, "wav"),
    "commonvoice": Corpus(
        lambda hp: prepare_common_voice(
            hp["data_folder"], hp["save_folder"],
            accented_letters=hp["accented_letters"],
            language=hp["language"]),
        lambda hp: ("train", "dev", "test"), "words", read_audio, "wav"),
    "aishell": Corpus(
        lambda hp: prepare_aishell(hp["data_folder"], hp["save_folder"]),
        lambda hp: ("train", "dev", "test"), "transcript", read_audio,
        "wav"),
    "switchboard": Corpus(
        lambda hp: prepare_switchboard(
            hp["data_folder"], hp["save_folder"],
            dev_conversations=hp["dev_conversations"]),
        lambda hp: ("train", "dev", "eval2000"), "words", read_channel,
        ["wav", "channel"]),
}


def build_modules(hparams, seed=0):
    """The recipe's modules (``extractor``, ``encoder`` without
    ``mask_emb``, ``enc_dnn``, ``ctc_lin``) with
    ``wav2vec_pretrain.init_wav2vec``'s weights."""
    hp = dict(HPARAMS_LIBRISPEECH, **hparams)
    extractor = W2VLatentExtractor(hp["latent_channels"], hp["kernel_sizes"],
                                   hp["strides"])
    return init_wav2vec({
        "extractor": extractor,
        "encoder": EncoderWrapper(
            extractor.output_size, hp["embedding_dim"], hp["encoder_layers"],
            hp["nhead"], hp["d_ffn"], hp["encoder_dropout"]),
        "enc_dnn": VanillaNN(hp["embedding_dim"], hp["dnn_blocks"],
                             hp["dnn_neurons"]),
        "ctc_lin": Linear(hp["dnn_neurons"], hp["output_neurons"]),
    }, seed)


class ASR(NewBobBrain):
    """The scripts' ``ASR`` Brain (``train_with_wav2vec.py:29-112``).

    ``compute_forward``: the wave in the activation dtype -> latents ->
    the encoder (no ``wav_lens``, no mask) -> ``enc_dnn`` -> ``ctc_lin`` ->
    float32 ``log_softmax``.  ``compute_objectives``: ``ctc_loss``
    (``mean``) with the lengths ``sig_lens * batch_mask`` and
    ``tokens_lens * batch_mask``, on K3/K4 on the card (``set_kernels``);
    outside training, the greedy decode of the real rows scored against
    their targets through ``label_encoder``: the CER on characters, the
    WER on the joined characters split at the spaces.

    The optimizer is ``torch.optim.Adadelta(rho, eps, weight_decay=0)``
    (optax ``adadelta``) after the Brain's clip, at ``self.lr``: ``lr``,
    then what NewBob gives the validation WER (``NewBobBrain``: registered
    as ``"lr_annealing"``, the logger's line, checkpoints keeping the
    lowest WER).  At TEST the logger gets the loaded epoch and the stats,
    and the WER details go to ``hparams["wer_file"]`` when set.  The last
    stats of each stage are in ``self.stage_stats``.

    Example
    -------
    >>> hp = dict(HPARAMS_DVOICE_DAR, latent_channels=(8, 8),
    ...           embedding_dim=8, encoder_layers=1, nhead=2, d_ffn=16,
    ...           dnn_neurons=8, output_neurons=5)
    >>> brain = ASR(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(2, 1600)).astype(np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "tokens": np.array([[1, 2], [3, 0]]),
    ...     "tokens_lens": np.array([1.0, 0.5], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    metric = "WER"

    def __init__(self, hparams, run_opts=None, checkpointer=None,
                 label_encoder=None):
        hp = dict(HPARAMS_LIBRISPEECH, **hparams)
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adadelta(params, lr=hp["lr"], rho=hp["rho"],
                                        eps=hp["eps"], weight_decay=0)

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        self.label_encoder = label_encoder
        self.use_kernels = True

    def set_kernels(self, flag=True):
        """Run the CTC loss on the kernels (True) or on its plain
        recursions (False)."""
        self.use_kernels = bool(flag)
        return self

    def compute_forward(self, batch, stage):
        """Returns the (B, T, output_neurons) float32 log-probs."""
        m = self.modules
        latents = m.extractor(batch["sig"].to(self.dtype))
        x = m.enc_dnn(m.encoder(latents)["embeddings"])
        return torch.log_softmax(at_least_f32(m.ctc_lin(x)), -1)

    def compute_objectives(self, predictions, batch, stage):
        """The CTC loss; outside training, the greedy CER and WER."""
        mask = batch["batch_mask"]
        loss = ctc_loss(predictions, batch["tokens"],
                        batch["sig_lens"] * mask, batch["tokens_lens"] * mask,
                        blank_index=self.hparams.blank_index,
                        use_kernels=self.use_kernels)
        if stage != Stage.TRAIN and hasattr(self, "wer_metric"):
            self.score(predictions, batch)
        return loss

    def score(self, predictions, batch):
        """Append the batch's greedy hypotheses to the CER and WER
        (``train_with_wav2vec.py:51-84``)."""
        real = int(batch["batch_mask"].sum())
        hyps = ctc_greedy_decode(predictions, batch["sig_lens"],
                                 blank_id=self.hparams.blank_index)[:real]
        targets = batch["tokens"][:real].cpu().numpy().tolist()
        t_lens = batch["tokens_lens"][:real].cpu().numpy()
        U = len(targets[0]) if targets else 0
        targets = [t[:int(round(float(l) * U))]
                   for t, l in zip(targets, t_lens)]
        ids = [str(i) for i in range(real)]
        decode = self.label_encoder.decode_ndim
        self.cer_metric.append(ids, hyps, targets, ind2lab=decode)
        self.wer_metric.append(ids, ["".join(decode(h)).split() for h in hyps],
                               ["".join(decode(t)).split() for t in targets])

    def on_stage_start(self, stage, epoch=None):
        """New WER and CER metrics outside training."""
        if stage != Stage.TRAIN:
            self.wer_metric = ErrorRateStats()
            self.cer_metric = ErrorRateStats()

    def summarize_metric(self):
        """The stage's WER."""
        return self.wer_metric.summarize("error_rate")

    def extra_stats(self):
        """The stage's CER."""
        return {"CER": self.cer_metric.summarize("error_rate")}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """``NewBobBrain``'s; at TEST the logger's line and the WER file."""
        super().on_stage_end(stage, stage_loss, epoch)
        if stage != Stage.TEST:
            return
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=self.stage_stats["TEST"])
        wer_file = getattr(self.hparams, "wer_file", None)
        if wer_file:
            with open(wer_file, "w") as f:
                self.wer_metric.write_stats(f)


def _chars(text):
    return list(text)


def make_datasets(hparams, corpus):
    """The train, valid and test datasets (``hparams["<split>_json"]``:
    ``sig`` read by ``corpus.audio``, and the characters of
    ``corpus.text_key``, spaces included, as ``tokens`` through a
    ``CTCTextEncoder`` built over all three splits with ``<blank>`` at 0,
    or loaded from ``<save_folder>/label_encoder.txt``).  Raises when the
    inventory passes ``output_neurons``.  Returns ``(datasets by split,
    encoder)``."""
    label_encoder = CTCTextEncoder()
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(corpus.audio, takes=corpus.audio_keys,
                            provides="sig")
        ds.add_dynamic_item(_chars, takes=corpus.text_key,
                            provides="char_list")

        def tokens_pipeline(char_list):
            return np.asarray(label_encoder.encode_sequence(char_list),
                              np.int64)

        ds.add_dynamic_item(tokens_pipeline, takes="char_list",
                            provides="tokens")
        ds.set_output_keys(["id", "sig", "tokens"])
        datasets[split] = ds
    label_encoder.load_or_create(
        path=hparams["save_folder"] + "/label_encoder.txt",
        from_didatasets=[datasets[s] for s in ("train", "valid", "test")],
        output_key="char_list", sequence_input=True,
        special_labels={"blank_label": "<blank>"})
    if len(label_encoder) > hparams["output_neurons"]:
        raise ValueError(
            f"{len(label_encoder)} labels (the characters and the blank) "
            f"pass output_neurons {hparams['output_neurons']}")
    return datasets, label_encoder


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_LIBRISPEECH):
    """Everything ``run`` trains with, built as the scripts' ``__main__``
    builds it: ``hparams`` (one of the dicts; its ``corpus`` picks the
    ``CORPORA`` entry) with the folders and ``overrides``, the manifests
    (prepared unless they exist), the datasets and the label encoder,
    loaders of ``batch_size`` (the train loader shuffled), an
    ``EpochCounter`` and an ``ASR`` Brain with a ``Checkpointer`` on
    ``<output_folder>/save``, a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt`` and ``wer_file``
    ``<output_folder>/wer.txt``.  ``run_opts`` are the ``Brain``'s
    (``device``: None for the CUDA card, "cpu" to ask for the CPU).
    Returns a dict with ``brain``, ``epoch_counter``, ``train_loader``,
    ``valid_loader``, ``test_loader``, ``label_encoder`` and
    ``hparams``."""
    probe = dict(hparams, **(overrides or {}))
    corpus = CORPORA[probe["corpus"]]
    names = corpus.manifests(probe)
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", names[0]), ("valid_json", names[1]),
        ("test_json", names[2])))
    hp.setdefault("wer_file", f"{output_folder}/wer.txt")
    run_on_main(corpus.prepare, args=(hp,))
    datasets, label_encoder = make_datasets(hp, corpus)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = ASR(dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                     epoch_counter=epoch_counter),
                run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]),
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


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_LIBRISPEECH):
    """The scripts' ``__main__``: ``build``, ``fit`` (resuming from the
    latest checkpoint in ``<output_folder>/save``), then ``evaluate`` on
    the test set from the checkpoint with the lowest validation WER.
    Arguments as for ``build``.  Returns the Brain
    (``brain.stage_stats`` holds the last VALID and TEST loss, WER and
    CER)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="WER")
    return brain
