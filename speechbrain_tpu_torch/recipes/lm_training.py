"""The language-model training recipes end to end, on the port.

Does what ``recipes/LibriSpeech/LM/train.py`` does with
``hparams/RNNLM.yaml`` (``HPARAMS_RNNLM``) and ``hparams/transformer.yaml``
(``HPARAMS_TRANSFORMER``), what ``recipes/timers-and-such/LM/
train.py`` does with ``hparams/train.yaml`` (``HPARAMS_TAS``), what
``recipes/KsponSpeech/LM/train.py`` does with ``hparams/transformer.yaml``
(``HPARAMS_KSPON``) and what ``recipes/Switchboard/LM/train.py`` does with
``hparams/transformer.yaml`` and ``transformer_finetune.yaml``
(``HPARAMS_SWITCHBOARD``, ``HPARAMS_SWITCHBOARD_FINETUNE``: the same
recipe at lr 1e-4; the yaml's "finetune from a LibriSpeech-pretrained LM"
loads nothing in the JAX script, and nothing here): a corpus
(LibriSpeech's: ``train.txt``, ``valid.txt`` and ``test.txt`` of one
utterance a line in ``data_folder``; the others: the manifests of their
prepare scripts, ``timers_and_such_prepare.prepare_TAS`` (``transcript``),
``ksponspeech_prepare.prepare_ksponspeech`` (train, dev and eval_clean;
``wrd``) and ``switchboard_prepare.prepare_switchboard`` (train, and dev
as both the validation and the test set; ``words``)) -> a
unigram ``SentencePiece`` tokenizer (trained on the train text, or an
existing model file given to ``run``) -> ``tokens_bos`` = [bos] + tokens
and ``tokens_eos`` = tokens + [eos], the tokens cut to ``max_seq_len -
1`` where the yaml sets one -> ``LM.fit`` (``log_softmax(model(
tokens_bos))``, the masked ``nll_loss`` against ``tokens_eos``; Adam;
the Noam schedule stepped after each optimizer step (LibriSpeech) or
NewBob on the validation perplexity (Timers and Such); checkpoints keep
the lowest perplexity, ``exp(min(loss, 20))``) -> ``evaluate(min_key=
"ppl")`` -> ``<output_folder>/lm.ckpt``, the best model's
``state_dict``.  A killed run resumes from its latest checkpoint when
``run`` is called again on the same output folder.

The LMs are the fusion LMs of the ASR recipes: ``lm.ckpt`` of
``HPARAMS_RNNLM`` loads into ``librispeech_seq2seq``'s search
(``run_opts["lm_ckpt"]``), and that of ``HPARAMS_TRANSFORMER`` into
``librispeech_asr``'s (its ``lm_model``, config 4's).  Give ``run`` the
ASR recipe's tokenizer model file so that both read the same token ids.

Differences from the JAX recipes:

- ``HPARAMS_RNNLM`` trains with bos = eos = 0, as the seq2seq yamls'
  fusion reads it; ``RNNLM.yaml``'s bos 1 and eos 2 are word pieces of
  the recipes' tokenizer.  ``HPARAMS_TRANSFORMER`` and ``HPARAMS_TAS``
  keep the yamls' 1 and 2.
- ``run`` takes an existing tokenizer model file and trains none; the
  JAX script trains a new tokenizer on the LM text in its own folder
  (``LM/train.py:111-118``), although its yaml says the tokenizer is
  "shared with the ASR recipe" (``RNNLM.yaml:19``).
- The Brain registers its schedule with the checkpointer
  (``"lr_annealing"``); the JAX recipes register none.
"""

import logging
import os
import shutil

import numpy as np
import torch

from ..asr import _random_init
from ..core import Brain, Stage
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..lobes.models.RNNLM import RNNLM
from ..lobes.models.transformer.TransformerLM import TransformerLM
from ..nnet.losses import nll_loss
from ..nnet.schedulers import NewBobScheduler, NoamScheduler
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import at_least_f32, recipe_hparams
from .ksponspeech_prepare import prepare_ksponspeech
from .switchboard_prepare import prepare_switchboard
from .timers_and_such_prepare import prepare_TAS

logger = logging.getLogger(__name__)

__all__ = ["HPARAMS_RNNLM", "HPARAMS_TRANSFORMER", "HPARAMS_TAS",
           "HPARAMS_KSPON", "HPARAMS_SWITCHBOARD",
           "HPARAMS_SWITCHBOARD_FINETUNE", "build_model", "LM",
           "dataio_prepare", "build", "run", "write_synthetic_text"]

# what recipes/LibriSpeech/LM/hparams/{RNNLM,transformer}.yaml share
# (with the JAX Brain's clip, 5)
_LIBRISPEECH = dict(
    corpus="librispeech",
    seed=2223,
    token_type="unigram",
    batch_size=64,
    max_seq_len=256,
    number_of_epochs=20,
    lr=0.001,
    grad_accumulation_factor=1,
    schedule="noam",
    n_warmup_steps=4000,
    max_grad_norm=5.0,
)

# RNNLM.yaml (bos and eos 0: see the module; RNNLM's dnn_blocks
# default, 1)
HPARAMS_RNNLM = dict(
    _LIBRISPEECH,
    vocab_size=1000,
    bos_index=0,
    eos_index=0,
    model="rnnlm",
    emb_dim=128,
    rnn_layers=2,
    rnn_neurons=2048,
    dnn_blocks=1,
    dnn_neurons=512,
    dropout=0.0,
)

# transformer.yaml (TransformerLM's activation and normalize_before
# defaults: gelu, post-norm)
HPARAMS_TRANSFORMER = dict(
    _LIBRISPEECH,
    vocab_size=5000,
    bos_index=1,
    eos_index=2,
    model="transformer",
    d_model=768,
    nhead=12,
    num_layers=12,
    d_ffn=3072,
    dropout=0.1,
)

# recipes/timers-and-such/LM/hparams/train.yaml (RNNLM's dropout
# default, 0.15; no max_seq_len: the transcripts are not cut)
HPARAMS_TAS = dict(
    corpus="timers-and-such",
    seed=1234,
    train_splits=["train-synth", "train-real"],
    vocab_size=58,
    token_type="unigram",
    bos_index=1,
    eos_index=2,
    batch_size=32,
    max_seq_len=None,
    number_of_epochs=20,
    lr=0.001,
    model="rnnlm",
    emb_dim=128,
    rnn_layers=2,
    rnn_neurons=256,
    dnn_blocks=1,
    dnn_neurons=128,
    dropout=0.15,
    schedule="newbob",
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)


# recipes/KsponSpeech/LM/hparams/transformer.yaml: the LibriSpeech
# transformer LM's values on the KsponSpeech manifests
HPARAMS_KSPON = dict(
    HPARAMS_TRANSFORMER,
    corpus="ksponspeech",
    train_splits=["train"],
    dev_splits=["dev"],
    test_splits=["eval_clean"],
    skip_prep=False,
)

# recipes/Switchboard/LM/hparams/transformer.yaml: the same at 2000
# tokens on the Switchboard manifests
HPARAMS_SWITCHBOARD = dict(
    HPARAMS_TRANSFORMER,
    corpus="switchboard",
    dev_conversations=20,
    skip_prep=False,
    vocab_size=2000,
)

# transformer_finetune.yaml: the same at lr 1e-4
HPARAMS_SWITCHBOARD_FINETUNE = dict(HPARAMS_SWITCHBOARD, lr=0.0001)

# the corpora read from their prepare scripts' manifests: the prepare
# function, its keyword arguments taken from the recipe's values (by
# value name), the manifests read as the train, valid and test sets, and
# their text key
_MANIFESTS = {
    "timers-and-such": (prepare_TAS, {"train_splits": "train_splits"},
                        ("train", "dev-real", "test-real"), "transcript"),
    "ksponspeech": (prepare_ksponspeech,
                    {"tr_splits": "train_splits", "dev_splits": "dev_splits",
                     "te_splits": "test_splits", "skip_prep": "skip_prep"},
                    ("train", "dev", "eval_clean"), "wrd"),
    "switchboard": (prepare_switchboard,
                    {"dev_conversations": "dev_conversations",
                     "skip_prep": "skip_prep"},
                    ("train", "dev", "dev"), "words"),
}


def build_model(hp, seed=0):
    """The yaml's ``model`` from the recipe's values ``hp``: an ``RNNLM``
    (``model`` "rnnlm") or a ``TransformerLM`` ("transformer"), with
    Lecun-normal weights and orthogonal recurrent ones from ``seed``."""
    if hp["model"] == "rnnlm":
        model = RNNLM(hp["vocab_size"], embedding_dim=hp["emb_dim"],
                      dropout=hp["dropout"], rnn_layers=hp["rnn_layers"],
                      rnn_neurons=hp["rnn_neurons"],
                      dnn_blocks=hp["dnn_blocks"],
                      dnn_neurons=hp["dnn_neurons"])
    elif hp["model"] == "transformer":
        model = TransformerLM(hp["vocab_size"], d_model=hp["d_model"],
                              nhead=hp["nhead"],
                              num_encoder_layers=hp["num_layers"],
                              d_ffn=hp["d_ffn"], dropout=hp["dropout"])
    else:
        raise ValueError(f"model {hp['model']!r}: 'rnnlm' or 'transformer'")
    _random_init(model, torch.Generator().manual_seed(seed))
    return model


class LM(Brain):
    """The LM recipes' ``LM`` Brain (``LibriSpeech/LM/train.py:23-64``,
    ``timers-and-such/LM/train.py:23-58``) over one module, ``model``
    (``build_model``).

    ``compute_forward``: ``model(tokens_bos)`` in the activation dtype ->
    float32 (float64 under a float64 ``self.dtype``) ``log_softmax``.
    ``compute_objectives``: ``nll_loss`` of ``tokens_eos`` with the lengths
    ``tokens_eos_lens * batch_mask``.  The optimizer is
    ``torch.optim.Adam`` with optax ``adam``'s settings ((0.9, 0.999), eps
    1e-8, no decay) after the clip to ``max_grad_norm``, at ``self.lr``:
    ``lr``, then, with ``schedule`` "noam", ``NoamScheduler(lr,
    n_warmup_steps)`` after each optimizer step, or with "newbob",
    ``NewBobScheduler`` on the validation perplexity at each epoch's end.
    With a ``checkpointer`` the schedule is registered as
    ``"lr_annealing"``.  ``on_stage_end`` keeps the stage's ``loss`` and
    ``ppl`` (``exp(min(loss, 20))``) in ``self.stage_stats``; at VALID it
    writes the logger's line (``hparams["train_logger"]``) and saves a
    checkpoint that keeps the lowest ppl; at TEST it logs the epoch
    loaded.

    Example
    -------
    >>> hp = dict(HPARAMS_TAS, vocab_size=9, emb_dim=4, rnn_layers=1,
    ...           rnn_neurons=8, dnn_neurons=6)
    >>> brain = LM(hp, run_opts={"device": "cpu"})
    >>> batch = {"tokens_bos": np.array([[1, 3, 4], [1, 5, 0]]),
    ...          "tokens_eos": np.array([[3, 4, 2], [5, 2, 0]]),
    ...          "tokens_eos_lens": np.array([1.0, 2 / 3], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    def __init__(self, hparams, run_opts=None, checkpointer=None):
        hp = dict(hparams)
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adam(params, lr=hp["lr"], betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0)

        super().__init__({"model": build_model(hp, run_opts["seed"])},
                         opt_class, hp, run_opts, checkpointer)
        if hp["schedule"] == "noam":
            self.lr_annealing = NoamScheduler(hp["lr"], hp["n_warmup_steps"])
        else:
            self.lr_annealing = NewBobScheduler(
                hp["lr"], annealing_factor=hp["annealing_factor"],
                improvement_threshold=hp["improvement_threshold"],
                patient=hp["patient"])
        if (checkpointer is not None
                and "lr_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("lr_annealing", self.lr_annealing)
        self.stage_stats = {}

    def compute_forward(self, batch, stage):
        """The (B, L, V) next-token log-probabilities."""
        logits = self.modules.model(batch["tokens_bos"], dtype=self.dtype)
        return torch.log_softmax(at_least_f32(logits), -1)

    def compute_objectives(self, predictions, batch, stage):
        """The NLL of ``tokens_eos``."""
        return nll_loss(predictions, batch["tokens_eos"],
                        length=batch["tokens_eos_lens"] * batch["batch_mask"])

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """Noam after each optimizer step."""
        if should_step and self.hparams.schedule == "noam":
            _, self.lr = self.lr_annealing()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """See the class."""
        if stage == Stage.TRAIN:
            return
        ppl = float(np.exp(min(stage_loss, 20.0)))
        stats = {"loss": stage_loss, "ppl": ppl}
        self.stage_stats[stage.name] = stats
        train_logger = getattr(self.hparams, "train_logger", None)
        if stage == Stage.VALID:
            if self.hparams.schedule == "newbob":
                _, self.lr = self.lr_annealing(ppl)
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats=stats)
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(meta={"ppl": ppl},
                                                     min_keys=["ppl"])
        elif train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats)


def dataio_prepare(hparams, tokenizer):
    """The train, valid and test datasets: for LibriSpeech the lines of
    ``train_text``/``valid_text``/``test_text`` (stripped, empty ones
    skipped; ids ``<split><line>``), for the others the text of the
    ``<split>_json`` manifests (``transcript``, ``wrd`` or ``words``);
    each gives ``id``,
    ``tokens_bos`` and ``tokens_eos``, the tokens cut to ``max_seq_len -
    1`` when it is set (``train.py:67-100``)."""
    datasets = {}
    max_len = hparams["max_seq_len"]
    for split in ("train", "valid", "test"):
        if hparams["corpus"] == "librispeech":
            with open(hparams[f"{split}_text"], encoding="utf-8") as f:
                lines = [line.strip() for line in f if line.strip()]
            ds = DynamicItemDataset({f"{split}{i}": {"text": t}
                                     for i, t in enumerate(lines)})
            key = "text"
        else:
            ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
            key = _MANIFESTS[hparams["corpus"]][3]

        def text_pipeline(text):
            tokens = tokenizer.sp.encode_as_ids(text)
            if max_len is not None:
                tokens = tokens[:max_len - 1]
            return (np.asarray([hparams["bos_index"]] + tokens, np.int64),
                    np.asarray(tokens + [hparams["eos_index"]], np.int64))

        ds.add_dynamic_item(text_pipeline, takes=key,
                            provides=["tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "tokens_bos", "tokens_eos"])
        datasets[split] = ds
    return datasets


def _tokenizer(hp, tokenizer_file):
    """The recipe's ``SentencePiece``: ``tokenizer_file`` (a model file
    of this package's ``SentencePiece``) copied into the save folder, or
    one trained on the train text."""
    if hp["corpus"] == "librispeech":
        train, read, fmt = hp["train_text"], "text", "text"
    else:
        train, read, fmt = (hp["train_json"], _MANIFESTS[hp["corpus"]][3],
                            "json")
    if tokenizer_file is not None:
        dst = os.path.join(hp["save_folder"],
                           f"{hp['vocab_size']}_{hp['token_type']}.model.json")
        if not os.path.exists(dst):
            shutil.copyfile(tokenizer_file, dst)
        train = None
    return SentencePiece(model_dir=hp["save_folder"],
                         vocab_size=hp["vocab_size"], annotation_train=train,
                         annotation_read=read, model_type=hp["token_type"],
                         annotation_format=fmt)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_RNNLM, tokenizer_file=None):
    """Everything ``run`` trains with, built as the recipes' ``__main__``
    builds it: the manifests of the corpora that have them, prepared
    unless they exist (Timers and Such: ``prepare_TAS`` on
    ``train_splits``, ``train.json``, ``dev-real.json`` and
    ``test-real.json`` read; KsponSpeech: ``train.json``, ``dev.json`` and
    ``eval_clean.json``; Switchboard: ``train.json`` and ``dev.json``,
    twice), the tokenizer (see ``run``), the datasets and their loaders
    (batches of ``batch_size``, the train loader shuffled), an
    ``EpochCounter``, and an ``LM`` with a ``Checkpointer`` on
    ``<output_folder>/save`` and a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt``.

    ``hparams`` is one of the module's dicts; ``overrides`` replace its
    values; ``run_opts`` are
    the ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for
    the CPU).  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader``, ``test_loader``, ``tokenizer``
    and ``hparams``."""
    if hparams["corpus"] == "librispeech":
        hp = recipe_hparams(hparams, data_folder, output_folder, overrides)
        for split in ("train", "valid", "test"):
            hp.setdefault(f"{split}_text",
                          os.path.join(data_folder, f"{split}.txt"))
    else:
        prepare, args, splits, _ = _MANIFESTS[hparams["corpus"]]
        hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                            zip(("train_json", "valid_json", "test_json"),
                                splits))
        run_on_main(prepare, kwargs=dict(
            {arg: hp[key] for arg, key in args.items()},
            data_folder=hp["data_folder"], save_folder=hp["save_folder"]))
    tokenizer = _tokenizer(hp, tokenizer_file)
    datasets = dataio_prepare(hp, tokenizer)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = LM(dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                    epoch_counter=epoch_counter),
               run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]))
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
        hparams=HPARAMS_RNNLM, tokenizer_file=None):
    """The recipes' ``__main__``: ``build``, ``fit`` (resuming from the
    latest checkpoint in ``<output_folder>/save``), ``evaluate`` on the
    test set from the checkpoint with the lowest validation perplexity,
    then that model's ``state_dict`` written to ``<output_folder>/
    lm.ckpt``.  ``tokenizer_file``: a ``SentencePiece`` model file (e.g.
    the ASR recipe's ``<save_folder>/<vocab>_unigram.model.json``) to
    tokenize with, so that the LM shares its token ids; None trains one
    on the train text.  Other arguments as for ``build``.  Returns the
    Brain (``brain.stage_stats`` holds the last VALID and TEST loss and
    ppl)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams,
                  tokenizer_file)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="ppl")
    state = {k: v.detach().cpu()
             for k, v in brain.modules.model.state_dict().items()}
    torch.save(state, os.path.join(output_folder, "lm.ckpt"))
    return brain


def write_synthetic_text(folder, counts, words, n_words=(5, 20), seed=0):
    """Write LibriSpeech LM text files of synthetic sentences, for trying
    the recipe without the corpus: ``counts`` maps "train", "valid" and
    "test" to their numbers of lines, written to ``<folder>/<split>.txt``,
    each line ``n_words`` (uniform) words drawn from ``words`` (e.g. the
    ASR recipe's transcripts' words, so that its tokenizer covers them).
    Everything comes from ``seed``.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_text(d, {"train": 3}, ["A", "B"], n_words=(2, 2))
    >>> len(open(d + "/train.txt").read().split())
    6
    """
    rng = np.random.default_rng(seed)
    words = sorted(set(words))
    os.makedirs(folder, exist_ok=True)
    for split, n in sorted(counts.items()):
        with open(os.path.join(folder, f"{split}.txt"), "w",
                  encoding="utf-8") as f:
            for _ in range(n):
                k = rng.integers(n_words[0], n_words[1] + 1)
                f.write(" ".join(rng.choice(words, k)) + "\n")
