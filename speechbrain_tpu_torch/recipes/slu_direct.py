"""The direct spoken language understanding recipes end to end, on the
port: speech to a semantics string, for Fluent Speech Commands, SLURP and
Timers and Such.

Does what ``recipes/{fluent-speech-commands,SLURP,timers-and-such}/
direct/train.py`` do with their ``hparams/train.yaml`` (``HPARAMS_FSC``,
``HPARAMS_SLURP``, ``HPARAMS_TAS``): the corpus's manifests (``CORPORA``)
-> a BPE ``SentencePiece`` tokenizer of ``vocab_size`` 58 trained on the
train manifest's ``semantics`` -> batches of 8 read from disk (the train
loader shuffled) -> ``SLUBrain.fit``: Fbank, 40 mels -> global
``InputNormalization`` -> a ``CRDNN`` (CNN 64/128, a bidirectional LSTM
of 2 x 256, DNN 1 x 256) -> an ``AttentionalRNNDecoder`` (GRU 256,
content attention 256) over the embeddings of ``tokens_bos`` ->
``seq_lin`` -> log-softmax; the NLL of ``tokens_eos``; Adam at 3e-4.
The three scripts differ as data, not as code: which corpus
(``corpus``), and whether the greedy search runs outside training
(``search``): FSC and Timers and Such decode with
``S2SRNNGreedySearcher`` (``max_decode_ratio`` 1) and keep the best epoch
by the exact-match accuracy of the decoded tokens (``acc``); SLURP
decodes nothing and keeps the best by the validation loss
(``SLURP/direct/train.py:49-73``).

``HPARAMS_SLURP_WAV2VEC`` and ``HPARAMS_TAS_WAV2VEC`` are SLURP's and
Timers and Such's ``direct/hparams/train_with_wav2vec2.yaml``
(``train_with_wav2vec2.py``): the same recipes with the wav2vec 2.0 base
encoder in place of the Fbank and the CRDNN (``encoder`` "wav2vec": the
wave -> ``W2VLatentExtractor`` -> ``EncoderWrapper``, 12 layers at d 768,
called without ``wav_lens``, so the padding is attended, as the JAX
scripts call it -> the decoder's content attention over the 768-wide
states).

The yamls' ``bos_index`` 1 and ``eos_index`` 2 are pieces of the
semantics tokenizer, not special symbols: with the BPE pieces (``<unk>``,
then the characters in code-point order, then the merges) they are the
two lowest characters of the semantics strings (``'`` and ``:`` for FSC
and SLURP).  So a target sequence holds "eos" wherever its BPE leaves
that character alone, and the greedy search stops there.  The port
copies this.

``train_tokenizer`` does what the corpora's ``Tokenizer/train.py`` do with
their yamls (``TOKENIZER_FSC``, ``TOKENIZER_SLURP``, ``TOKENIZER_TAS``):
the manifests in ``<output_folder>/manifests`` and a BPE model of
``token_output`` pieces on their train manifest's semantics in
``<output_folder>``; it differs from ``build``'s tokenizer in its size
(51 for FSC and Timers and Such) and, for SLURP, its train manifest,
which merges ``train_synthetic`` too.

The Brain registers no schedule: these yamls anneal nothing.  Example at
toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import slu_direct
    brain = slu_direct.run("/data/fsc", "results/fsc_direct",
                           overrides={"rnn_neurons": 16, ...},
                           run_opts={"device": "cpu"})
"""

import numpy as np
import torch

from ..asr import W2V_BASE
from ..core import Brain, Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..decoders.seq2seq import S2SRNNGreedySearcher
from ..nnet.losses import nll_loss
from ..nnet.schedulers import NewBobScheduler
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import at_least_f32, recipe_hparams
from .fsc_prepare import prepare_FSC
from .librispeech_seq2seq import build_modules, wav2vec_states
from .slurp_prepare import prepare_SLURP
from .timers_and_such_prepare import prepare_TAS

__all__ = ["HPARAMS_FSC", "HPARAMS_SLURP", "HPARAMS_TAS",
           "HPARAMS_SLURP_WAV2VEC", "HPARAMS_TAS_WAV2VEC", "CORPORA",
           "TOKENIZER_FSC", "TOKENIZER_SLURP", "TOKENIZER_TAS", "SLUBrain",
           "make_datasets", "build", "run", "train_tokenizer"]

# each corpus's preparation (called with the recipe's values) and its
# train, valid and test manifests' names
CORPORA = {
    "fsc": (lambda hp: prepare_FSC(hp["data_folder"], hp["save_folder"]),
            ("train", "valid", "test")),
    "slurp": (lambda hp: prepare_SLURP(
        hp["data_folder"], hp["save_folder"],
        train_splits=hp.get("train_splits", ("train",))),
        ("train", "devel", "test")),
    "tas": (lambda hp: prepare_TAS(hp["data_folder"], hp["save_folder"],
                                   hp["train_splits"]),
            ("train", "dev-real", "test-real")),
}

# recipes/fluent-speech-commands/direct/hparams/train.yaml (the JAX
# Brain's fp32 and clip 5)
HPARAMS_FSC = dict(
    corpus="fsc",
    search=True,
    seed=11,
    sample_rate=16000,
    n_mels=40,
    vocab_size=58,
    token_type="bpe",
    batch_size=8,
    number_of_epochs=20,
    lr=0.0003,
    bos_index=1,
    eos_index=2,
    max_decode_ratio=1.0,
    cnn_blocks=2,
    cnn_channels=(64, 128),
    inter_layer_pooling_size=(2, 2),
    rnn_layers=2,
    rnn_neurons=256,
    dnn_blocks=1,
    dnn_neurons=256,
    emb_size=128,
    dec_neurons=256,
    attn_type="content",
    attn_dim=256,
    dropout=0.15,
    precision="fp32",
    max_grad_norm=5.0,
)
# recipes/SLURP/direct/hparams/train.yaml: no search, the best by loss
HPARAMS_SLURP = dict(HPARAMS_FSC, corpus="slurp", search=False)
del HPARAMS_SLURP["max_decode_ratio"]
# recipes/timers-and-such/direct/hparams/train.yaml
HPARAMS_TAS = dict(HPARAMS_FSC, corpus="tas",
                   train_splits=["train-synth", "train-real"])

# SLURP's and Timers and Such's direct/hparams/train_with_wav2vec2.yaml:
# the wav2vec 2.0 base encoder (EncoderWrapper's dropout 0.1) in place of
# the features and the CRDNN; the rest is train.yaml's
_CRDNN_KEYS = ("n_mels", "cnn_blocks", "cnn_channels",
               "inter_layer_pooling_size", "rnn_layers", "rnn_neurons",
               "dnn_blocks", "dnn_neurons")
HPARAMS_SLURP_WAV2VEC = dict(
    {k: v for k, v in HPARAMS_SLURP.items() if k not in _CRDNN_KEYS},
    **W2V_BASE, encoder="wav2vec")
HPARAMS_TAS_WAV2VEC = dict(
    {k: v for k, v in HPARAMS_TAS.items() if k not in _CRDNN_KEYS},
    **W2V_BASE, encoder="wav2vec")

# recipes/<corpus>/Tokenizer/hparams/tokenizer_bpe51.yaml and
# SLURP's tokenizer_bpe58.yaml
TOKENIZER_FSC = dict(corpus="fsc", token_type="bpe", token_output=51,
                     character_coverage=1.0, annotation_read="semantics")
TOKENIZER_SLURP = dict(TOKENIZER_FSC, corpus="slurp", token_output=58,
                       train_splits=["train", "train_synthetic"])
TOKENIZER_TAS = dict(TOKENIZER_FSC, corpus="tas",
                     train_splits=["train-synth", "train-real"])


class SLUBrain(Brain):
    """The direct scripts' ``SLU`` Brain (``direct/train.py:24-121``).

    ``compute_forward``: Fbank -> ``InputNormalization`` (updated in
    training until its ``update_until_epoch``) -> cast to the activation
    dtype -> ``enc`` (``_encode``) -> ``dec`` over ``emb(tokens_bos)`` ->
    the float32 log-softmax of ``seq_lin``.  ``compute_objectives``: the
    NLL of ``tokens_eos`` (lengths ``tokens_eos_lens * batch_mask``); with
    ``search``, outside training, the greedy search's hypotheses of the
    real rows against their tokens, one exact match or not a row.  The
    optimizer is ``torch.optim.Adam`` at ``lr`` (optax's defaults) after
    the clip to ``max_grad_norm``; with ``newbob`` the validation's 1 -
    accuracy anneals the rate (``NewBobScheduler``, registered as
    ``"lr_annealing"``).  ``on_stage_end`` keeps the stage's ``loss`` (and
    ``acc``) in ``self.stage_stats``, and at VALID logs them and keeps the
    checkpoint with the best ``acc`` (the lowest ``loss`` without
    search); at TEST it logs them.

    A subclass names the embedding of the decoder's input (``EMB``) and
    gives ``build_modules`` and the encoder (``_encode``).

    Example
    -------
    >>> hp = {"cnn_channels": (2, 2), "rnn_layers": 1, "rnn_neurons": 4,
    ...       "dnn_neurons": 4, "n_mels": 8, "emb_size": 4,
    ...       "dec_neurons": 6, "attn_dim": 5, "vocab_size": 7}
    >>> brain = SLUBrain(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(2, 4000)).astype(np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "tokens_bos": np.array([[1, 3, 4], [1, 5, 0]]),
    ...     "tokens_eos": np.array([[3, 4, 2], [5, 2, 0]]),
    ...     "tokens_eos_lens": np.array([1.0, 2 / 3], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    DEFAULTS = HPARAMS_FSC
    EMB = "emb"

    def __init__(self, hparams=None, run_opts=None, checkpointer=None,
                 tokenizer=None):
        hp = dict(self.DEFAULTS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adam(params, lr=hp["lr"])

        super().__init__(modules=self.build_modules(hp, run_opts["seed"]),
                         opt_class=opt_class, hparams=hp, run_opts=run_opts,
                         checkpointer=checkpointer)
        self.tokenizer = tokenizer
        self.metric = "acc" if hp["search"] else "loss"
        if hp.get("newbob"):
            self.lr_annealing = NewBobScheduler(
                hp["lr"], annealing_factor=hp["annealing_factor"],
                improvement_threshold=hp["improvement_threshold"],
                patient=hp["patient"])
            if (checkpointer is not None
                    and "lr_annealing" not in checkpointer.recoverables):
                checkpointer.add_recoverable("lr_annealing",
                                             self.lr_annealing)
        self.epoch = 0
        self.stage_stats = {}

    @staticmethod
    def build_modules(hp, seed):
        """The direct yaml's modules (``librispeech_seq2seq.
        build_modules`` with the content attention, no CTC head; the
        wav2vec encoder with ``encoder`` "wav2vec")."""
        return build_modules(hp, seed, ctc=False)

    def _encode(self, batch):
        """Returns ``(encoder states, their relative lengths)``."""
        m = self.modules
        if "extractor" in m:
            return (wav2vec_states(m, batch["sig"], self.dtype),
                    batch["sig_lens"])
        feats = m.compute_features(batch["sig"])
        feats = m.normalize(feats, batch["sig_lens"], epoch=self.epoch)
        return (m.enc(feats.to(self.dtype), lengths=batch["sig_lens"]),
                batch["sig_lens"])

    def _log_probs(self, dec_out):
        return torch.log_softmax(at_least_f32(self.modules.seq_lin(dec_out)),
                                 -1)

    def compute_forward(self, batch, stage):
        """Returns ``(log-probs (B, U, V) float32, encoder states, their
        lengths)``."""
        enc, lens = self._encode(batch)
        emb = getattr(self.modules, self.EMB)(batch["tokens_bos"])
        dec_out, _ = self.modules.dec(emb.to(self.dtype), enc, lens)
        return self._log_probs(dec_out), enc, lens

    def compute_objectives(self, predictions, batch, stage):
        """The NLL; outside training with ``search``, the exact matches."""
        seq_logp, enc, lens = predictions
        loss = nll_loss(seq_logp, batch["tokens_eos"],
                        length=batch["tokens_eos_lens"] * batch["batch_mask"])
        if stage != Stage.TRAIN and hasattr(self, "searcher"):
            hyps, _ = self.searcher(enc, lens)
            real = int(batch["batch_mask"].sum())
            targets = batch["tokens"][:real].cpu().numpy().tolist()
            t_lens = batch["tokens_lens"][:real].cpu().numpy()
            U = len(targets[0]) if targets else 0
            for hyp, t, l in zip(hyps[:real], targets, t_lens):
                self.exact.append(hyp == t[:int(round(float(l) * U))])
        return loss

    def make_searcher(self):
        """The scripts' ``S2SRNNGreedySearcher`` over the Brain's modules
        (``direct/train.py:75-99``): from ``bos_index`` to ``eos_index``,
        at most ``max_decode_ratio`` x the encoder's frames."""
        m, hp = self.modules, self.hparams
        emb = getattr(m, self.EMB)
        return S2SRNNGreedySearcher(
            embedding_fn=lambda t: emb(t).to(self.dtype),
            decoder_step_fn=m.dec.forward_step, linear_fn=self._log_probs,
            dec_hidden_size=hp.dec_neurons, attn_init_fn=m.dec.attn_init,
            rnn_init_fn=m.dec.rnn.init_state, bos_index=hp.bos_index,
            eos_index=hp.eos_index, min_decode_ratio=0.0,
            max_decode_ratio=hp.max_decode_ratio)

    def on_stage_start(self, stage, epoch=None):
        """The epoch; outside training with ``search``, the matches and
        the searcher."""
        if epoch is not None:
            self.epoch = epoch
        if stage != Stage.TRAIN and self.hparams.search:
            self.exact = []
            self.searcher = self.make_searcher()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The stage's stats; at VALID the schedule, the log line and the
        keep-best checkpoint, at TEST the log line."""
        if stage == Stage.TRAIN:
            return
        stats = {"loss": stage_loss}
        if self.hparams.search:
            stats["acc"] = float(np.mean(self.exact)) if self.exact else 0.0
        self.stage_stats[stage.name] = stats
        train_logger = getattr(self.hparams, "train_logger", None)
        if stage == Stage.VALID:
            if hasattr(self, "lr_annealing"):
                _, self.lr = self.lr_annealing(1.0 - stats["acc"])
            if train_logger is not None:
                train_logger.log_stats(
                    {"epoch": epoch, "lr": self.lr},
                    train_stats={"loss": self.avg_train_loss},
                    valid_stats=stats)
            if self.checkpointer is not None:
                best = "max_keys" if self.metric == "acc" else "min_keys"
                self.checkpointer.save_and_keep_only(
                    meta={self.metric: stats[self.metric]},
                    **{best: [self.metric]})
        elif train_logger is not None:
            counter = getattr(self.hparams, "epoch_counter", None)
            train_logger.log_stats(
                {"Epoch loaded": None if counter is None else counter.current},
                test_stats=stats)


def _semantics_pipeline(tokenizer, hp):
    def pipeline(semantics):
        tokens = tokenizer.sp.encode_as_ids(semantics)
        return (np.asarray(tokens, np.int64),
                np.asarray([hp["bos_index"]] + tokens, np.int64),
                np.asarray(tokens + [hp["eos_index"]], np.int64))
    return pipeline


def make_datasets(hparams, tokenizer):
    """The scripts' datasets (``direct/train.py:124-155``): ``sig`` and the
    semantics' pieces as ``tokens``, ``tokens_bos`` ([bos] + tokens) and
    ``tokens_eos`` (tokens + [eos])."""
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(_semantics_pipeline(tokenizer, hparams),
                            takes="semantics",
                            provides=["tokens", "tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "sig", "tokens", "tokens_bos",
                            "tokens_eos"])
        datasets[split] = ds
    return datasets


def prepare(hparams, overrides, data_folder, output_folder):
    """What the direct and NLU builds share: the recipe's values (the
    corpus's manifests ``train_json``, ``valid_json`` and ``test_json`` in
    ``<output_folder>/save``), the manifests (prepared unless they
    exist), an ``EpochCounter`` and a ``Checkpointer``.  Returns ``(hp,
    epoch_counter, checkpointer)``, ``hp`` with a ``FileTrainLogger``
    (``train_logger``) and the counter."""
    corpus = dict(hparams, **(overrides or {}))["corpus"]
    do_prepare, names = CORPORA[corpus]
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                        zip(("train_json", "valid_json", "test_json"), names))
    run_on_main(do_prepare, args=(hp,))
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    hp.update(train_logger=FileTrainLogger(hp["train_log"]),
              epoch_counter=epoch_counter)
    return hp, epoch_counter, Checkpointer(hp["save_folder"])


def loaders(hp, datasets):
    """Loaders of ``batch_size`` (the train loader shuffled)."""
    bs = hp["batch_size"]
    return {"train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs)}


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_FSC):
    """Everything ``run`` trains with, built as the scripts' ``__main__``
    builds it: the corpus's manifests (prepared unless they exist), the
    semantics tokenizer (trained on the train manifest unless its model
    file exists in ``<output_folder>/save``), the datasets and loaders, an
    ``EpochCounter`` and an ``SLUBrain`` with a ``Checkpointer`` on
    ``<output_folder>/save`` and a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt``.

    ``hparams`` is ``HPARAMS_FSC``, ``HPARAMS_SLURP`` or ``HPARAMS_TAS``;
    ``overrides`` replace its values; ``run_opts`` are the ``Brain``'s
    (``device``: None for the CUDA card, "cpu" to ask for the CPU).
    Returns a dict with ``brain``, ``epoch_counter``, ``train_loader``,
    ``valid_loader``, ``test_loader``, ``tokenizer`` and ``hparams``."""
    hp, epoch_counter, checkpointer = prepare(hparams, overrides,
                                              data_folder, output_folder)
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="semantics",
        model_type=hp["token_type"], annotation_format="json")
    brain = SLUBrain(hp, run_opts=run_opts, checkpointer=checkpointer,
                     tokenizer=tokenizer)
    return {"brain": brain, "epoch_counter": epoch_counter,
            **loaders(hp, make_datasets(hp, tokenizer)),
            "tokenizer": tokenizer, "hparams": hp}


def fit_and_test(parts):
    """``fit`` (resuming from the latest checkpoint), then ``evaluate`` on
    the test set from the best checkpoint (the highest ``acc``, or the
    lowest ``loss`` without search).  Returns the Brain."""
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    best = "max_key" if brain.metric == "acc" else "min_key"
    brain.evaluate(parts["test_loader"], **{best: brain.metric})
    return brain


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_FSC):
    """A direct script's ``__main__``: ``build``, then ``fit_and_test``.
    Arguments as for ``build``; returns the Brain (``brain.stage_stats``
    holds the last VALID and TEST loss, and accuracy with search)."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams))


def train_tokenizer(data_folder, output_folder, hparams=TOKENIZER_FSC,
                    overrides=None):
    """A ``Tokenizer/train.py`` with its yaml (``TOKENIZER_FSC``,
    ``TOKENIZER_SLURP`` or ``TOKENIZER_TAS``): the corpus's manifests in
    ``<output_folder>/manifests``, then a ``SentencePiece`` of
    ``token_output`` pieces of ``token_type`` trained on the train
    manifest's ``annotation_read`` field and saved in ``output_folder``
    (kept when its file exists).  Returns the tokenizer."""
    hp = dict(hparams, **(overrides or {}))
    hp.update(data_folder=data_folder,
              save_folder=f"{output_folder}/manifests")
    run_on_main(CORPORA[hp["corpus"]][0], args=(hp,))
    return SentencePiece(
        model_dir=output_folder, vocab_size=hp["token_output"],
        annotation_train=f"{hp['save_folder']}/train.json",
        annotation_read=hp["annotation_read"], annotation_format="json",
        model_type=hp["token_type"],
        character_coverage=hp["character_coverage"])
