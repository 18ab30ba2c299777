"""The text natural language understanding recipes end to end, on the
port: gold transcripts to a semantics string, for SLURP and Timers and
Such.

Does what ``recipes/SLURP/NLU/train.py`` (``HPARAMS_SLURP_NLU``) and
``recipes/timers-and-such/{decoupled,multistage}/train.py`` with their
``train.yaml``, ``train_LS_LM.yaml`` and ``train_TAS_LM.yaml``
(``HPARAMS_TAS_DECOUPLED``, ``HPARAMS_TAS_MULTISTAGE``; the six yamls
differ in their comments and output folders alone) do: the corpus's
manifests (``slu_direct.CORPORA``) -> two unigram ``SentencePiece``
tokenizers of 58 pieces, one on the transcripts (``asr_vocab_size``, in
``<save_folder>/transcript_tok``) and one on the semantics (in
``<save_folder>/semantics_tok``) -> batches (16 for SLURP, 8 for Timers
and Such; the train loader shuffled) -> ``NLUBrain.fit``: the transcript
pieces -> ``input_emb`` (128) -> ``slu_enc``, a bidirectional GRU of 2 x
256 over the padded rows (no lengths, as in JAX) -> an
``AttentionalRNNDecoder`` (GRU 256, key-value attention 256, over the
transcripts' lengths) on ``output_emb`` of the semantics' ``tokens_bos``
-> ``seq_lin`` -> log-softmax; the NLL; Adam at 3e-4 (SLURP: NewBob on
the validation's 1 - accuracy, registered with the checkpointer, which
the JAX script does not do); outside training the greedy search
(``max_decode_ratio`` 10 x the transcript's pieces) and its exact-match
accuracy, the best epoch by it.

``decoupled`` and ``multistage`` differ only where ``asr_source`` names a
trained ASR, whose transcripts then feed the NLU at test (decoupled) or
at every stage (multistage).  That needs the pretrained
``EncoderDecoderASR`` interface (``pretrained/interfaces.py``), which the
port does not have yet (ROADMAP.md, Queue 1, the task libraries and
inference), so ``build`` raises when ``asr_source`` is set; the six yamls
set it to null, and the port reads the gold transcripts, as JAX does
then.  The port's datasets read no audio: nothing of these recipes uses
it without an ASR (the JAX scripts read it all the same).
"""

import numpy as np
import torch

from ..asr import _random_init
from ..dataio.dataset import DynamicItemDataset
from ..nnet.embedding import Embedding
from ..nnet.linear import Linear
from ..nnet.RNN import GRU, AttentionalRNNDecoder
from ..tokenizers.SentencePiece import SentencePiece
from .slu_direct import (
    SLUBrain,
    _semantics_pipeline,
    fit_and_test,
    loaders,
    prepare,
)

__all__ = ["HPARAMS_SLURP_NLU", "HPARAMS_TAS_DECOUPLED",
           "HPARAMS_TAS_MULTISTAGE", "YAMLS", "NLUBrain", "make_datasets",
           "build", "run"]

# recipes/SLURP/NLU/hparams/train.yaml (the JAX Brain's clip 5)
HPARAMS_SLURP_NLU = dict(
    corpus="slurp",
    search=True,
    asr_source=None,
    seed=1234,
    asr_vocab_size=58,
    vocab_size=58,
    token_type="unigram",
    batch_size=16,
    number_of_epochs=20,
    lr=0.0003,
    precision="bf16",
    bos_index=1,
    eos_index=2,
    max_decode_ratio=10.0,
    emb_size=128,
    enc_neurons=256,
    enc_layers=2,
    dec_neurons=256,
    attn_dim=256,
    dropout=0.15,
    newbob=True,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)
# recipes/timers-and-such/decoupled/hparams/train.yaml (and
# train_LS_LM.yaml, train_TAS_LM.yaml): no annealing, batches of 8
HPARAMS_TAS_DECOUPLED = dict(
    {k: v for k, v in HPARAMS_SLURP_NLU.items()
     if k not in ("improvement_threshold", "annealing_factor", "patient")},
    corpus="tas", train_splits=["train-synth", "train-real"], batch_size=8,
    newbob=False)
# recipes/timers-and-such/multistage/hparams/train*.yaml: the same values
HPARAMS_TAS_MULTISTAGE = dict(HPARAMS_TAS_DECOUPLED)
# each yaml (under recipes/) and its dict
YAMLS = {
    "SLURP/NLU/hparams/train.yaml": HPARAMS_SLURP_NLU,
    **{f"timers-and-such/{stage}/hparams/{name}": hp
       for stage, hp in (("decoupled", HPARAMS_TAS_DECOUPLED),
                         ("multistage", HPARAMS_TAS_MULTISTAGE))
       for name in ("train.yaml", "train_LS_LM.yaml", "train_TAS_LM.yaml")},
}


class NLUBrain(SLUBrain):
    """The NLU scripts' Brain (``SLURP/NLU/train.py:28-116``; the
    ``decoupled``/``multistage`` ``SLU`` without an ASR): ``SLUBrain``'s
    loss, search, schedule and stages over a text encoder.
    ``compute_forward``: ``input_emb`` of ``transcript_tokens`` -> the
    activation dtype -> ``slu_enc`` -> ``dec`` over ``output_emb`` of
    ``tokens_bos``, attending over ``transcript_tokens_lens``.

    Example
    -------
    >>> hp = {"asr_vocab_size": 9, "vocab_size": 7, "emb_size": 4,
    ...       "enc_neurons": 5, "dec_neurons": 6, "attn_dim": 5,
    ...       "precision": "fp32"}
    >>> brain = NLUBrain(hp, run_opts={"device": "cpu"})
    >>> batch = {"transcript_tokens": np.array([[3, 4, 5], [6, 7, 0]]),
    ...     "transcript_tokens_lens": np.array([1.0, 2 / 3], np.float32),
    ...     "tokens_bos": np.array([[1, 3, 4], [1, 5, 0]]),
    ...     "tokens_eos": np.array([[3, 4, 2], [5, 2, 0]]),
    ...     "tokens_eos_lens": np.array([1.0, 2 / 3], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    DEFAULTS = HPARAMS_SLURP_NLU
    EMB = "output_emb"

    @staticmethod
    def build_modules(hp, seed):
        """The NLU yaml's modules, with Lecun-normal weights and orthogonal
        recurrent ones from ``seed`` (``asr._random_init``)."""
        enc = GRU(hp["emb_size"], hp["enc_neurons"],
                  num_layers=hp["enc_layers"], bidirectional=True)
        modules = {
            "input_emb": Embedding(hp["asr_vocab_size"], hp["emb_size"]),
            "slu_enc": enc,
            "output_emb": Embedding(hp["vocab_size"], hp["emb_size"]),
            "dec": AttentionalRNNDecoder(
                "gru", "keyvalue", hidden_size=hp["dec_neurons"],
                attn_dim=hp["attn_dim"], enc_dim=2 * hp["enc_neurons"],
                input_size=hp["emb_size"], num_layers=1,
                dropout=hp["dropout"]),
            "seq_lin": Linear(hp["dec_neurons"], hp["vocab_size"]),
        }
        gen = torch.Generator().manual_seed(seed)
        for module in modules.values():
            _random_init(module, gen)
        return modules

    def _encode(self, batch):
        emb = self.modules.input_emb(batch["transcript_tokens"])
        enc, _ = self.modules.slu_enc(emb.to(self.dtype))
        return enc, batch["transcript_tokens_lens"]


def make_datasets(hparams, in_tokenizer, out_tokenizer):
    """The scripts' datasets (``NLU/train.py:119-156``): the transcript's
    pieces as ``transcript_tokens``, and the semantics' as ``tokens``,
    ``tokens_bos`` and ``tokens_eos``."""
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(
            lambda t: np.asarray(in_tokenizer.sp.encode_as_ids(t), np.int64),
            takes="transcript", provides="transcript_tokens")
        ds.add_dynamic_item(_semantics_pipeline(out_tokenizer, hparams),
                            takes="semantics",
                            provides=["tokens", "tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "transcript_tokens", "tokens", "tokens_bos",
                            "tokens_eos"])
        datasets[split] = ds
    return datasets


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_SLURP_NLU):
    """Everything ``run`` trains with, built as the scripts' ``__main__``
    builds it: the corpus's manifests (prepared unless they exist), the
    transcript and semantics tokenizers (trained on the train manifest
    unless their model files exist), the datasets and loaders, an
    ``EpochCounter`` and an ``NLUBrain`` with a ``Checkpointer`` on
    ``<output_folder>/save`` and a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt``.  Raises ``NotImplementedError``
    when ``asr_source`` is set (see the module).

    ``hparams`` is one of ``YAMLS``' dicts; ``overrides`` replace its
    values; ``run_opts`` are the ``Brain``'s.  Returns a dict with
    ``brain``, ``epoch_counter``, ``train_loader``, ``valid_loader``,
    ``test_loader``, ``tokenizers`` (transcript, semantics) and
    ``hparams``."""
    source = dict(hparams, **(overrides or {})).get("asr_source")
    if source:
        raise NotImplementedError(
            f"asr_source {source!r}: transcribing the audio needs the "
            "pretrained EncoderDecoderASR interface, which the port does "
            "not have yet; set asr_source to None for the gold transcripts")
    hp, epoch_counter, checkpointer = prepare(hparams, overrides,
                                              data_folder, output_folder)
    tokenizers = [
        SentencePiece(model_dir=f"{hp['save_folder']}/{name}_tok",
                      vocab_size=hp[size], annotation_train=hp["train_json"],
                      annotation_read=name, model_type=hp["token_type"],
                      annotation_format="json")
        for name, size in (("transcript", "asr_vocab_size"),
                           ("semantics", "vocab_size"))]
    brain = NLUBrain(hp, run_opts=run_opts, checkpointer=checkpointer,
                     tokenizer=tokenizers[1])
    return {"brain": brain, "epoch_counter": epoch_counter,
            **loaders(hp, make_datasets(hp, *tokenizers)),
            "tokenizers": tokenizers, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_SLURP_NLU):
    """An NLU script's ``__main__``: ``build``, ``fit``, then the test from
    the checkpoint with the best accuracy.  Returns the Brain."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams))
