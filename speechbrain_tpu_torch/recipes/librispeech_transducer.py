"""The LibriSpeech transducer recipe end to end, on the port.

Does what ``recipes/LibriSpeech/ASR/transducer/train.py`` does with
either of its hparams files: ``conformer_transducer.yaml`` (``HPARAMS``:
the conformer encoder) or ``train.yaml`` (``HPARAMS_CRDNN``: the CRDNN
encoder with a bidirectional LiGRU).  LibriSpeech folders -> JSON
manifests (``librispeech_asr.prepare_librispeech``) -> a BPE
``SentencePiece`` tokenizer at vocab 1000 trained on the train manifest
-> bucketed dynamic batches of audio files read from disk with
``tokens`` and ``tokens_blank = [blank] + tokens`` (``dataio_prepare``)
-> ``ConformerTransducerBrain`` or ``CRDNNTransducerBrain`` ``fit`` with
checkpoints (the best by validation loss is kept; the validation stage
runs no search) -> ``evaluate(min_key="loss")`` on the test set with the
recipe's beam-4 search.  A killed run resumes from its latest checkpoint
when ``run`` is called again on the same output folder.

The yamls' values are the dicts (the yaml files themselves are not
read); ``overrides`` replace any of them, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import librispeech_transducer as r
    brain = r.run("/data/LibriSpeech", "results/crdnn_transducer",
                  hparams=r.HPARAMS_CRDNN, run_opts={"device": "cpu"},
                  overrides={"rnn_neurons": 16, "rnn_layers": 1, ...})

Unlike the JAX recipe, the Brain registers the Noam schedule with the
checkpointer (``asr._ModelBrain``), so a resumed run continues its
learning-rate schedule instead of restarting the warm-up.
"""

import numpy as np

from ..asr import (
    CONFORMER_TRANSDUCER,
    CRDNN_TRANSDUCER,
    ConformerTransducerBrain,
    CRDNNTransducerBrain,
)
from ..dataio.batch import BatchShapePolicy, PaddedBatch
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..dataio.sampler import DynamicBatchSampler
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import recipe_hparams
from .librispeech_asr import prepare_librispeech, write_synthetic_librispeech

__all__ = ["HPARAMS", "HPARAMS_CRDNN", "dataio_prepare", "build", "run",
           "prepare_librispeech", "write_synthetic_librispeech"]

# the values both hparams files share, on top of the model's dims
_RECIPE = dict(
    seed=7778,
    train_splits=["train-clean-100"],
    dev_splits=["dev-clean"],
    test_splits=["test-clean"],
    vocab_size=1000,
    token_type="bpe",
    max_batch_length=120,
    num_buckets=8,
    num_workers=4,
    number_of_epochs=100,
    precision="bf16",
)
# recipes/LibriSpeech/ASR/transducer/hparams/conformer_transducer.yaml
HPARAMS = dict(CONFORMER_TRANSDUCER, encoder="conformer", **_RECIPE)
# recipes/LibriSpeech/ASR/transducer/hparams/train.yaml
HPARAMS_CRDNN = dict(CRDNN_TRANSDUCER, encoder="crdnn", **_RECIPE)
BRAINS = {"conformer": ConformerTransducerBrain, "crdnn": CRDNNTransducerBrain}

# token buckets: U drives the (B, T, U+1, V) joint, so the menu is tight
TOKEN_BUCKETS = [16, 32, 64, 128, 256]


def dataio_prepare(hparams, tokenizer):
    """The recipe's three loaders (``train.py:166-224``): the manifests'
    audio read from disk (``sig``) and words encoded by ``tokenizer``
    (``tokens``, and ``tokens_blank`` = [blank] + tokens); training
    batches from a ``DynamicBatchSampler`` (``max_batch_length`` seconds
    a batch, ``num_buckets``, shuffled) padded by the recipe's
    ``BatchShapePolicy`` (time to the sampler's bucket boundaries,
    ``tokens`` to ``TOKEN_BUCKETS`` and ``tokens_blank`` to each bucket
    + 1, so it stays one longer; the batch dim to powers of two from 2
    with dummy rows); validation and test batches of 8 in manifest
    order."""
    blank = hparams["blank_index"]
    datasets = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

        def text_pipeline(words):
            tokens = tokenizer.sp.encode_as_ids(words)
            return (np.asarray(tokens, np.int64),
                    np.asarray([blank] + tokens, np.int64))

        ds.add_dynamic_item(text_pipeline, takes="words",
                            provides=["tokens", "tokens_blank"])
        ds.set_output_keys(["id", "sig", "tokens", "tokens_blank"])
        datasets[split] = ds
    sampler = DynamicBatchSampler(
        datasets["train"], max_batch_length=hparams["max_batch_length"],
        num_buckets=hparams["num_buckets"], shuffle=True)
    sr = hparams["sample_rate"]
    policy = BatchShapePolicy(
        time_buckets=[int(b * sr) for b in sampler.bucket_boundaries],
        time_keys=("sig",),
        key_buckets={"tokens": TOKEN_BUCKETS,
                     "tokens_blank": [b + 1 for b in TOKEN_BUCKETS]},
        batch_buckets=[2, 4, 8, 16, 32, 64, 128],
    )
    train_loader = SaveableDataLoader(
        datasets["train"], batch_sampler=sampler,
        num_workers=hparams["num_workers"],
        collate_fn=lambda ex: PaddedBatch(ex, shape_policy=policy),
    )
    valid_loader = SaveableDataLoader(datasets["valid"], batch_size=8)
    test_loader = SaveableDataLoader(datasets["test"], batch_size=8)
    return train_loader, valid_loader, test_loader


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the recipe's ``__main__``
    builds it (``train.py:227-272``): the manifests of ``train_splits``,
    ``dev_splits`` and ``test_splits`` (prepared unless they exist), the
    BPE tokenizer (trained on the train manifest unless its model file
    exists), the loaders, and the Brain of ``hparams["encoder"]``
    (``ConformerTransducerBrain`` or ``CRDNNTransducerBrain``) with a
    ``Checkpointer`` on ``<output_folder>/save``, a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt`` and the tokenizer.

    ``hparams`` is ``HPARAMS`` or ``HPARAMS_CRDNN``; ``overrides`` replace
    its values; ``run_opts`` are the ``Brain``'s (``device``: None for the
    CUDA card, "cpu" to ask for the CPU; ``debug``, ``staging_depth``,
    ...).  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader``, ``test_loader`` and
    ``hparams``."""
    splits = dict(hparams, **(overrides or {}))
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, [
        (key, splits[name][0]) for key, name in (
            ("train_json", "train_splits"), ("valid_json", "dev_splits"),
            ("test_json", "test_splits"))])
    run_on_main(prepare_librispeech, kwargs={
        "data_folder": hp["data_folder"],
        "save_folder": hp["save_folder"],
        "tr_splits": hp["train_splits"],
        "dev_splits": hp["dev_splits"],
        "te_splits": hp["test_splits"],
    })
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="words",
        model_type=hp["token_type"], annotation_format="json",
    )
    train_loader, valid_loader, test_loader = dataio_prepare(hp, tokenizer)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = BRAINS[hp["encoder"]](
        hp, seed=hp["seed"], run_opts=run_opts,
        hparams=dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                     epoch_counter=epoch_counter),
        checkpointer=Checkpointer(hp["save_folder"]), tokenizer=tokenizer,
    )
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": train_loader, "valid_loader": valid_loader,
            "test_loader": test_loader, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The recipe's ``__main__`` (``train.py:227-276``): ``build``, then
    ``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` on the test set from the checkpoint with
    the lowest validation loss.  Arguments as for ``build``.  Returns the
    Brain (``brain.stage_stats`` holds the last VALID loss and the TEST
    loss and WER)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="loss")
    return brain
