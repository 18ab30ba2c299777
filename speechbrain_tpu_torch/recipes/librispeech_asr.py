"""The LibriSpeech conformer recipe end to end, on the port.

Does what ``recipes/LibriSpeech/ASR/transformer/train.py`` does with
``hparams/conformer_small.yaml`` (``HPARAMS``) or ``hparams/
transformer.yaml`` (``HPARAMS_TRANSFORMER``: a transformer encoder at
d_model 512, 6 decoder layers, its LM at d_model 512;
``run(..., hparams=HPARAMS_TRANSFORMER)``): LibriSpeech folders -> JSON manifests
(``prepare_librispeech``, a copy of
``recipes/LibriSpeech/librispeech_prepare.py``) -> a unigram
``SentencePiece`` tokenizer trained on the train manifest -> bucketed
dynamic batches of audio files read from disk (``dataio_prepare``) ->
``ConformerASRBrain.fit`` with checkpoints (the brain, its train state,
the Noam schedule, the train loader and the epoch counter; the best by
validation WER is kept) -> ``evaluate(min_key="WER")`` on the test set at
``test_beam_size``.  A killed run resumes from its latest checkpoint
when ``run`` is called again on the same output folder.

The yaml's values are ``HPARAMS`` (the yaml file itself is not read);
``overrides`` replace any of them, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import librispeech_asr
    brain = librispeech_asr.run(
        "/data/LibriSpeech", "results/conformer_small",
        run_opts={"device": "cpu"},
        overrides={"d_model": 32, "num_encoder_layers": 1, ...})

The recipe fuses a language model only when trained LM parameters are
attached (``train.py:108-116``): here when ``run_opts["lm_ckpt"]`` names a
local file holding the ``state_dict`` of the yaml's ``lm_model`` (a
``TransformerLM``, ``lm_model`` of ``HPARAMS``), e.g. the ``lm.ckpt`` that
``recipes.lm_training.run`` writes with ``HPARAMS_TRANSFORMER`` and this
recipe's tokenizer file; the searches then fuse it at ``lm_weight``.
Without one they decode without an LM.
"""

import json
import logging
import os
import wave

import numpy as np

import torch

from ..asr import (
    CONFORMER_SMALL,
    TRANSFORMER_LM,
    ConformerASRBrain,
    build_transformer_lm,
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

logger = logging.getLogger(__name__)

__all__ = ["HPARAMS", "HPARAMS_TRANSFORMER", "prepare_librispeech",
           "make_dataset", "make_datasets", "make_loaders", "dataio_prepare",
           "load_lm", "fit_and_test", "build", "run",
           "write_synthetic_librispeech"]

SAMPLERATE = 16000

# recipes/LibriSpeech/ASR/transformer/hparams/conformer_small.yaml, on
# top of asr.CONFORMER_SMALL (the model's dims and training values)
HPARAMS = dict(
    CONFORMER_SMALL,
    seed=7775,
    train_splits=["train-clean-100", "train-clean-360", "train-other-500"],
    dev_splits=["dev-clean"],
    test_splits=["test-clean", "test-other"],
    vocab_size=5000,
    token_type="unigram",
    max_batch_length=200,
    num_buckets=10,
    num_workers=4,
    number_of_epochs=120,
    grad_accumulation_factor=2,
    precision="bf16",
    valid_beam_size=10,
    test_beam_size=66,
    lm_weight=0.6,
    # lm_model (conformer_small.yaml:121-126), over vocab_size tokens
    lm_model={k: v for k, v in TRANSFORMER_LM.items() if k != "vocab"},
)

# recipes/LibriSpeech/ASR/transformer/hparams/transformer.yaml: the same
# recipe with a transformer encoder (regularMHA, the absolute PE on its
# input) at d_model 512, and its lm_model (transformer.yaml:121-126)
HPARAMS_TRANSFORMER = dict(
    HPARAMS,
    d_model=512,
    nhead=8,
    num_decoder_layers=6,
    d_ffn=2048,
    encoder_module="transformer",
    attention_type="regularMHA",
    lm_model=dict(HPARAMS["lm_model"], d_model=512, nhead=8, d_ffn=2048),
)


def _audio_duration_seconds(path):
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    if path.endswith(".flac"):
        # Estimate from the file size (FLAC ~ 0.55 of 16-bit PCM), as
        # the JAX recipe does without soundfile.
        return os.path.getsize(path) / (SAMPLERATE * 2 * 0.55)
    raise ValueError(f"Unknown audio format: {path}")


def prepare_librispeech(data_folder, save_folder,
                        tr_splits=("train-clean-100",),
                        dev_splits=("dev-clean",),
                        te_splits=("test-clean",),
                        merge_lst=None, merge_name=None, skip_prep=False):
    """Create one JSON manifest per split (``<save_folder>/<split>.json``:
    id -> wav path, duration, words, spk_id) from a LibriSpeech tree of
    ``<split>/<spk>/<chapter>/<id>.{flac,wav}`` and ``*.trans.txt``;
    ``merge_lst`` splits are also merged into ``merge_name``.  A
    manifest that exists is kept."""
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    for split in list(tr_splits) + list(dev_splits) + list(te_splits):
        save_json = os.path.join(save_folder, f"{split}.json")
        if os.path.exists(save_json):
            logger.info(f"{save_json} exists, skipping")
            continue
        split_dir = os.path.join(data_folder, split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"Missing split dir: {split_dir}")
        manifest = {}
        for root, _, files in os.walk(split_dir):
            for tf in (f for f in files if f.endswith(".trans.txt")):
                with open(os.path.join(root, tf)) as f:
                    for line in f:
                        utt_id, words = line.strip().split(" ", 1)
                        audio = None
                        for ext in (".flac", ".wav"):
                            cand = os.path.join(root, utt_id + ext)
                            if os.path.exists(cand):
                                audio = cand
                                break
                        if audio is None:
                            continue
                        manifest[utt_id] = {
                            "wav": audio,
                            "duration": round(
                                _audio_duration_seconds(audio), 3),
                            "words": words,
                            "spk_id": utt_id.rsplit("-", 2)[0],
                        }
        with open(save_json, "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info(f"Prepared {save_json} ({len(manifest)} utterances)")
    if merge_lst and merge_name:
        merged_path = os.path.join(save_folder, merge_name)
        if not os.path.exists(merged_path):
            merged = {}
            for split in merge_lst:
                with open(os.path.join(save_folder, f"{split}.json")) as f:
                    merged.update(json.load(f))
            with open(merged_path, "w") as f:
                json.dump(merged, f, indent=2)


def make_dataset(path, hparams, tokenizer, text_key="words",
                 audio=read_audio, audio_keys="wav"):
    """One split of the transformer recipes: the manifest at ``path``,
    its audio (``sig``, ``audio`` over the manifest's ``audio_keys``)
    and its ``text_key`` encoded by ``tokenizer`` (``tokens``,
    ``tokens_bos`` = [bos_index] + tokens, ``tokens_eos`` = tokens +
    [eos_index]), with ``id``."""
    ds = DynamicItemDataset.from_json(path)
    ds.add_dynamic_item(audio, takes=audio_keys, provides="sig")

    def text_pipeline(words):
        tokens = tokenizer.sp.encode_as_ids(words)
        return (
            np.asarray(tokens, np.int64),
            np.asarray([hparams["bos_index"]] + tokens, np.int64),
            np.asarray(tokens + [hparams["eos_index"]], np.int64),
        )

    ds.add_dynamic_item(text_pipeline, takes=text_key,
                        provides=["tokens", "tokens_bos", "tokens_eos"])
    ds.set_output_keys(["id", "sig", "tokens", "tokens_bos", "tokens_eos"])
    return ds


def make_datasets(hparams, tokenizer):
    """The train, valid and test datasets of the LibriSpeech recipes
    (``hparams["<split>_json"]``, ``make_dataset``).  Returns a dict by
    split name."""
    return {split: make_dataset(hparams[f"{split}_json"], hparams, tokenizer)
            for split in ("train", "valid", "test")}


def make_loaders(hparams, train, valid, tests,
                 token_buckets=(16, 32, 64, 128, 256, 512)):
    """The transformer recipes' loaders: training batches from a
    ``DynamicBatchSampler`` over ``train`` (``max_batch_length`` seconds a
    batch, ``num_buckets``, shuffled) padded by the recipes'
    ``BatchShapePolicy`` (time to the sampler's bucket boundaries, tokens
    to ``token_buckets``, the batch dim to powers of two from 2 with
    dummy rows); ``valid`` and each dataset of the dict ``tests`` in
    batches of 8 in manifest order.  Returns ``(train_loader,
    valid_loader, {name: test_loader})``."""
    sampler = DynamicBatchSampler(
        train, max_batch_length=hparams["max_batch_length"],
        num_buckets=hparams["num_buckets"], shuffle=True)
    sr = hparams["sample_rate"]
    policy = BatchShapePolicy(
        time_buckets=[int(b * sr) for b in sampler.bucket_boundaries],
        time_keys=("sig",),
        key_buckets={k: list(token_buckets)
                     for k in ("tokens", "tokens_bos", "tokens_eos")},
        batch_buckets=[2, 4, 8, 16, 32, 64, 128],
    )
    train_loader = SaveableDataLoader(
        train, batch_sampler=sampler, num_workers=hparams["num_workers"],
        collate_fn=lambda ex: PaddedBatch(ex, shape_policy=policy),
    )
    return (train_loader, SaveableDataLoader(valid, batch_size=8),
            {name: SaveableDataLoader(ds, batch_size=8)
             for name, ds in tests.items()})


def dataio_prepare(hparams, tokenizer):
    """The recipe's three loaders (``train.py:226-292``): ``make_loaders``
    over ``make_datasets``' splits."""
    datasets = make_datasets(hparams, tokenizer)
    train_loader, valid_loader, tests = make_loaders(
        hparams, datasets["train"], datasets["valid"],
        {"test": datasets["test"]})
    return train_loader, valid_loader, tests["test"]


def load_lm(hp, run_opts):
    """The yaml's ``lm_model`` (a ``TransformerLM`` over ``vocab_size``
    tokens) loaded from ``run_opts["lm_ckpt"]`` (popped), or None without
    one."""
    lm_ckpt = run_opts.pop("lm_ckpt", None)
    if lm_ckpt is None:
        return None
    lm = build_transformer_lm(dict(hp["lm_model"], vocab=hp["vocab_size"]),
                              device="cpu")
    lm.load_state_dict(torch.load(lm_ckpt, map_location="cpu",
                                  weights_only=True))
    return lm


def fit_and_test(parts):
    """What the KsponSpeech and Switchboard transformer scripts do after
    building (KsponSpeech ``train.py:361-377``): ``fit``, then each of
    ``parts["test_loaders"]`` at ``test_beam_size`` from the checkpoint
    with the best validation WER, its details in ``<output_folder>/
    wer_<split>.txt``.  Returns the Brain; ``brain.test_stats`` holds each
    split's TEST stats."""
    brain, hp = parts["brain"], parts["hparams"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.config["valid_beam_size"] = hp["test_beam_size"]
    brain.test_stats = {}
    for split, loader in parts["test_loaders"].items():
        brain.hparams.wer_file = os.path.join(hp["output_folder"],
                                              f"wer_{split}.txt")
        brain.evaluate(loader, min_key="WER")
        brain.test_stats[split] = dict(brain.stage_stats["TEST"])
    return brain


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the recipe's
    ``__main__`` builds it (``train.py:295-345``): the manifests
    (prepared unless they exist), the tokenizer (trained on the train
    manifest unless its model file exists), the loaders, and a
    ``ConformerASRBrain`` with a ``Checkpointer`` on ``<output_folder>/
    save`` (the Noam schedule registered; ``fit`` adds the train loader
    and the epoch counter), a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt`` and the tokenizer.

    ``hparams`` is ``HPARAMS`` (conformer_small.yaml) or
    ``HPARAMS_TRANSFORMER`` (transformer.yaml); ``overrides`` replace its
    values; ``run_opts`` are the ``Brain``'s (``device``: None for the CUDA
    card, "cpu" to ask for the CPU; ``debug``, ``staging_depth``, ...) and
    ``lm_ckpt`` (the ``TransformerLM`` to fuse, see the module).  Returns a
    dict with ``brain``, ``epoch_counter``, ``train_loader``,
    ``valid_loader``, ``test_loader`` and ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev-clean"),
        ("test_json", "test-clean")))
    run_on_main(prepare_librispeech, kwargs={
        "data_folder": hp["data_folder"],
        "save_folder": hp["save_folder"],
        "tr_splits": hp["train_splits"],
        "dev_splits": hp["dev_splits"],
        "te_splits": hp["test_splits"],
        "merge_lst": hp["train_splits"],
        "merge_name": "train.json",
    })
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="words",
        model_type=hp["token_type"], annotation_format="json",
    )
    train_loader, valid_loader, test_loader = dataio_prepare(hp, tokenizer)
    run_opts = dict(run_opts or {})
    lm = load_lm(hp, run_opts)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = ConformerASRBrain(
        hp, seed=hp["seed"], run_opts=run_opts,
        hparams=dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                     epoch_counter=epoch_counter),
        checkpointer=Checkpointer(hp["save_folder"]), tokenizer=tokenizer,
        lm=lm,
    )
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": train_loader, "valid_loader": valid_loader,
            "test_loader": test_loader, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The recipe's ``__main__`` (``train.py:295-358``): ``build``, then
    ``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` on the test set at ``test_beam_size``
    from the checkpoint with the best validation WER.  Arguments as for
    ``build``.  Returns the Brain (``brain.stage_stats`` holds the last
    VALID and TEST loss and WER)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.config["valid_beam_size"] = parts["hparams"]["test_beam_size"]
    brain.evaluate(parts["test_loader"], min_key="WER")
    return brain


def write_synthetic_librispeech(folder, counts, seconds=(4.0, 14.0),
                                n_words=(20, 30), lexicon_size=2000,
                                seed=0):
    """Write a LibriSpeech-shaped tree of synthetic utterances, for
    trying the recipe without the corpus: ``counts`` maps a split name
    to its number of utterances, each a 16 kHz 16-bit PCM WAV of noise
    plus two tones lasting ``seconds`` (uniform), with a transcript of
    ``n_words`` words (uniform) drawn from a lexicon of ``lexicon_size``
    uppercase words.  Everything comes from ``seed``.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_librispeech(d, {"dev-clean": 2}, seconds=(0.5, 1.0))
    >>> prepare_librispeech(d, d + "/save", tr_splits=(), te_splits=())
    >>> sorted(json.load(open(d + "/save/dev-clean.json")))
    ['1-1-0000', '1-1-0001']
    """
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ'"))
    lexicon = sorted({"".join(rng.choice(letters[:26], rng.integers(2, 10)))
                      for _ in range(lexicon_size)})
    for s, (split, n) in enumerate(sorted(counts.items())):
        chapter = os.path.join(folder, split, str(s + 1), "1")
        os.makedirs(chapter, exist_ok=True)
        lines = []
        for i in range(n):
            utt = f"{s + 1}-1-{i:04d}"
            samples = int(rng.uniform(*seconds) * SAMPLERATE)
            t = np.arange(samples) / SAMPLERATE
            f1, f2 = rng.uniform(100, 3000, 2)
            sig = (0.05 * rng.standard_normal(samples)
                   + 0.2 * np.sin(2 * np.pi * f1 * t)
                   + 0.1 * np.sin(2 * np.pi * f2 * t))
            pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
            with wave.open(os.path.join(chapter, utt + ".wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLERATE)
                w.writeframes(pcm.tobytes())
            words = rng.choice(lexicon, rng.integers(n_words[0],
                                                     n_words[1] + 1))
            lines.append(f"{utt} {' '.join(words)}")
        with open(os.path.join(chapter, f"{s + 1}-1.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
