"""The Taigi -> Mandarin speech translation recipe end to end, on the
port, and its tokenizer recipe.

Does what ``recipes/Taigi/ST/transformer/train.py`` does with
``hparams/transformer.yaml`` (``HPARAMS``): the corpus's manifests
(``taigi_prepare.prepare_taigi`` with the yaml's seed 8886) -> a unigram
``SentencePiece`` of 5000 pieces at coverage 0.995 over the train
manifest's ``translation`` -> shuffled batches of 32 read from disk ->
``ST.fit``: Fbank (80 mels, 20 ms hop) -> global normalization (updated
until epoch 4) -> the conv front end -> ``TransformerST`` (a transformer
encoder of 12 layers, regularMHA, pre-norm, d_model 256, 4 heads, d_ffn
2048; 6 decoder layers; no ASR or MT branch: the corpus has no Taigi
transcripts) -> ``seq_lin``; the label-smoothed (0.1) KL of the
translation only; bf16, gradients accumulated over 2 batches, clipped at
5, Adam under Noam (0.25, 25000 warmup steps) -> outside training, on
the test set and on the epochs divisible by ``valid_search_interval``
(10), the beam search (beam 10, no CTC, length normalization, no eos
threshold, up to ``max_decode_ratio`` 1 step a frame) on the KV-cached
decoder, scored by the character BLEU and CER -> keep the best BLEU
(0.0 on epochs without a search) -> the test at ``test_beam_size`` from
the best checkpoint, its BLEU and CER written to ``bleu_file`` and
``cer_file``.  A killed run resumes from its latest checkpoint when
``run`` is called again on the same output folder.

The yaml's ``bos_index`` 1 and ``eos_index`` 2 are pieces of the unigram
tokenizer, as in the SLU recipes: the ST script trains its tokenizer with
the default (absent) bos and eos, so pieces 1 and 2 are the two most
frequent pieces after ``<unk>``.  The port copies this.

``train_tokenizer`` does what ``recipes/Taigi/Tokenizer/train.py`` does
with ``tokenizer_char5k.yaml`` (``TOKENIZER_CHAR5K``): the manifests in
``<output_folder>/manifests``, split with that yaml's seed 1234, then a
unigram model of 5000 pieces at coverage 1.0 on their train split, in
``output_folder``.  Its ``bos_id`` 1 and ``eos_id`` 2, and both
coverages, are arguments that the repo's tokenizer (and JAX's, which it
copies) takes and does not use.

Differences from the JAX script (ROADMAP Queue 3 pins each):

- The scoring.  The JAX script joins each hypothesis' and reference's
  characters with single spaces ("w o r d") and hands those strings to
  ``BLEUStats`` and ``ErrorRateStats``, which iterate a string by
  characters: the spaces count as tokens of both metrics.  It also
  appends the batch's references as one segment (``[targets]``), so each
  batch's first hypothesis is held to all of them and the others to none.
  The port makes the same strings and scores their characters without
  the spaces, each hypothesis against its own reference.
- The test search.  The JAX script sets ``valid_beam_size =
  test_beam_size`` after ``fit``, but its searcher, built on first use,
  keeps the beam it was built with; the port searches the test at
  ``test_beam_size`` (the yaml's two sizes are equal).
- The search's dtype.  As in the JAX script, the search runs in float32
  whatever the training precision (its decode program does not cast the
  features).

``overrides`` replace any value of ``HPARAMS``, e.g. toy dims for the
CPU::

    from speechbrain_tpu_torch.recipes import taigi_st
    brain = taigi_st.run("/data/taigi", "results/taigi_st",
                         run_opts={"device": "cpu"},
                         overrides={"d_model": 32, "num_encoder_layers": 1, ...})
"""

import os

import numpy as np
import torch

from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..nnet.losses import kldiv_loss
from ..st import ST_DEFAULTS, STBrain
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.bleu import BLEUStats
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from .common import recipe_hparams
from .taigi_prepare import prepare_taigi

__all__ = ["HPARAMS", "TOKENIZER_CHAR5K", "ST", "make_datasets", "build",
           "run", "train_tokenizer", "char_strings"]

# recipes/Taigi/ST/transformer/hparams/transformer.yaml
HPARAMS = dict(
    ST_DEFAULTS,
    seed=8886,
    skip_prep=False,
    hop_length=20,
    vocab_size=5000,
    token_type="unigram",
    character_coverage=0.995,
    number_of_epochs=50,
    batch_size=32,
    grad_accumulation_factor=2,
    max_grad_norm=5.0,
    sorting="random",
    precision="bf16",
    lr_adam=0.25,
    n_warmup_steps=25000,
    label_smoothing=0.1,
    valid_search_interval=10,
    valid_beam_size=10,
    test_beam_size=10,
    d_model=256,
    nhead=4,
    num_encoder_layers=12,
    num_decoder_layers=6,
    d_ffn=2048,
    transformer_dropout=0.1,
    update_until_epoch=4,
    num_workers=0,
)

# recipes/Taigi/Tokenizer/hparams/tokenizer_char5k.yaml
TOKENIZER_CHAR5K = dict(
    seed=1234,
    token_type="unigram",
    token_output=5000,
    character_coverage=1.0,
    annotation_read="translation",
    bos_id=1,
    eos_id=2,
)


def char_strings(words_lists):
    """The JAX script's scoring strings: each list of decoded words joined
    without spaces, its characters joined by single spaces
    (``train.py:84-104``)."""
    return [" ".join("".join(words)) for words in words_lists]


class ST(STBrain):
    """The Taigi script's ``ST`` Brain (``train.py:27-206``):
    ``STBrain``'s forward, the label-smoothed KL of the translation
    (``batchmean``) as the loss, and outside training, on the TEST stage
    and on epochs divisible by ``valid_search_interval``, the beam search
    (``SpeechTranslator.translate`` in float32 at ``valid_beam_size``, or
    ``test_beam_size`` at TEST) scored by ``bleu_metric`` and
    ``cer_metric`` over the characters of ``char_strings`` (see the
    module for the differences from JAX).  The VALID stage logs and keeps
    the best BLEU; the TEST stage writes ``hparams["bleu_file"]`` and
    ``hparams["cer_file"]`` when given."""

    TARGET = "tokens"

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch; BLEU and CER metrics outside
        training."""
        super().on_stage_start(stage, epoch)
        if stage != Stage.TRAIN:
            self.bleu_metric = BLEUStats()
            self.cer_metric = ErrorRateStats()

    def compute_objectives(self, predictions, batch, stage):
        """The translation's KL; outside training the search's scores."""
        st_logp = predictions[0]
        mask = batch["batch_mask"]
        loss = kldiv_loss(
            st_logp, batch["tokens_eos"],
            length=batch["tokens_eos_lens"] * mask,
            label_smoothing=self.config["label_smoothing"],
            reduction="batchmean")
        if stage == Stage.TRAIN or not hasattr(self, "bleu_metric"):
            return loss
        if (stage == Stage.TEST
                or self.epoch % self.config["valid_search_interval"] == 0):
            self.score_batch(batch, stage)
        return loss

    def search(self, batch, stage):
        """The stage's beam search on the batch's real rows: their
        hypotheses (token lists)."""
        beam = self.config["test_beam_size" if stage == Stage.TEST
                           else "valid_beam_size"]
        real = int(batch["batch_mask"].sum())
        hyps, _ = self.model.translate(batch["sig"][:real],
                                       batch["sig_lens"][:real],
                                       beam_size=beam, dtype=torch.float32)
        return hyps

    def scoring_strings(self, hyps, batch):
        """The hypotheses and the references of the real rows as the JAX
        script's strings (``char_strings`` of their decoded words)."""
        real = len(hyps)
        predicted = char_strings(
            self.tokenizer([h], task="decode_from_list")[0] for h in hyps)
        targets = char_strings(self.tokenizer(
            batch["tokens"][:real].cpu().numpy().tolist(),
            batch["tokens_lens"][:real].cpu().numpy(), task="decode"))
        return predicted, targets

    def score_batch(self, batch, stage):
        """The search's hypotheses and the references as the JAX script's
        strings, scored over their characters without the spaces."""
        predicted, targets = self.scoring_strings(self.search(batch, stage),
                                                  batch)
        ids = [str(i) for i in range(len(predicted))]
        pred_chars = [p.split() for p in predicted]
        ref_chars = [t.split() for t in targets]
        self.bleu_metric.append(ids, pred_chars, [[r] for r in ref_chars])
        self.cer_metric.append(ids, pred_chars, ref_chars)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The recipe's logging and keep-best checkpoint (``STBrain.
        log_and_keep``); at TEST the BLEU and CER files."""
        if stage == Stage.TRAIN:
            return
        stats = {"loss": stage_loss}
        if self.bleu_metric.ids:
            stats["BLEU"] = self.bleu_metric.summarize("BLEU")
            stats["CER"] = self.cer_metric.summarize("error_rate")
        self.log_and_keep(stage, stage_loss, epoch, stats)
        if stage == Stage.TEST:
            for key, metric in (("bleu_file", self.bleu_metric),
                                ("cer_file", self.cer_metric)):
                path = getattr(self.hparams, key, None)
                if path:
                    with open(path, "w") as f:
                        metric.write_stats(f)


def make_datasets(hparams, tokenizer, text_key="translation"):
    """The train, valid and test datasets (``hparams["<split>_json"]``):
    ``sig``, and ``text_key`` encoded by ``tokenizer`` as ``tokens``,
    ``tokens_bos`` ([bos_index] + tokens) and ``tokens_eos`` (tokens +
    [eos_index]), with ``id``.  Returns a dict by split name."""
    out = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

        def text_pipeline(text):
            tokens = tokenizer.sp.encode_as_ids(text)
            return (np.asarray(tokens, np.int64),
                    np.asarray([hparams["bos_index"]] + tokens, np.int64),
                    np.asarray(tokens + [hparams["eos_index"]], np.int64))

        ds.add_dynamic_item(text_pipeline, takes=text_key,
                            provides=["tokens", "tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "sig", "tokens", "tokens_bos",
                            "tokens_eos"])
        out[split] = ds
    return out


def loaders(hparams, datasets):
    """Batches of ``batch_size`` in manifest order (the train loader
    shuffled when ``sorting`` is "random")."""
    bs, workers = hparams["batch_size"], hparams.get("num_workers", 0)
    return {split: SaveableDataLoader(
        ds, batch_size=bs, num_workers=workers,
        shuffle=split == "train" and hparams.get("sorting") == "random")
        for split, ds in datasets.items()}


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the script's ``__main__``
    builds it (``train.py:262-298``): the manifests (prepared unless they
    exist), the tokenizer (trained on the train manifest unless its model
    file exists), the loaders, and an ``ST`` Brain with a ``Checkpointer``
    on ``<output_folder>/save`` (the Noam schedule registered), a
    ``FileTrainLogger`` on ``<output_folder>/train_log.txt``, the
    ``bleu_file`` and ``cer_file`` in ``output_folder`` and the tokenizer.

    ``overrides`` replace values of ``hparams``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU).  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader``, ``test_loader``, ``tokenizer``
    and ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev"),
        ("test_json", "test")))
    hp.setdefault("bleu_file", os.path.join(output_folder, "bleu.txt"))
    hp.setdefault("cer_file", os.path.join(output_folder, "cer.txt"))
    run_on_main(prepare_taigi, kwargs={
        "dataset_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "seed": hp["seed"], "skip_prep": hp["skip_prep"]})
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="translation",
        model_type=hp["token_type"], annotation_format="json",
        character_coverage=hp["character_coverage"])
    lds = loaders(hp, make_datasets(hp, tokenizer))
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = ST(hp, seed=hp["seed"], run_opts=run_opts,
               hparams=dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                            epoch_counter=epoch_counter),
               checkpointer=Checkpointer(hp["save_folder"]),
               tokenizer=tokenizer)
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": lds["train"], "valid_loader": lds["valid"],
            "test_loader": lds["test"], "tokenizer": tokenizer,
            "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The script's ``__main__``: ``build``, ``fit`` (resuming from the
    latest checkpoint in ``<output_folder>/save``), then ``evaluate`` on
    the test set at ``test_beam_size`` from the checkpoint with the best
    BLEU.  Arguments as for ``build``; returns the Brain
    (``brain.stage_stats`` holds the last VALID and TEST stats)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], max_key="BLEU")
    return brain


def train_tokenizer(data_folder, output_folder, hparams=TOKENIZER_CHAR5K,
                    overrides=None):
    """``recipes/Taigi/Tokenizer/train.py``: the manifests in
    ``<output_folder>/manifests`` (``prepare_taigi`` at the yaml's seed),
    then a ``SentencePiece`` of ``token_output`` pieces of ``token_type``
    on the train manifest's ``annotation_read``, checked on dev and test,
    saved in ``output_folder`` (kept when its file exists).  Returns the
    tokenizer."""
    hp = dict(hparams, **(overrides or {}))
    save = os.path.join(output_folder, "manifests")
    run_on_main(prepare_taigi, kwargs={
        "dataset_folder": data_folder, "save_folder": save,
        "seed": hp["seed"]})
    return SentencePiece(
        model_dir=output_folder, vocab_size=hp["token_output"],
        annotation_train=f"{save}/train.json",
        annotation_read=hp["annotation_read"],
        model_type=hp["token_type"],
        character_coverage=hp["character_coverage"],
        annotation_list_to_check=[f"{save}/dev.json", f"{save}/test.json"],
        annotation_format="json", bos_id=hp["bos_id"], eos_id=hp["eos_id"])
