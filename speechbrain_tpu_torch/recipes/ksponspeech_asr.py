"""The KsponSpeech conformer recipe end to end, on the port.

Does what ``recipes/KsponSpeech/ASR/transformer/train.py`` does with
``hparams/conformer_medium.yaml`` (``HPARAMS``): the KsponSpeech
manifests (``ksponspeech_prepare.prepare_ksponspeech``; the corpus's raw
``.pcm`` audio converted first, ``ksponspeech_prepare.convert_all``) -> a
unigram ``SentencePiece`` tokenizer of 5000 pieces trained on the train
manifest's ``wrd`` -> the LibriSpeech transformer recipes' loaders
(``librispeech_asr.make_loaders``: bucketed ``DynamicBatchSampler`` batches
of 300 s) -> ``KsponASRBrain.fit`` (the conformer at d_model 256, 4
heads, 12 encoder and 6 decoder layers, d_ffn 2048; SpecAugment, bf16,
gradients accumulated over 4 batches; the validation's WER and CER from
the joint CTC/attention beam search; the best by WER kept) -> for each of
``eval_clean`` and ``eval_other``, ``evaluate(min_key="WER")`` at
``test_beam_size`` with its details in ``<output_folder>/
wer_<split>.txt``.  A killed run resumes from its latest checkpoint when
``run`` is called again on the same output folder.

The CER is the recipe's (``train.py:108-113``): over the characters of
the words joined without their spaces.  The searches fuse the yaml's
``lm_model`` (a ``TransformerLM`` at d_model 768, 12 heads) at
``lm_weight`` 0.6, CTC at 0.4, when ``run_opts["lm_ckpt"]`` names its
``state_dict``, e.g. the ``lm.ckpt`` that ``recipes.lm_training.run``
writes with ``HPARAMS_KSPON`` (``LM/hparams/transformer.yaml``) and this
recipe's tokenizer file.

``overrides`` replace any value of ``HPARAMS``, e.g. toy dims for the
CPU::

    from speechbrain_tpu_torch.recipes import ksponspeech_asr as kspon
    brain = kspon.run("/data/KsponSpeech", "results/conformer_medium",
                      run_opts={"device": "cpu"},
                      overrides={"d_model": 32, "num_encoder_layers": 1, ...})
"""

import os

from ..asr import TRANSFORMER_LM, ConformerASRBrain
from ..core import Stage
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from . import librispeech_asr
from .common import recipe_hparams
from .ksponspeech_prepare import prepare_ksponspeech

__all__ = ["HPARAMS", "KsponASRBrain", "dataio_prepare", "build", "run"]

# recipes/KsponSpeech/ASR/transformer/hparams/conformer_medium.yaml: the
# LibriSpeech conformer recipe's values but these
HPARAMS = dict(
    librispeech_asr.HPARAMS,
    seed=7775,
    train_splits=["train"],
    dev_splits=["dev"],
    test_splits=["eval_clean", "eval_other"],
    max_batch_length=300,
    number_of_epochs=100,
    grad_accumulation_factor=4,
    lr_adam=0.001,
    d_model=256,
    nhead=4,
    num_decoder_layers=6,
    d_ffn=2048,
    lm_model={k: v for k, v in TRANSFORMER_LM.items() if k != "vocab"},
)


class KsponASRBrain(ConformerASRBrain):
    """``ConformerASRBrain`` with the KsponSpeech recipe's metrics: beside
    the WER, the CER over the decoded words' characters with the spaces
    removed (Korean's standard metric); both are logged, the checkpoints
    keep the best WER, and at TEST ``hparams["wer_file"]`` (when given)
    gets the WER's details, then the CER's."""

    def on_stage_start(self, stage, epoch=None):
        """``ConformerASRBrain``'s, and a new CER metric outside
        training."""
        super().on_stage_start(stage, epoch)
        if stage != Stage.TRAIN:
            self.cer_metric = ErrorRateStats()

    def _score_words(self, ids, predicted, targets):
        super()._score_words(ids, predicted, targets)
        self.cer_metric.append(ids, [list("".join(p)) for p in predicted],
                               [list("".join(t)) for t in targets])

    def stage_metrics(self):
        """The stage's WER and CER."""
        return {"WER": self.wer_metric.summarize("error_rate"),
                "CER": self.cer_metric.summarize("error_rate")}

    def write_stats(self, stream):
        """The WER's details, then the CER's."""
        self.wer_metric.write_stats(stream)
        self.cer_metric.write_stats(stream)


def dataio_prepare(hparams, tokenizer):
    """The recipe's loaders (``train.py:254-302``): ``librispeech_asr.
    make_loaders`` over the train and dev manifests and one test loader a
    split of ``test_splits`` (``<save_folder>/<split>.json``), the
    transcripts read from ``wrd``."""
    def dataset(path):
        return librispeech_asr.make_dataset(path, hparams, tokenizer,
                                            text_key="wrd")

    tests = {split: dataset(os.path.join(hparams["save_folder"],
                                         split + ".json"))
             for split in hparams["test_splits"]}
    return librispeech_asr.make_loaders(
        hparams, dataset(hparams["train_json"]),
        dataset(hparams["valid_json"]), tests)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the recipe's ``__main__``
    builds it (``train.py:305-360``): the manifests (prepared unless they
    exist), the tokenizer (trained on the train manifest unless its model
    file exists), the loaders, and a ``KsponASRBrain`` with a
    ``Checkpointer`` on ``<output_folder>/save`` (the Noam schedule
    registered), a ``FileTrainLogger`` on ``<output_folder>/
    train_log.txt``, the tokenizer and the LM of ``run_opts["lm_ckpt"]``.

    ``overrides`` replace values of ``hparams``; ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU) and ``lm_ckpt``.  Returns a dict with ``brain``,
    ``epoch_counter``, ``train_loader``, ``valid_loader``,
    ``test_loaders`` (by split) and ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev")))
    run_on_main(prepare_ksponspeech, kwargs={
        "data_folder": hp["data_folder"],
        "save_folder": hp["save_folder"],
        "tr_splits": hp["train_splits"],
        "dev_splits": hp["dev_splits"],
        "te_splits": hp["test_splits"],
    })
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="wrd",
        model_type=hp["token_type"], annotation_format="json",
    )
    train_loader, valid_loader, test_loaders = dataio_prepare(hp, tokenizer)
    run_opts = dict(run_opts or {})
    lm = librispeech_asr.load_lm(hp, run_opts)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = KsponASRBrain(
        hp, seed=hp["seed"], run_opts=run_opts,
        hparams=dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                     epoch_counter=epoch_counter),
        checkpointer=Checkpointer(hp["save_folder"]), tokenizer=tokenizer,
        lm=lm,
    )
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": train_loader, "valid_loader": valid_loader,
            "test_loaders": test_loaders, "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The recipe's ``__main__``: ``build``, then ``librispeech_asr.
    fit_and_test`` (resuming from the latest checkpoint in
    ``<output_folder>/save``).  Arguments as for ``build``.  Returns the
    Brain."""
    return librispeech_asr.fit_and_test(build(
        data_folder, output_folder, overrides, run_opts, hparams))
