"""The TIMIT transducer phoneme recipes end to end, on the port.

Does what ``recipes/TIMIT/ASR/transducer/train.py`` does with
``hparams/train.yaml`` (``HPARAMS``) and ``train_wav2vec.py`` with
``hparams/train_wav2vec.yaml`` (``HPARAMS_WAV2VEC``): a TIMIT tree ->
JSON manifests (``timit_ctc.prepare_timit``, folded to 39 phones) -> the
phones as ``tokens`` and ``tokens_blank`` = [blank] + tokens through a
``CTCTextEncoder`` with ``<blank>`` at 0
(``commonvoice_asr.transducer_datasets``) -> batches of 8 read from disk,
shuffled for training -> ``CharTransducerBrain.fit``:

- ``HPARAMS``: Fbank with deltas, 120 features -> global normalization ->
  the CRDNN (2 CNN blocks of 128 and 256 channels pooling 2 and 2, a
  bidirectional LiGRU of 4 x 512, 2 DNN blocks of 512) -> ``enc_lin``
  256 (``asr.CRDNNTransducer``);
- ``HPARAMS_WAV2VEC``: the wave -> ``W2VLatentExtractor`` ->
  ``EncoderWrapper`` (12 layers at d 768, called without ``wav_lens``) ->
  ``enc_lin`` 256 (``asr.W2VTransducer``, ``W2VTransducerBrain``);

then an embedding of 256 -> a GRU of 256 -> ``dec_lin`` 256, the joint
``tanh(enc + pred)`` -> ``out_lin`` to 40 outputs, the RNN-T loss on the
kernels K8/K9; Adadelta (rho 0.95, eps 1e-8) at the NewBob rate annealed
on the validation PER of the greedy search (``valid_beam_size`` 1); the
best checkpoint by PER -> the test at beam 4 (``state_beam`` and
``expand_beam`` 2.3).  A killed run resumes from its latest checkpoint
when ``run`` is called again on the same output folder.

The yamls' values are the dicts (the files are not read); ``overrides``
replace any of them, e.g. toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import timit_transducer
    brain = timit_transducer.run("/data/TIMIT", "results/timit_rnnt",
                                 run_opts={"device": "cpu"},
                                 overrides={"rnn_layers": 1, ...})

Differences from the JAX scripts:

- The 39-phone fold is Lee and Hon's table (``timit_ctc.FOLD39``): 39
  phones and the blank fill the yamls' ``output_neurons`` 40 exactly;
  JAX's fold gives 40 phones, 41 labels, so its last phone's id is past
  the embedding's table and the output layer.  ``build`` raises when the
  inventory passes ``vocab_size``, naming its size.
- The label encoder reads the train split, then the phones only dev or
  test hold (JAX reads train alone, and raises on such a phone).
- NewBob is registered with the checkpointer (the JAX scripts register
  no schedule, so their resumed runs restart the annealing).
- The yamls' ``precision`` bf16 is the Brain's: the encoder runs in
  bfloat16 and the prediction network and joint in float32, as in
  ``asr._Transducer``; the JAX scripts never cast, so they run in
  float32.
"""

from ..asr import CRDNN_TRANSDUCER, W2V_BASE, W2VTransducer
from . import commonvoice_asr as cv
from .aishell_asr import Corpus
from .timit_ctc import prepare_timit

__all__ = ["HPARAMS", "HPARAMS_WAV2VEC", "TIMIT", "W2VTransducerBrain",
           "build", "run"]

# recipes/TIMIT/ASR/transducer/hparams/train.yaml: the CommonVoice
# transducer's values (the JAX Brain's clip 5; ``vocab_size`` is the
# yaml's output_neurons, ``beam_size`` its test_beam_size; the embedding
# and the prediction GRU are joint_dim wide) on the 39 phones
HPARAMS = dict(
    {k: v for k, v in cv.HPARAMS_TRANSDUCER_FR.items()
     if k not in ("accented_letters", "language", "duration_threshold")},
    phn_set=39,
)

# hparams/train_wav2vec.yaml: the wav2vec 2.0 base encoder
# (EncoderWrapper's dropout 0.1) in place of the features and the CRDNN
HPARAMS_WAV2VEC = dict(
    {k: v for k, v in HPARAMS.items()
     if k not in ("n_mels", "deltas", "update_until_epoch", "cnn_blocks",
                  "cnn_channels", "inter_layer_pooling_size", "rnn_layers",
                  "rnn_neurons", "dnn_blocks", "dnn_neurons", "dropout")},
    **W2V_BASE,
    encoder="wav2vec",
)


def _prepare(hp):
    prepare_timit(hp["data_folder"], save_json_train=hp["train_json"],
                  save_json_valid=hp["valid_json"],
                  save_json_test=hp["test_json"], phn_set=hp["phn_set"])


# the phones of the manifests' ``phn`` field
TIMIT = Corpus(_prepare, "phn", str.split)


class W2VTransducerBrain(cv.CharTransducerBrain):
    """``CharTransducerBrain`` on the modules of ``asr.W2VTransducer``
    (``transducer/train_wav2vec.py``): arguments as for it, with
    ``W2V_BASE``'s keys."""

    MODEL = W2VTransducer
    DEFAULTS = dict(CRDNN_TRANSDUCER, **W2V_BASE)
    MODULES = ("extractor", "encoder", "enc_lin", "emb", "dec", "dec_lin",
               "out_lin")


def _brain_class(hparams):
    return (W2VTransducerBrain if hparams.get("encoder") == "wav2vec"
            else cv.CharTransducerBrain)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with (``commonvoice_asr.
    build_transducer`` on the TIMIT tree: the manifests prepared unless
    they exist, the datasets and the label encoder, the loaders, an
    ``EpochCounter`` and the Brain of ``hparams``: ``CharTransducerBrain``
    for ``HPARAMS``, ``W2VTransducerBrain`` for ``HPARAMS_WAV2VEC``).
    Raises ``ValueError`` when the inventory passes ``vocab_size``.
    Returns its dict."""
    return cv.build_transducer(data_folder, output_folder, overrides,
                               run_opts, hparams, TIMIT,
                               _brain_class(hparams))


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The scripts' ``__main__``: ``build``, ``fit`` (resuming from the
    latest checkpoint in ``<output_folder>/save``), then ``evaluate`` at
    beam 4 from the checkpoint with the lowest validation PER.  Arguments
    as for ``build``; returns the Brain."""
    return cv.run_transducer(data_folder, output_folder, overrides, run_opts,
                             hparams, TIMIT, _brain_class(hparams))
