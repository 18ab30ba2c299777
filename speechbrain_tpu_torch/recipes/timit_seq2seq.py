"""The TIMIT CRDNN seq2seq phoneme recipe end to end, on the port, and
the teachers of its knowledge distillation.

Does what ``recipes/TIMIT/ASR/seq2seq/train.py`` does with
``hparams/train.yaml`` (``HPARAMS``), and what
``recipes/TIMIT/ASR/seq2seq_knowledge_distillation/train_teacher.py``
(the same script) does with ``hparams/teachers/tea{0..9}.yaml``
(``TEACHERS``, each the overrides of ``HPARAMS`` its yaml makes): a TIMIT
tree -> JSON manifests (``timit_ctc.prepare_timit``, folded to 39 phones)
-> a ``CTCTextEncoder`` of the train set's phones with the blank, bos and
eos at 0, 1 and 2 (``timit_ctc.dataio_prep(seq2seq=True)``) -> batches
of 8 read from disk, shuffled for training -> ``ASR.fit`` (Fbank with
deltas, 120 features -> global ``InputNormalization`` -> cast to the
activation dtype -> a ``CRDNN`` (``rnn_class`` "ligru", "lstm" or "gru")
-> an ``AttentionalRNNDecoder`` (GRU, location attention) over the phone
embeddings -> ``seq_lin``, and ``ctc_lin`` on the encoder states; the
loss ``ctc_weight`` x CTC (on the kernels K3/K4) + (1 - ``ctc_weight``)
x NLL in every epoch; Adadelta at the NewBob-annealed rate; the
validation's phone error rate from ``S2SRNNBeamSearcher`` at beam 8;
checkpoints keep the best by PER) -> ``evaluate(min_key="PER")`` at beam
16.  A killed run resumes from its latest checkpoint when ``run`` is
called again on the same output folder.

The yaml's values are ``HPARAMS`` (the yaml file itself is not read);
``overrides`` replace any of them, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import timit_seq2seq
    brain = timit_seq2seq.run("/data/TIMIT", "results/timit_seq2seq",
                              run_opts={"device": "cpu"},
                              overrides={"cnn_channels": (4, 4), ...})
    teacher = timit_seq2seq.run("/data/TIMIT", "results/teachers/tea3",
                                overrides=timit_seq2seq.TEACHERS["tea3"])

``HPARAMS_WAV2VEC`` is ``hparams/train_with_wav2vec2.yaml``
(``train_with_wav2vec2.py``): the same recipe with the wav2vec 2.0 base
encoder in place of the Fbank and the CRDNN (``encoder`` "wav2vec": the
wave -> ``W2VLatentExtractor`` -> ``EncoderWrapper``, 12 layers at d 768,
called without ``wav_lens`` -> ``enc_dnn``, a ``VanillaNN`` of 2 x 512 ->
the decoder and ``ctc_lin``).

Differences from the JAX recipes, as in ``timit_ctc``: the 39-phone fold
is Lee and Hon's table (JAX's gives 40 phones, 43 labels with the blank,
bos and eos, one more than the yamls' ``output_neurons`` 42; ``build``
raises when the inventory passes ``output_neurons``, naming its size,
where JAX's labels would pass the heads), and the Brain registers the
NewBob schedule with its checkpointer.  The wav2vec yaml's ``precision``
bf16 is the Brain's (the JAX script never casts, so it runs in float32).
"""

import logging
import os

import numpy as np
import torch

from ..asr import W2V_BASE, _random_init, wav2vec_encoder
from ..core import Stage
from ..dataio.dataloader import SaveableDataLoader
from ..decoders.seq2seq import S2SRNNBeamSearcher
from ..lobes.features import Fbank
from ..lobes.models.CRDNN import CRDNN
from ..lobes.models.VanillaNN import VanillaNN
from ..nnet.embedding import Embedding
from ..nnet.linear import Linear
from ..nnet.losses import ctc_loss, nll_loss
from ..nnet.RNN import AttentionalRNNDecoder
from ..processing.features import InputNormalization
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from .common import NewBobBrain, at_least_f32, recipe_hparams
from .librispeech_seq2seq import wav2vec_states
from .timit_ctc import dataio_prep, prepare_timit

logger = logging.getLogger(__name__)

__all__ = ["HPARAMS", "HPARAMS_WAV2VEC", "TEACHERS", "build_modules", "ASR",
           "build", "run"]

# recipes/TIMIT/ASR/seq2seq/hparams/train.yaml (with the JAX Brain's
# gradient clip, 5, and InputNormalization's update_until_epoch, 3)
HPARAMS = dict(
    seed=1234,
    sample_rate=16000,
    n_mels=40,
    deltas=True,
    batch_size=8,
    number_of_epochs=50,
    lr=1.0,
    ctc_weight=0.5,
    precision="bf16",
    blank_index=0,
    bos_index=1,
    eos_index=2,
    output_neurons=42,  # 39 phones + blank, bos and eos
    phn_set=39,
    update_until_epoch=3,
    cnn_blocks=2,
    cnn_channels=(128, 256),
    inter_layer_pooling_size=(2, 2),
    rnn_class="ligru",
    rnn_layers=4,
    rnn_neurons=512,
    rnn_bidirectional=True,
    dnn_blocks=2,
    dnn_neurons=512,
    emb_size=128,
    dec_neurons=256,
    attn_dim=256,
    dropout=0.15,
    min_decode_ratio=0.0,
    max_decode_ratio=1.0,
    valid_beam_size=8,
    test_beam_size=16,
    eos_threshold=1.5,
    using_max_attn_shift=True,
    max_attn_shift=240,
    coverage_penalty=1.5,
    ctc_weight_decode=0.0,
    # opt_class (optax.adadelta) and lr_annealing (NewBobScheduler)
    rho=0.95,
    eps=1e-8,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)

# recipes/TIMIT/ASR/seq2seq/hparams/train_with_wav2vec2.yaml: the
# wav2vec 2.0 base encoder (EncoderWrapper's dropout 0.1) and enc_dnn (2
# x dnn_neurons) in place of the features and the CRDNN; the rest is
# train.yaml's
HPARAMS_WAV2VEC = dict(
    {k: v for k, v in HPARAMS.items()
     if k not in ("n_mels", "deltas", "update_until_epoch", "cnn_blocks",
                  "cnn_channels", "inter_layer_pooling_size", "rnn_class",
                  "rnn_layers", "rnn_neurons", "rnn_bidirectional")},
    **W2V_BASE,
    encoder="wav2vec",
)

# seq2seq_knowledge_distillation/hparams/teachers/tea{i}.yaml: each is
# train.yaml with these values changed (and its own output folder)
TEACHERS = {
    "tea0": {},
    "tea1": {"rnn_neurons": 256, "dnn_neurons": 256},
    "tea2": {"rnn_layers": 3},
    "tea3": {"rnn_class": "lstm"},
    "tea4": {"rnn_class": "lstm", "rnn_neurons": 256, "dnn_neurons": 256},
    "tea5": {"rnn_class": "gru"},
    "tea6": {"rnn_class": "gru", "rnn_neurons": 256, "dnn_neurons": 256},
    "tea7": {"cnn_channels": (64, 128)},
    "tea8": {"dropout": 0.25},
    "tea9": {"rnn_layers": 5},
}


def build_modules(hparams, seed=0):
    """The recipe's modules, with Lecun-normal weights and orthogonal
    recurrent ones from ``seed`` (``asr._random_init``):
    ``compute_features`` (``Fbank``, deltas on: 3 n_mels features),
    ``normalize`` (global ``InputNormalization``), ``enc`` (``CRDNN`` of
    ``rnn_class``), ``emb`` (``Embedding``), ``dec``
    (``AttentionalRNNDecoder``: GRU, location attention), ``ctc_lin`` and
    ``seq_lin`` (``Linear`` to ``output_neurons``).  With ``encoder``
    "wav2vec" (``HPARAMS_WAV2VEC``): ``extractor``, ``encoder``
    (``asr.wav2vec_encoder``) and ``enc_dnn`` (``VanillaNN``) in place of
    the features, the normalization and the CRDNN."""
    hp = dict(HPARAMS, **hparams)
    V = hp["output_neurons"]
    if hp.get("encoder") == "wav2vec":
        front = wav2vec_encoder(hp)
        front["enc_dnn"] = VanillaNN(hp["embedding_dim"], hp["dnn_blocks"],
                                     hp["dnn_neurons"])
        width = hp["dnn_neurons"]
    else:
        n_feats = hp["n_mels"] * (3 if hp["deltas"] else 1)
        enc = CRDNN(
            input_size=n_feats, cnn_blocks=hp["cnn_blocks"],
            cnn_channels=hp["cnn_channels"],
            inter_layer_pooling_size=hp["inter_layer_pooling_size"],
            rnn_class=hp["rnn_class"], rnn_layers=hp["rnn_layers"],
            rnn_neurons=hp["rnn_neurons"],
            rnn_bidirectional=hp["rnn_bidirectional"],
            dnn_blocks=hp["dnn_blocks"], dnn_neurons=hp["dnn_neurons"],
            dropout=hp["dropout"])
        front = {
            "compute_features": Fbank(sample_rate=hp["sample_rate"],
                                      n_mels=hp["n_mels"],
                                      deltas=hp["deltas"]),
            "normalize": InputNormalization(
                n_feats, update_until_epoch=hp["update_until_epoch"]),
            "enc": enc}
        width = enc.output_size
    modules = {
        **front,
        "emb": Embedding(V, hp["emb_size"]),
        "dec": AttentionalRNNDecoder(
            "gru", "location", hidden_size=hp["dec_neurons"],
            attn_dim=hp["attn_dim"], enc_dim=width,
            input_size=hp["emb_size"], num_layers=1, dropout=hp["dropout"]),
        "ctc_lin": Linear(width, V),
        "seq_lin": Linear(hp["dec_neurons"], V),
    }
    gen = torch.Generator().manual_seed(seed)
    for name in ("extractor", "encoder", "enc_dnn", "enc", "emb", "dec",
                 "ctc_lin", "seq_lin"):
        if name in modules:
            _random_init(modules[name], gen)
    return modules


class ASR(NewBobBrain):
    """The TIMIT seq2seq recipe's ``ASR`` Brain (``train.py:27-159``),
    also the distillation's teacher.

    ``compute_forward``: ``Fbank`` with deltas -> ``InputNormalization``
    (updated in training until ``update_until_epoch``) -> cast to the
    activation dtype -> ``enc`` (``HPARAMS_WAV2VEC``: the wave through
    ``librispeech_seq2seq.wav2vec_states``) -> ``dec`` over
    ``emb(phn_encoded_bos)``
    -> float32 (float64 under a float64 ``self.dtype``) log-softmax of
    ``seq_lin``, and of ``ctc_lin`` on the encoder states; returns
    ``(ctc log-probs, seq log-probs, encoder states)``.
    ``compute_objectives``: ``ground_truth_loss``, ``ctc_weight`` x
    ``ctc_loss`` (K3/K4 on the card; lengths ``sig_lens * batch_mask``
    and ``phn_encoded_lens * batch_mask``) + (1 - ``ctc_weight``) x
    ``nll_loss`` of ``phn_encoded_eos`` (lengths ``phn_encoded_eos_lens *
    batch_mask``), in every epoch; outside training the beam search
    (``make_searcher``: beam ``valid_beam_size`` or ``test_beam_size``)
    decodes the real rows, whose phones go to the PER through
    ``label_encoder.decode_ndim``.

    The optimizer is ``torch.optim.Adadelta(rho, eps)`` after the clip to
    ``max_grad_norm``, at ``self.lr`` from ``NewBobBrain``'s schedule on
    the validation PER.  ``on_stage_end`` at VALID logs ``loss`` and
    ``PER`` and keeps the checkpoint with the lowest PER; at TEST it logs
    them with the epoch loaded and writes ``hparams["per_file"]`` (when
    given).

    Example
    -------
    >>> hp = {"cnn_channels": (2, 2), "rnn_layers": 1, "rnn_neurons": 4,
    ...       "dnn_blocks": 1, "dnn_neurons": 4, "n_mels": 8, "emb_size": 4,
    ...       "dec_neurons": 6, "attn_dim": 5, "output_neurons": 7,
    ...       "rnn_class": "gru"}
    >>> brain = ASR(hp, run_opts={"device": "cpu", "precision": "fp32"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(2, 4000)).astype(np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "phn_encoded": np.array([[3, 4], [5, 0]]),
    ...     "phn_encoded_lens": np.array([1.0, 0.5], np.float32),
    ...     "phn_encoded_bos": np.array([[1, 3, 4], [1, 5, 0]]),
    ...     "phn_encoded_eos": np.array([[3, 4, 2], [5, 2, 0]]),
    ...     "phn_encoded_eos_lens": np.array([1.0, 2 / 3], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    metric = "PER"
    best = "min"

    def __init__(self, hparams=None, run_opts=None, checkpointer=None,
                 label_encoder=None):
        hp = dict(HPARAMS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adadelta(params, lr=hp["lr"], rho=hp["rho"],
                                        eps=hp["eps"], weight_decay=0)

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        self.label_encoder = label_encoder
        self.epoch = 0
        self.use_kernels = True

    @staticmethod
    def make_datasets(hparams):
        """The datasets this Brain reads and their label encoder:
        ``timit_ctc.dataio_prep(seq2seq=True)``'s."""
        return dataio_prep(hparams, seq2seq=True)

    def set_kernels(self, flag=True):
        """Run the CTC losses on the kernels (True) or on their plain
        recursions (False)."""
        self.use_kernels = bool(flag)
        return self

    def compute_forward(self, batch, stage):
        """See the class."""
        m = self.modules
        if "extractor" in m:
            enc = wav2vec_states(m, batch["sig"], self.dtype)
        else:
            feats = m.compute_features(batch["sig"])
            feats = m.normalize(feats, batch["sig_lens"], epoch=self.epoch)
            enc = m.enc(feats.to(self.dtype), lengths=batch["sig_lens"])
        emb = m.emb(batch["phn_encoded_bos"]).to(self.dtype)
        dec_out, _ = m.dec(emb, enc, batch["sig_lens"])
        seq_logp = torch.log_softmax(at_least_f32(m.seq_lin(dec_out)), -1)
        ctc_logp = torch.log_softmax(at_least_f32(m.ctc_lin(enc)), -1)
        return ctc_logp, seq_logp, enc

    def ground_truth_loss(self, ctc_logp, seq_logp, batch):
        """``ctc_weight`` x CTC + (1 - ``ctc_weight``) x NLL on the
        batch's phones."""
        hp = self.hparams
        mask = batch["batch_mask"]
        loss_ctc = ctc_loss(ctc_logp, batch["phn_encoded"],
                            batch["sig_lens"] * mask,
                            batch["phn_encoded_lens"] * mask,
                            blank_index=hp.blank_index,
                            use_kernels=self.use_kernels)
        loss_seq = nll_loss(seq_logp, batch["phn_encoded_eos"],
                            length=batch["phn_encoded_eos_lens"] * mask)
        return hp.ctc_weight * loss_ctc + (1 - hp.ctc_weight) * loss_seq

    def compute_objectives(self, predictions, batch, stage):
        """The joint loss; outside training, the search's PER."""
        ctc_logp, seq_logp, enc = predictions
        loss = self.ground_truth_loss(ctc_logp, seq_logp, batch)
        self._score(enc, batch, stage)
        return loss

    def _score(self, enc, batch, stage):
        if stage == Stage.TRAIN or not hasattr(self, "per_metrics"):
            return
        hyps, _ = self.searcher(enc, batch["sig_lens"])
        real = int(batch["batch_mask"].sum())
        self.per_metrics.append(
            [str(i) for i in range(real)], hyps[:real],
            batch["phn_encoded"][:real].cpu().numpy().tolist(),
            target_len=batch["phn_encoded_lens"][:real].cpu().numpy(),
            ind2lab=self.label_encoder.decode_ndim)

    def make_searcher(self, beam_size):
        """The recipe's ``S2SRNNBeamSearcher`` over the Brain's modules
        (``train.py:94-127``: eos threshold, attention shift and coverage
        as the yaml sets them, no CTC in the scores, temperature 1)."""
        m, hp = self.modules, self.hparams
        return S2SRNNBeamSearcher(
            embedding_fn=lambda t: m.emb(t).to(self.dtype),
            decoder_step_fn=m.dec.forward_step, linear_fn=m.seq_lin,
            dec_hidden_size=hp.dec_neurons, attn_init_fn=m.dec.attn_init,
            rnn_init_fn=m.dec.rnn.init_state, ctc_linear_fn=m.ctc_lin,
            bos_index=hp.bos_index, eos_index=hp.eos_index,
            blank_index=hp.blank_index,
            min_decode_ratio=hp.min_decode_ratio,
            max_decode_ratio=hp.max_decode_ratio, beam_size=beam_size,
            eos_threshold=hp.eos_threshold,
            using_max_attn_shift=hp.using_max_attn_shift,
            max_attn_shift=hp.max_attn_shift,
            coverage_penalty=hp.coverage_penalty,
            ctc_weight=hp.ctc_weight_decode)

    def on_stage_start(self, stage, epoch=None):
        """The epoch; outside training the PER metric and the searcher."""
        if epoch is not None:
            self.epoch = epoch
        elif stage == Stage.TEST:
            counter = getattr(self.hparams, "epoch_counter", None)
            if counter is not None:
                self.epoch = counter.current
        if stage != Stage.TRAIN:
            self.per_metrics = ErrorRateStats()
            self.searcher = self.make_searcher(
                self.hparams.valid_beam_size if stage == Stage.VALID
                else self.hparams.test_beam_size)

    def summarize_metric(self):
        """The stage's PER."""
        return self.per_metrics.summarize("error_rate")

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """``NewBobBrain``'s; at TEST the log line and the PER file."""
        super().on_stage_end(stage, stage_loss, epoch)
        if stage != Stage.TEST:
            return
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            train_logger.log_stats({"Epoch loaded": self.epoch},
                                   test_stats=self.stage_stats[stage.name])
        per_file = getattr(self.hparams, "per_file", None)
        if per_file is not None:
            with open(per_file, "w") as f:
                self.per_metrics.write_stats(f)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS, brain_class=ASR):
    """Everything ``run`` trains with, built as the recipe's ``__main__``
    builds it (``train.py:209-237``): the manifests (prepared unless they
    exist, folded to ``phn_set``), the datasets and label encoder, the
    loaders (batches of ``batch_size``, the train loader shuffled), an
    ``EpochCounter``, and a ``brain_class`` Brain with a ``Checkpointer``
    on ``<output_folder>/save``, a ``FileTrainLogger`` on
    ``<output_folder>/train_log.txt`` and the PER file
    ``<output_folder>/per.txt``.

    ``hparams`` is ``HPARAMS`` (a teacher: ``overrides=TEACHERS[name]``);
    ``overrides`` replace its values; ``run_opts`` are the ``Brain``'s
    (``device``: None for the CUDA card, "cpu" to ask for the CPU;
    ``debug``, ...).  Returns a dict with ``brain``, ``epoch_counter``,
    ``datasets``, ``train_loader``, ``valid_loader``, ``test_loader``,
    ``label_encoder`` and ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev"),
        ("test_json", "test")))
    hp.setdefault("per_file", os.path.join(output_folder, "per.txt"))
    run_on_main(prepare_timit, kwargs={
        "data_folder": hp["data_folder"],
        "save_json_train": hp["train_json"],
        "save_json_valid": hp["valid_json"],
        "save_json_test": hp["test_json"],
        "phn_set": hp["phn_set"],
    })
    datasets, label_encoder = brain_class.make_datasets(hp)
    if len(label_encoder) > hp["output_neurons"]:
        raise ValueError(
            f"{len(label_encoder)} labels (the phones with the blank, <bos> "
            f"and <eos>) pass output_neurons {hp['output_neurons']}")
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = brain_class(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
             epoch_counter=epoch_counter),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]),
        label_encoder=label_encoder)
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "datasets": datasets,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "label_encoder": label_encoder, "hparams": hp}



def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The recipe's ``__main__`` (``train.py:209-252``): ``build``, then
    ``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` on the test set at ``test_beam_size`` from
    the checkpoint with the lowest validation PER.  Arguments as for
    ``build``.  Returns the Brain (``brain.stage_stats`` holds the last
    VALID and TEST loss and PER)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="PER")
    return brain
