"""The LibriSpeech CRDNN seq2seq recipe end to end, on the port.

Does what ``recipes/LibriSpeech/ASR/seq2seq/train.py`` does with
``hparams/train_BPE_1000.yaml`` (``HPARAMS``) or ``train_BPE_5000.yaml``
(``HPARAMS_BPE_5000``; the yamls differ in ``vocab_size`` and the output
folder only, so ``overrides={"vocab_size": 5000}`` is the same): the
LibriSpeech manifests (``librispeech_asr.prepare_librispeech``) -> a
unigram ``SentencePiece`` tokenizer trained on the train manifest ->
batches of 8 read from disk, shuffled for training -> ``Seq2SeqBrain.fit``
(Fbank, 40 mels -> global ``InputNormalization`` -> SpecAugment in
training -> a ``CRDNN`` with a bidirectional LSTM of 4 x 1024 -> an
``AttentionalRNNDecoder`` (GRU, location attention, 1024) over the token
embeddings -> ``seq_lin``, and ``ctc_lin`` on the encoder states; the loss
0.5 x CTC (on the kernels K3/K4, for the first ``number_of_ctc_epochs``)
+ 0.5 x label-smoothed NLL; Adadelta at the NewBob-annealed rate; the
validation's WER and CER from the beam search; checkpoints keep the best
by WER) -> ``evaluate(min_key="WER")`` at ``test_beam_size``.  A killed
run resumes from its latest checkpoint when ``run`` is called again on
the same output folder.

The yaml's values are ``HPARAMS`` (the yaml file itself is not read);
``overrides`` replace any of them, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import librispeech_seq2seq as s2s
    brain = s2s.run("/data/LibriSpeech", "results/crdnn_bpe1000",
                    run_opts={"device": "cpu"},
                    overrides={"cnn_channels": (4, 4), "rnn_neurons": 8, ...})

The searches fuse an ``RNNLM`` (the yaml's ``lm_model``: 2 x 2048 LSTM) at
``lm_weight`` when ``run_opts["lm_ckpt"]`` names a local file holding its
``state_dict``, as the JAX recipe fuses one when its parameters are
loaded; without one they run ``S2SRNNBeamSearcher``.  Differences from
the JAX recipe:

- The LM reads bos once at the first decode step, from a zero state, and
  carries its (h, c) from step to step (``RNNLM.step``); the JAX recipe
  starts its LM prefix at [bos] and the search feeds bos again, so its LM
  reads [bos, bos] first, and it reruns the whole prefix each step, which
  its device loop refuses.  The LM fused here is trained with the seq2seq
  yaml's bos = eos = 0; ``LM/hparams/RNNLM.yaml``'s bos 1 and eos 2 are
  word pieces of this tokenizer.
- The Brain registers the NewBob schedule with its checkpointer
  (``"lr_annealing"``); the JAX recipe registers none.
"""

import logging
import os

import torch

from ..asr import _random_init, wav2vec_encoder
from ..core import Stage
from ..dataio.dataloader import SaveableDataLoader
from ..decoders.seq2seq import S2SRNNBeamSearcher, S2SRNNBeamSearchLM
from ..lobes.augment import SpecAugment
from ..lobes.features import Fbank
from ..lobes.models.CRDNN import CRDNN
from ..lobes.models.RNNLM import RNNLM
from ..nnet.embedding import Embedding
from ..nnet.linear import Linear
from ..nnet.losses import ctc_loss, nll_loss
from ..nnet.RNN import AttentionalRNNDecoder
from ..processing.features import InputNormalization
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.metric_stats import ErrorRateStats
from ..utils.train_logger import FileTrainLogger
from .common import NewBobBrain, at_least_f32, recipe_hparams
from .librispeech_asr import make_datasets, prepare_librispeech

logger = logging.getLogger(__name__)

__all__ = ["HPARAMS", "HPARAMS_BPE_5000", "build_modules",
           "wav2vec_states", "build_lm", "load_lm", "Seq2SeqBrain", "build",
           "run"]

# recipes/LibriSpeech/ASR/seq2seq/hparams/train_BPE_1000.yaml (with the
# JAX Brain's gradient clip, 5)
HPARAMS = dict(
    seed=1986,
    train_splits=["train-clean-100", "train-clean-360", "train-other-500"],
    dev_splits=["dev-clean"],
    test_splits=["test-clean"],
    vocab_size=1000,
    token_type="unigram",
    sample_rate=16000,
    n_mels=40,
    batch_size=8,
    number_of_epochs=15,
    number_of_ctc_epochs=5,
    lr=1.0,
    ctc_weight=0.5,
    label_smoothing=0.1,
    precision="bf16",
    blank_index=0,
    bos_index=0,
    eos_index=0,
    cnn_blocks=2,
    cnn_channels=(128, 256),
    inter_layer_pooling_size=(2, 2),
    rnn_layers=4,
    rnn_neurons=1024,
    dnn_blocks=2,
    dnn_neurons=512,
    emb_size=128,
    dec_neurons=1024,
    attn_dim=1024,
    dropout=0.15,
    min_decode_ratio=0.0,
    max_decode_ratio=1.0,
    valid_beam_size=8,
    test_beam_size=80,
    eos_threshold=1.5,
    using_max_attn_shift=True,
    max_attn_shift=240,
    coverage_penalty=1.5,
    ctc_weight_decode=0.0,
    temperature=1.25,
    lm_weight=0.5,
    # SpecAugment's arguments (None: off)
    augmentation={"time_warp": False, "n_freq_mask": 2, "n_time_mask": 2,
                  "replace_with_zero": False, "freq_mask_width": (0, 15),
                  "time_mask_width": (0, 20)},
    # lm_model
    lm_emb_dim=128,
    lm_rnn_layers=2,
    lm_rnn_neurons=2048,
    lm_dnn_blocks=1,
    lm_dnn_neurons=512,
    # opt_class (optax.adadelta) and lr_annealing (NewBobScheduler)
    rho=0.95,
    eps=1e-8,
    improvement_threshold=0.0025,
    annealing_factor=0.8,
    patient=0,
    max_grad_norm=5.0,
)

# recipes/LibriSpeech/ASR/seq2seq/hparams/train_BPE_5000.yaml
HPARAMS_BPE_5000 = dict(HPARAMS, vocab_size=5000)


def build_modules(hparams, seed=0, ctc=True):
    """The recipe's modules, with Lecun-normal weights and orthogonal
    recurrent ones from ``seed`` (``asr._random_init``):
    ``compute_features`` (``Fbank``), ``normalize`` (global
    ``InputNormalization``), ``enc`` (``CRDNN``, ``rnn_class`` "lstm"),
    ``emb`` (``Embedding``), ``dec`` (``AttentionalRNNDecoder``: GRU,
    ``hparams["attn_type"]`` attention, location when not given),
    ``ctc_lin`` (unless ``ctc`` is False) and ``seq_lin`` (``Linear`` to
    ``vocab_size``).  With ``hparams["encoder"]`` "wav2vec" (the wav2vec
    yamls) the wave's encoder is ``extractor`` and ``encoder``
    (``asr.wav2vec_encoder``) in place of the features, the normalization
    and the CRDNN."""
    hp = dict(HPARAMS, **hparams)
    V = hp["vocab_size"]
    if hp.get("encoder") == "wav2vec":
        front = wav2vec_encoder(hp)
        width = hp["embedding_dim"]
    else:
        enc = CRDNN(
            input_size=hp["n_mels"], cnn_blocks=hp["cnn_blocks"],
            cnn_channels=hp["cnn_channels"],
            inter_layer_pooling_size=hp["inter_layer_pooling_size"],
            rnn_class="lstm", rnn_layers=hp["rnn_layers"],
            rnn_neurons=hp["rnn_neurons"], rnn_bidirectional=True,
            dnn_blocks=hp["dnn_blocks"], dnn_neurons=hp["dnn_neurons"],
            dropout=hp["dropout"])
        front = {"compute_features": Fbank(sample_rate=hp["sample_rate"],
                                           n_mels=hp["n_mels"]),
                 "normalize": InputNormalization(hp["n_mels"]),
                 "enc": enc}
        width = enc.output_size
    modules = {
        **front,
        "emb": Embedding(V, hp["emb_size"]),
        "dec": AttentionalRNNDecoder(
            "gru", hp.get("attn_type", "location"),
            hidden_size=hp["dec_neurons"],
            attn_dim=hp["attn_dim"], enc_dim=width,
            input_size=hp["emb_size"], num_layers=1, dropout=hp["dropout"]),
        "ctc_lin": Linear(width, V),
        "seq_lin": Linear(hp["dec_neurons"], V),
    }
    if not ctc:
        del modules["ctc_lin"]
    gen = torch.Generator().manual_seed(seed)
    for name in ("extractor", "encoder", "enc", "emb", "dec", "ctc_lin",
                 "seq_lin"):
        if name in modules:
            _random_init(modules[name], gen)
    return modules


def wav2vec_states(modules, sig, dtype):
    """The wav2vec yamls' encoder states: the wave in ``dtype`` ->
    ``extractor`` -> ``encoder`` (no ``wav_lens``: the padding is
    attended, as the JAX scripts call it) -> ``enc_dnn`` where the
    modules hold one."""
    enc = modules["encoder"](modules["extractor"](sig.to(dtype)))[
        "embeddings"]
    return modules["enc_dnn"](enc) if "enc_dnn" in modules else enc


def build_lm(hparams, seed=0):
    """The yaml's ``lm_model`` (``RNNLM`` over ``vocab_size`` tokens),
    in eval mode, with random weights from ``seed``."""
    hp = dict(HPARAMS, **hparams)
    lm = RNNLM(hp["vocab_size"], embedding_dim=hp["lm_emb_dim"],
               rnn_layers=hp["lm_rnn_layers"],
               rnn_neurons=hp["lm_rnn_neurons"],
               dnn_blocks=hp["lm_dnn_blocks"],
               dnn_neurons=hp["lm_dnn_neurons"])
    _random_init(lm, torch.Generator().manual_seed(seed))
    return lm.eval()


def load_lm(hparams, run_opts):
    """``build_lm`` with the ``state_dict`` saved at
    ``run_opts["lm_ckpt"]`` (popped), or None without one."""
    lm_ckpt = run_opts.pop("lm_ckpt", None)
    if lm_ckpt is None:
        return None
    lm = build_lm(hparams)
    lm.load_state_dict(torch.load(lm_ckpt, map_location="cpu",
                                  weights_only=True))
    return lm


class Seq2SeqBrain(NewBobBrain):
    """The seq2seq recipe's ``ASR`` Brain (``train.py:31-196``).

    ``compute_forward``: ``Fbank`` -> ``InputNormalization`` (updated in
    training until its ``update_until_epoch``) -> SpecAugment (training
    only, draws from ``self.generator``) -> cast to the activation dtype
    -> ``enc`` (the wav2vec yamls: ``wav2vec_states``) -> ``dec`` over
    ``emb(tokens_bos)`` -> float32 (float64 under a float64
    ``self.dtype``) log-softmax of ``seq_lin``, and of ``ctc_lin`` on the
    encoder states.  ``compute_objectives``:
    ``nll_loss`` of ``tokens_eos`` (``label_smoothing``, lengths
    ``tokens_eos_lens * batch_mask``); while the epoch is at most
    ``number_of_ctc_epochs``, ``ctc_weight`` x ``ctc_loss`` (on K3/K4 on the
    card; lengths ``sig_lens * batch_mask`` and ``tokens_lens *
    batch_mask``) + (1 - ctc_weight) x it.  Outside training the beam search
    (``make_searcher``, beam ``valid_beam_size`` or ``test_beam_size``)
    decodes the real rows, whose words (through ``tokenizer``) go to the WER
    and their characters to the CER.  The epoch is the one ``fit`` passes;
    at TEST, the epoch counter's (``hparams["epoch_counter"]``), as the JAX
    recipe reads ``epoch_counter.current``.

    The optimizer is ``torch.optim.Adadelta(rho, eps)`` after the clip to
    ``max_grad_norm``, at ``self.lr`` from ``NewBobBrain``'s schedule on
    the validation WER.  ``on_stage_end`` at VALID logs ``loss``, ``WER``
    and ``CER`` and keeps the checkpoint with the lowest WER; at TEST it
    logs them and writes ``hparams["wer_file"]`` (when given).  ``lm``:
    an ``RNNLM`` to fuse at ``lm_weight`` (None: no fusion).

    Example
    -------
    >>> import numpy as np
    >>> hp = {"cnn_channels": (2, 2), "rnn_layers": 1, "rnn_neurons": 4,
    ...       "dnn_blocks": 1, "dnn_neurons": 4, "n_mels": 8, "emb_size": 4,
    ...       "dec_neurons": 6, "attn_dim": 5, "vocab_size": 7}
    >>> brain = Seq2SeqBrain(hp, run_opts={"device": "cpu",
    ...                                    "precision": "fp32"})
    >>> batch = {"sig": np.random.default_rng(0).normal(
    ...     size=(2, 4000)).astype(np.float32),
    ...     "sig_lens": np.ones(2, np.float32),
    ...     "tokens": np.array([[1, 2], [3, 0]]),
    ...     "tokens_lens": np.array([1.0, 0.5], np.float32),
    ...     "tokens_bos": np.array([[0, 1, 2], [0, 3, 0]]),
    ...     "tokens_eos": np.array([[1, 2, 0], [3, 0, 0]]),
    ...     "tokens_eos_lens": np.array([1.0, 2 / 3], np.float32)}
    >>> brain.step += 1
    >>> bool(np.isfinite(float(brain.fit_batch(batch))))
    True
    """

    metric = "WER"
    best = "min"

    def __init__(self, hparams=None, run_opts=None, checkpointer=None,
                 tokenizer=None, lm=None):
        hp = dict(HPARAMS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adadelta(params, lr=hp["lr"], rho=hp["rho"],
                                        eps=hp["eps"], weight_decay=0)

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        self.tokenizer = tokenizer
        self.lm = None if lm is None else lm.to(self.device).eval()
        aug = hp["augmentation"]
        self.augment = None if aug is None else SpecAugment(**aug)
        self.epoch = 0
        self.use_kernels = True

    def set_kernels(self, flag=True):
        """Run the CTC loss on the kernels (True) or on its plain
        recursions (False)."""
        self.use_kernels = bool(flag)
        return self

    def compute_forward(self, batch, stage):
        """Returns ``(ctc log-probs (B, T, V), seq log-probs (B, U, V),
        encoder states)``, the log-probs in float32."""
        m = self.modules
        enc = self._encode(batch, stage)
        emb = m.emb(batch["tokens_bos"]).to(self.dtype)
        dec_out, _ = m.dec(emb, enc, batch["sig_lens"])
        seq_logp = torch.log_softmax(at_least_f32(m.seq_lin(dec_out)), -1)
        ctc_logp = torch.log_softmax(at_least_f32(m.ctc_lin(enc)), -1)
        return ctc_logp, seq_logp, enc

    def _encode(self, batch, stage):
        """The encoder states: Fbank -> the normalization -> SpecAugment
        (training only) -> cast to the activation dtype -> the CRDNN; or
        ``wav2vec_states`` under the wav2vec yamls."""
        m = self.modules
        if "extractor" in m:
            return wav2vec_states(m, batch["sig"], self.dtype)
        feats = m.compute_features(batch["sig"])
        feats = m.normalize(feats, batch["sig_lens"], epoch=self.epoch)
        if stage == Stage.TRAIN and self.augment is not None:
            feats = self.augment(feats, self.generator)
        return m.enc(feats.to(self.dtype), lengths=batch["sig_lens"])

    def compute_objectives(self, predictions, batch, stage):
        """The joint loss; outside training, the search's WER and CER."""
        ctc_logp, seq_logp, enc = predictions
        hp = self.hparams
        mask = batch["batch_mask"]
        loss = nll_loss(seq_logp, batch["tokens_eos"],
                        length=batch["tokens_eos_lens"] * mask,
                        label_smoothing=hp.label_smoothing)
        if self.epoch <= hp.number_of_ctc_epochs:
            loss_ctc = ctc_loss(ctc_logp, batch["tokens"],
                                batch["sig_lens"] * mask,
                                batch["tokens_lens"] * mask,
                                blank_index=hp.blank_index,
                                use_kernels=self.use_kernels)
            loss = hp.ctc_weight * loss_ctc + (1 - hp.ctc_weight) * loss
        if stage != Stage.TRAIN and hasattr(self, "wer_metric"):
            hyps, _ = self.searcher(enc, batch["sig_lens"])
            self._score(hyps, batch)
        return loss

    def _score(self, hyps, batch):
        real = int(batch["batch_mask"].sum())
        tokens = batch["tokens"][:real].cpu().numpy()
        lens = batch["tokens_lens"][:real].cpu().numpy()
        predicted = [self.tokenizer([h], task="decode_from_list")[0]
                     for h in hyps[:real]]
        targets = self.tokenizer(tokens.tolist(), lens, task="decode")
        ids = [str(i) for i in range(real)]
        self.wer_metric.append(ids, predicted, targets)
        self.cer_metric.append(ids, [list(" ".join(w)) for w in predicted],
                               [list(" ".join(w)) for w in targets])

    def make_searcher(self, beam_size):
        """The recipe's beam searcher over the Brain's modules
        (``train.py:108-170``): ``S2SRNNBeamSearchLM`` with ``self.lm``
        fused at ``lm_weight``, or ``S2SRNNBeamSearcher`` without one."""
        m, hp = self.modules, self.hparams
        kwargs = dict(
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
            ctc_weight=hp.ctc_weight_decode, temperature=hp.temperature)
        if self.lm is None:
            return S2SRNNBeamSearcher(**kwargs)
        lm = self.lm

        def lm_init_fn(n):
            rnn = lm.rnn
            zeros = torch.zeros(n, rnn.num_layers, rnn.hidden_size,
                                device=self.device)
            return {"h": zeros, "c": zeros}

        def lm_step_fn(tokens, memory):
            logits, memory = lm.step(tokens, memory)
            return torch.log_softmax(logits.float(), -1), memory

        return S2SRNNBeamSearchLM(lm_step_fn=lm_step_fn,
                                  lm_init_fn=lm_init_fn,
                                  lm_weight=hp.lm_weight, **kwargs)

    def on_stage_start(self, stage, epoch=None):
        """The epoch; outside training the metrics and the searcher."""
        if epoch is not None:
            self.epoch = epoch
        elif stage == Stage.TEST:
            counter = getattr(self.hparams, "epoch_counter", None)
            if counter is not None:
                self.epoch = counter.current
        if stage != Stage.TRAIN:
            self.wer_metric = ErrorRateStats()
            self.cer_metric = ErrorRateStats()
            self.searcher = self.make_searcher(
                self.hparams.valid_beam_size if stage == Stage.VALID
                else self.hparams.test_beam_size)

    def summarize_metric(self):
        """The stage's WER."""
        return self.wer_metric.summarize("error_rate")

    def extra_stats(self):
        """The stage's CER."""
        return {"CER": self.cer_metric.summarize("error_rate")}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """``NewBobBrain``'s; at TEST the log line and the WER file."""
        super().on_stage_end(stage, stage_loss, epoch)
        if stage != Stage.TEST:
            return
        stats = self.stage_stats[stage.name]
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            train_logger.log_stats({"Epoch loaded": self.epoch},
                                   test_stats=stats)
        wer_file = getattr(self.hparams, "wer_file", None)
        if wer_file is not None:
            with open(wer_file, "w") as f:
                self.wer_metric.write_stats(f)


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the recipe's ``__main__``
    builds it (``train.py:232-291``): the manifests (prepared unless they
    exist), the tokenizer (trained on the train manifest unless its model
    file exists), the datasets and their loaders (batches of
    ``batch_size``, the train loader shuffled), an ``EpochCounter``, and a
    ``Seq2SeqBrain`` with a ``Checkpointer`` on ``<output_folder>/save``,
    a ``FileTrainLogger`` on ``<output_folder>/train_log.txt``, the WER
    file ``<output_folder>/wer.txt``, the tokenizer, and an ``RNNLM``
    loaded from ``run_opts["lm_ckpt"]`` when given.

    ``hparams`` is ``HPARAMS`` or ``HPARAMS_BPE_5000``; ``overrides``
    replace its values; ``run_opts`` are the ``Brain``'s (``device``: None
    for the CUDA card, "cpu" to ask for the CPU; ``debug``, ...) and
    ``lm_ckpt``.  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader``, ``test_loader`` and ``hparams``."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", "dev-clean"),
        ("test_json", "test-clean")))
    hp.setdefault("wer_file", os.path.join(output_folder, "wer.txt"))
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
    datasets = make_datasets(hp, tokenizer)
    run_opts = dict(run_opts or {})
    lm = load_lm(hp, run_opts)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = Seq2SeqBrain(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
             epoch_counter=epoch_counter),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]),
        tokenizer=tokenizer, lm=lm)
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "test_loader": SaveableDataLoader(datasets["test"],
                                              batch_size=bs),
            "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The recipe's ``__main__`` (``train.py:232-308``): ``build``, then
    ``fit`` (resuming from the latest checkpoint in ``<output_folder>/
    save``), then ``evaluate`` on the test set at ``test_beam_size`` from
    the checkpoint with the lowest validation WER.  Arguments as for
    ``build``.  Returns the Brain (``brain.stage_stats`` holds the last
    VALID and TEST loss, WER and CER)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="WER")
    return brain
