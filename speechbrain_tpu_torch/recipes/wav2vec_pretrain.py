"""wav2vec 2.0 self-supervised pretraining end to end, on the port: the
LibriSpeech and CommonVoice ``self-supervised-learning/wav2vec2``
recipes (``hparams/wav2vec2_base.yaml``).

A corpus's manifests (``librispeech_asr.prepare_librispeech`` with the
three train splits merged into ``train.json``, or
``common_voice_prepare.prepare_common_voice``) -> 10 s crops of the
waves -> ``W2VBrain.fit``: ``W2VLatentExtractor`` (7 convolutions of 512)
-> the Gumbel targets (``W2VTargetQuantiser``: 2 x 320 codewords, 256
wide) and the masked encoder (``EncoderWrapper``: ``mask_emb``, 12
pre-norm layers at d 768, 8 heads, d_ffn 3072) -> ``proj`` -> 100
negatives a frame -> ``ContrastiveLoss`` + 0.1 x the diversity loss;
AdamW (0.9, 0.98, eps 1e-6; optax's decay 1e-4) under Noam (5e-4, 32000
warmup steps), gradients accumulated over 8 batches of 16; checkpoints
keep the best validation loss.  A killed run resumes from its latest
checkpoint when ``run`` is called again on the same output folder.

``HPARAMS`` (LibriSpeech) and ``HPARAMS_COMMONVOICE`` are the yamls'
values (the yaml files are not read); ``overrides`` replace any of them,
e.g. toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import wav2vec_pretrain as w2v
    w2v.run("/data/LibriSpeech", "results/w2v", run_opts={"device": "cpu"},
            overrides={"latent_channels": (32, 32), "embedding_dim": 32,
                       "encoder_layers": 1, "nhead": 2, "d_ffn": 64,
                       "crop_seconds": 0.5, "batch_size": 2})

Differences from the JAX script (``recipes/LibriSpeech/
self-supervised-learning/wav2vec2/train.py``):

- Its ``compute_forward`` draws the mask with ``seed=int(self.step)``
  while ``jax.jit`` traces the step, so the mask is a constant of the
  compiled program: the one of the first micro-batch (step 1) for every
  training batch of that shape, and step 0's for every validation batch.
  The port draws it at every micro-batch with the seed
  ``int(self.step)``, the micro-batch's number in its epoch (1, 2, ...;
  the optimizer steps every ``grad_accumulation_factor`` of them), which
  a resumed epoch counts alike.
- Its crops (train and valid) draw from one numpy generator shared by the
  pipeline, so a resumed epoch crops other segments; the port's
  ``wsj0mix_separation.MixtureCrop`` keys a crop by (seed, epoch, id), the
  validation crops at epoch 0.
- It never casts to the yaml's bf16 (its modules run in the input's
  float32); the port runs the Brain's ``precision``, the contrastive and
  diversity losses in float32.
- The Noam schedule is registered with the checkpointer (the JAX script
  registers none, so its resumed runs restart the warmup).

Copied as they are: the loss averages -log p(positive) over every frame,
masked or not (``nnet/losses.py:610``), and the quantiser's temperature
stays at 2.0, its first (the JAX quantiser is called without one).
"""

import torch

from ..asr import _random_init
from ..core import Brain, Stage
from ..dataio.dataio import read_audio
from ..dataio.dataloader import SaveableDataLoader
from ..dataio.dataset import DynamicItemDataset
from ..lobes.models.wav2vec import (
    EncoderWrapper,
    W2VLatentExtractor,
    W2VTargetQuantiser,
    compute_mask,
    gather_negatives,
    negative_offsets,
)
from ..nnet.linear import Linear
from ..nnet.losses import ContrastiveLoss
from ..nnet.schedulers import NoamScheduler
from ..utils.checkpoints import Checkpointer
from ..utils.distributed import run_on_main
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import at_least_f32, recipe_hparams
from .common_voice_prepare import prepare_common_voice
from .librispeech_asr import prepare_librispeech
from .wsj0mix_separation import MixtureCrop

__all__ = ["HPARAMS", "HPARAMS_COMMONVOICE", "init_wav2vec",
           "build_modules", "W2VBrain", "dataio_prepare", "build", "run"]

# the JAX modules' defaults that the yamls keep
KERNEL_SIZES = (11, 3, 3, 3, 3, 3, 3)
STRIDES = (5, 2, 2, 2, 2, 2, 2)

# recipes/LibriSpeech/self-supervised-learning/wav2vec2/hparams/
# wav2vec2_base.yaml (with the JAX Brain's clip 5.0, optax adamw's decay
# 1e-4 and EncoderWrapper's dropout 0.1, which the yaml leaves as they
# are; its latent_dim is the last of latent_channels)
HPARAMS = dict(
    seed=1000,
    corpus="librispeech",
    train_splits=["train-clean-100", "train-clean-360", "train-other-500"],
    dev_splits=["dev-clean"],
    sample_rate=16000,
    crop_seconds=10.0,
    batch_size=16,
    grad_accumulation_factor=8,
    number_of_epochs=100,
    lr=0.0005,
    n_warmup_steps=32000,
    precision="bf16",
    mask_prob=0.065,
    mask_length=10,
    num_negatives=100,
    logit_temp=0.1,
    diversity_weight=0.1,
    embedding_dim=768,
    encoder_layers=12,
    nhead=8,
    d_ffn=3072,
    quantiser_vars=320,
    quantiser_groups=2,
    target_dim=256,
    latent_channels=(512,) * 7,
    kernel_sizes=KERNEL_SIZES,
    strides=STRIDES,
    encoder_dropout=0.1,
    betas=(0.9, 0.98),
    eps=1e-6,
    weight_decay=1e-4,
    max_grad_norm=5.0,
)

# recipes/CommonVoice/self-supervised-learning/wav2vec2/hparams/
# wav2vec2_base.yaml: the same model on a CommonVoice language folder
HPARAMS_COMMONVOICE = dict(
    {k: v for k, v in HPARAMS.items()
     if k not in ("train_splits", "dev_splits")},
    corpus="commonvoice",
    accented_letters=False,
    language="en",
)


def init_wav2vec(modules, seed):
    """Random weights for a dict of the wav2vec recipes' modules, from one
    generator seeded with ``seed``: ``asr._random_init``'s Lecun-normal
    weights, zero biases and unit norms, then the JAX initializers of the
    two parameters that are neither: each ``codebook`` uniform on [0, 1)
    and ``mask_emb`` uniform on [0, 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    for name in sorted(modules):
        _random_init(modules[name], gen)
        with torch.no_grad():
            for pname, p in modules[name].named_parameters():
                leaf = pname.rsplit(".", 1)[-1]
                if leaf == "codebook":
                    p.copy_(torch.rand(p.shape, generator=gen))
                elif leaf == "mask_emb":
                    p.copy_(torch.rand(p.shape, generator=gen) * 0.1)
    return modules


def build_modules(hparams, seed=0):
    """The pretraining recipe's modules (``extractor``, ``quantiser``,
    ``encoder`` with ``mask_emb``, ``proj``) with ``init_wav2vec``'s
    weights."""
    hp = dict(HPARAMS, **hparams)
    extractor = W2VLatentExtractor(hp["latent_channels"], hp["kernel_sizes"],
                                   hp["strides"])
    return init_wav2vec({
        "extractor": extractor,
        "quantiser": W2VTargetQuantiser(
            extractor.output_size, hp["target_dim"], hp["quantiser_vars"],
            hp["quantiser_groups"]),
        "encoder": EncoderWrapper(
            extractor.output_size, hp["embedding_dim"], hp["encoder_layers"],
            hp["nhead"], hp["d_ffn"], hp["encoder_dropout"], mask_emb=True),
        "proj": Linear(hp["embedding_dim"], hp["target_dim"]),
    }, seed)


class W2VBrain(Brain):
    """The pretraining recipe's ``W2VBrain`` (``train.py:29-94``).

    ``compute_forward``: the wave in the activation dtype -> latents (B,
    T, 512) -> ``compute_mask((B, T), [T] * B, mask_prob, mask_length,
    seed=int(self.step))`` -> the quantiser's targets (in training its
    Gumbel noise from ``gumbel_uniform``) and the masked encoder -> ``proj``
    -> ``num_negatives`` negatives a frame (``negative_offsets``; both
    draws from ``self.generator``);
    returns ``(proj, targets, negatives, meta)``, the three tensors in
    float32.  ``compute_objectives``: ``ContrastiveLoss(logit_temp)`` +
    ``diversity_weight`` x the diversity loss.

    The optimizer is ``torch.optim.AdamW`` with optax ``adamw``'s settings
    (``betas``, ``eps``, ``weight_decay``) after the Brain's clip, at
    ``self.lr``: ``lr``, then ``NoamScheduler(lr, n_warmup_steps)`` after
    each optimizer step; with a ``checkpointer`` it is registered as
    ``"lr_annealing"``.  ``on_stage_end`` at VALID writes the logger's line
    (``hparams["train_logger"]``), saves a checkpoint that keeps the
    lowest validation loss and keeps ``{"loss"}`` in
    ``self.stage_stats["VALID"]``.  ``hparams["crop"]``, a
    ``MixtureCrop``, when given, is set to each training epoch.

    Example
    -------
    >>> hp = dict(HPARAMS, latent_channels=(8, 8), embedding_dim=8,
    ...           encoder_layers=1, nhead=2, d_ffn=16, quantiser_vars=4,
    ...           target_dim=8, num_negatives=2, mask_length=2,
    ...           precision="fp32", grad_accumulation_factor=1)
    >>> brain = W2VBrain(hp, run_opts={"device": "cpu"})
    >>> batch = {"sig": torch.randn(2, 1600, generator=torch.Generator(
    ...     ).manual_seed(0))}
    >>> brain.step += 1
    >>> bool(torch.isfinite(torch.tensor(float(brain.fit_batch(batch)))))
    True
    """

    def __init__(self, hparams, run_opts=None, checkpointer=None):
        hp = dict(HPARAMS, **hparams)
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.AdamW(params, lr=hp["lr"],
                                     betas=tuple(hp["betas"]), eps=hp["eps"],
                                     weight_decay=hp["weight_decay"])

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        self.lr_annealing = NoamScheduler(hp["lr"], hp["n_warmup_steps"])
        if (checkpointer is not None
                and "lr_annealing" not in checkpointer.recoverables):
            checkpointer.add_recoverable("lr_annealing", self.lr_annealing)
        self.loss_fn = ContrastiveLoss(logit_temp=hp["logit_temp"])
        self.stage_stats = {}

    def mask_for(self, B, T):
        """The (B, T) bool mask of the current micro-batch, on the
        device."""
        hp = self.hparams
        mask = compute_mask((B, T), [T] * B, mask_prob=hp.mask_prob,
                            mask_length=hp.mask_length, seed=int(self.step))
        return torch.from_numpy(mask).to(self.device)

    def gumbel_uniform(self, shape):
        """The quantiser's uniform draw (float32, from ``self.generator``);
        a test may hand in another's."""
        return torch.rand(shape, generator=self.generator, device=self.device)

    def negative_offsets(self, B, T):
        """The negatives' offsets (``negative_offsets`` from
        ``self.generator``); a test may hand in another's."""
        return negative_offsets(self.hparams.num_negatives, B, T,
                                self.generator, self.device)

    def compute_forward(self, batch, stage):
        """See the class."""
        m = self.modules
        latents = m.extractor(batch["sig"].to(self.dtype))
        B, T, _ = latents.shape
        mask = self.mask_for(B, T)
        vq = m.quantiser.quantiser
        uniform = (self.gumbel_uniform((B * T * vq.groups, vq.num_vars))
                   if vq.training else None)
        targets, meta = m.quantiser(latents, uniform=uniform)
        enc = m.encoder(latents, mask=mask)["embeddings"]
        proj = at_least_f32(m.proj(enc))
        targets = at_least_f32(targets)
        negatives = gather_negatives(targets, self.negative_offsets(B, T))
        return proj, targets, negatives, meta

    def compute_objectives(self, predictions, batch, stage):
        """The contrastive loss + the weighted diversity loss."""
        proj, targets, negatives, meta = predictions
        loss = self.loss_fn(proj, targets, negatives)
        return loss + self.hparams.diversity_weight * meta["diversity_loss"]

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        """Noam after each optimizer step."""
        if should_step:
            _, self.lr = self.lr_annealing()

    def on_stage_start(self, stage, epoch=None):
        """The training crops of the epoch."""
        crop = getattr(self.hparams, "crop", None)
        if stage == Stage.TRAIN and crop is not None and epoch is not None:
            crop.set_epoch(epoch)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """See the class."""
        if stage != Stage.VALID:
            return
        self.stage_stats["VALID"] = {"loss": stage_loss}
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            train_logger.log_stats(
                {"epoch": epoch, "lr": self.lr},
                train_stats={"loss": self.avg_train_loss},
                valid_stats={"loss": stage_loss})
        if self.checkpointer is not None:
            self.checkpointer.save_and_keep_only(meta={"loss": stage_loss},
                                                 min_keys=["loss"])


def _prepare(hp):
    """The corpus's manifests (unless they exist)."""
    if hp["corpus"] == "librispeech":
        prepare_librispeech(hp["data_folder"], hp["save_folder"],
                            tr_splits=hp["train_splits"],
                            dev_splits=hp["dev_splits"], te_splits=[],
                            merge_lst=hp["train_splits"],
                            merge_name="train.json")
    else:
        prepare_common_voice(hp["data_folder"], hp["save_folder"],
                             accented_letters=hp["accented_letters"],
                             language=hp["language"])


def dataio_prepare(hparams):
    """The train and valid datasets (``hparams["train_json"]``,
    ``["valid_json"]``): ``id`` and ``sig``, the wave cut to
    ``crop_seconds`` (longer ones from a start drawn by a ``MixtureCrop``
    keyed by (seed, epoch, id), the validation one at epoch 0; shorter ones
    zero-padded at the end).  Returns ``(datasets, training crop)``."""
    samples = int(hparams["crop_seconds"] * hparams["sample_rate"])
    crops = {"train": MixtureCrop(samples, hparams["seed"]),
             "valid": MixtureCrop(samples, hparams["seed"])}
    datasets = {}
    for split, crop in crops.items():
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])

        def audio_pipeline(wav, uid, crop=crop):
            return crop([read_audio(wav)], uid)[0].astype("float32")

        ds.add_dynamic_item(audio_pipeline, takes=["wav", "id"],
                            provides="sig")
        ds.set_output_keys(["id", "sig"])
        datasets[split] = ds
    return datasets, crops["train"]


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, built as the script's ``__main__``
    builds it: ``hparams`` (``HPARAMS`` or ``HPARAMS_COMMONVOICE``) with
    the folders and ``overrides``, the manifests (prepared unless they
    exist), the cropped datasets, loaders of ``batch_size`` (the train
    loader shuffled), an ``EpochCounter`` and a ``W2VBrain`` with a
    ``Checkpointer`` on ``<output_folder>/save`` and a ``FileTrainLogger``
    on ``<output_folder>/train_log.txt``.  ``run_opts`` are the
    ``Brain``'s (``device``: None for the CUDA card, "cpu" to ask for the
    CPU).  Returns a dict with ``brain``, ``epoch_counter``,
    ``train_loader``, ``valid_loader`` and ``hparams``."""
    valid = "dev-clean" if hparams["corpus"] == "librispeech" else "dev"
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides, (
        ("train_json", "train"), ("valid_json", valid)))
    run_on_main(_prepare, args=(hp,))
    datasets, crop = dataio_prepare(hp)
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = W2VBrain(
        dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
             epoch_counter=epoch_counter, crop=crop),
        run_opts=run_opts, checkpointer=Checkpointer(hp["save_folder"]))
    bs = hp["batch_size"]
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": SaveableDataLoader(datasets["train"],
                                               batch_size=bs, shuffle=True),
            "valid_loader": SaveableDataLoader(datasets["valid"],
                                               batch_size=bs),
            "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """The script's ``__main__``: ``build``, then ``fit`` (resuming from
    the latest checkpoint in ``<output_folder>/save``).  Arguments as for
    ``build``.  Returns the Brain (``brain.stage_stats["VALID"]`` holds the
    last validation loss)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    return brain
