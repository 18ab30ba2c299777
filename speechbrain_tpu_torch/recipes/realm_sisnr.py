"""The REAL-M blind SI-SNR estimator recipe end to end, on the port.

Does what ``recipes/REAL-M/sisnr-estimation/train.py`` does with
``pool_sisnrestimator.yaml`` (``HPARAMS``): a wsj0-mix tree ->
``prepare_wsjmix``'s manifests -> ``SISNREstimator.fit``: each source is
degraded into a synthetic separator output (cross-talk of the other
source, ``alpha`` uniform in [0, 0.8), and white noise at 0.05), whose
oracle SI-SNR, compressed from [``snr_low``, ``snr_high``] dB to [0, 1],
is the target; the estimator (``Xvector`` over the (estimate, mixture)
pair as two input channels, TDNN widths 256 x 4 and 512, then
``Linear(1)`` and a sigmoid) regresses it under an L1 loss; Adam at
``lr``; checkpoints keep the best by the validation L1 (``si-snr-l1``)
-> ``evaluate`` with that checkpoint.  Every split's mixtures are cut or
zero-padded to ``training_signal_len`` samples, as in JAX.

Differences from the JAX recipe, each on purpose:

- each estimate is scored with its own mixture and its own oracle
  SI-SNR: rows are (example, source) in example-major order throughout.
  The JAX script stacks its estimates example-major but tiles the
  mixtures and flattens the targets source-major, so with more than one
  example a batch pairs an estimate with another example's mixture and
  another row's target (``test_torch_separation_recipes`` pins this);
- the training crops are keyed by (seed, epoch, mixture id), and the
  validation and test crops by (seed, 0, id): the same every epoch;
- the degradation draws from the Brain's generator, which its
  checkpoints carry;
- each duration is read at its file's own rate (JAX divides by 8000).

Toy widths on the CPU::

    from speechbrain_tpu_torch.recipes import realm_sisnr, wsj0mix_separation
    wsj0mix_separation.write_synthetic_wsj0mix("/tmp/wsj")
    realm_sisnr.run("/tmp/wsj", "/tmp/out", run_opts={"device": "cpu"},
                    overrides={"tdnn_channels": [8, 8, 8, 8, 16],
                               "lin_neurons": 8, "training_signal_len": 4000,
                               "number_of_epochs": 1})
"""

import torch

from ..core import Brain, Stage
from ..lobes.models.Xvector import Xvector
from ..nnet.linear import Linear
from ..nnet.losses import cal_si_snr
from ..utils.distributed import run_on_main
from .common import recipe_hparams
from .wsj0mix_separation import (assemble, dataio_prep, fit_and_test,
                                 prepare_wsjmix)

__all__ = ["HPARAMS", "YAMLS", "SISNREstimator", "build", "run"]

# recipes/REAL-M/sisnr-estimation/hparams/pool_sisnrestimator.yaml
HPARAMS = dict(seed=17, sample_rate=8000, num_spks=2,
               training_signal_len=32000, limit_training_signal_len=True,
               batch_size=4, number_of_epochs=50, lr=0.0001, snr_low=-10.0,
               snr_high=35.0, tdnn_channels=[256, 256, 256, 256, 512],
               lin_neurons=256, max_grad_norm=5.0, precision="fp32")
YAMLS = {"hparams/pool_sisnrestimator.yaml": HPARAMS}


class SISNREstimator(Brain):
    """The REAL-M recipe's Brain (``train.py:30``), modules ``encoder``
    (``Xvector`` with 2 input channels) and ``encoder_out``
    (``Linear(lin_neurons, 1)``), built from ``hparams`` (missing keys from
    ``HPARAMS``) with weights from the seed (``build_modules``).

    ``compute_forward``: the (B, T, S) sources, their degraded estimates
    (``degrade``), the oracle SI-SNR of each (example, source) compressed
    to [0, 1], and the estimator's sigmoid output on each estimate beside
    its own mixture; both (B S,) in example-major order.
    ``compute_objectives``: their L1 over the real rows.  ``on_stage_end``
    outside training: the stage's L1 (``stage_stats``); at VALID the log
    line and, with a checkpointer, a checkpoint keeping the least
    ``si-snr-l1``.

    Example
    -------
    >>> hp = {"tdnn_channels": [8, 8, 8, 8, 16], "lin_neurons": 8}
    >>> brain = SISNREstimator(hp, run_opts={"device": "cpu"})
    >>> s = torch.randn(2, 3, 800)
    >>> batch = {"mix_sig": s[0] + s[1], "s1_sig": s[0], "s2_sig": s[1]}
    >>> snr_hat, target = brain.compute_forward(brain.prepare_batch(batch),
    ...                                         Stage.TRAIN)
    >>> snr_hat.shape, target.shape
    (torch.Size([6]), torch.Size([6]))
    """

    def __init__(self, hparams=None, run_opts=None, checkpointer=None):
        hp = dict(HPARAMS, **(hparams or {}))
        run_opts = dict(run_opts or {})
        run_opts.setdefault("seed", hp["seed"])

        def opt_class(params):
            return torch.optim.Adam(params, lr=hp["lr"], betas=(0.9, 0.999),
                                    eps=1e-8)

        super().__init__(build_modules(hp, run_opts["seed"]), opt_class, hp,
                         run_opts, checkpointer)
        self.stage_stats = {}
        self._l1 = []

    def degrade(self, targets):
        """(B, T, S) sources -> synthetic separator outputs: ``(1 - alpha)
        s + alpha flip(s) + 0.05 n``, alpha (B, 1, 1) uniform in [0, 0.8)
        and n standard normal, drawn from the Brain's generator."""
        B = targets.shape[0]
        gen, dev = self.generator, targets.device
        alpha = 0.8 * torch.rand((B, 1, 1), generator=gen, device=dev)
        noise = 0.05 * torch.randn(targets.shape, generator=gen, device=dev)
        return (1 - alpha) * targets + alpha * targets.flip(-1) + noise

    def compute_forward(self, batch, stage):
        """(estimated, oracle) compressed SI-SNR, (B S,) each, rows
        example-major."""
        mix = batch["mix_sig"]
        targets = torch.stack([batch["s1_sig"], batch["s2_sig"]], dim=-1)
        est = self.degrade(targets)
        snr = -cal_si_snr(targets.transpose(0, 1), est.transpose(0, 1))[0]
        low, high = self.hparams.snr_low, self.hparams.snr_high
        oracle = ((snr - low) / (high - low)).clamp(0.0, 1.0)
        B, T, S = est.shape
        est_rows = est.transpose(1, 2).reshape(B * S, T)
        mix_rows = mix.repeat_interleave(S, dim=0)
        inp = torch.stack([est_rows, mix_rows], dim=-1).to(self.dtype)
        emb = self.modules.encoder(inp)
        snr_hat = torch.sigmoid(self.modules.encoder_out(emb[:, 0])[:, 0])
        return snr_hat.float(), oracle.reshape(-1)

    def compute_objectives(self, predictions, batch, stage):
        """The L1 between the two, averaged over the real rows."""
        snr_hat, oracle = predictions
        mask = batch["batch_mask"].repeat_interleave(
            snr_hat.shape[0] // batch["batch_mask"].shape[0])
        err = (snr_hat - oracle).abs() * mask
        if stage != Stage.TRAIN:
            self._l1.append(torch.stack([err.sum(), mask.sum()]))
        return err.sum() / mask.sum().clamp(min=1.0)

    def on_stage_start(self, stage, epoch=None):
        """The crop draws the epoch's training crops; the L1 sums restart."""
        crop = getattr(self.hparams, "crop", None)
        if crop is not None and epoch is not None:
            crop.set_epoch(epoch)
        self._l1 = []

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The stage's L1; at VALID the log line and the checkpoint."""
        if stage == Stage.TRAIN:
            return
        tot = torch.stack(self._l1).sum(0).tolist() if self._l1 else [0, 0]
        l1 = tot[0] / max(tot[1], 1.0)
        self.stage_stats[stage.name] = {"loss": stage_loss, "si-snr-l1": l1}
        if stage != Stage.VALID:
            return
        train_logger = getattr(self.hparams, "train_logger", None)
        if train_logger is not None:
            train_logger.log_stats(
                {"epoch": epoch}, train_stats={"loss": self.avg_train_loss},
                valid_stats={"loss": stage_loss, "si-snr-l1": l1})
        if self.checkpointer is not None:
            self.checkpointer.save_and_keep_only(meta={"si-snr-l1": l1},
                                                 min_keys=["si-snr-l1"])


def build_modules(hp, seed=0):
    """The estimator's ``encoder`` and ``encoder_out`` with Lecun-normal
    weights and PyTorch's default biases from ``seed`` (as
    ``wsj0mix_separation.build_model`` draws them)."""
    from ..asr import _random_init
    from .wsj0mix_separation import _random_biases

    modules = torch.nn.ModuleDict({
        "encoder": Xvector(2, tdnn_channels=hp["tdnn_channels"],
                           lin_neurons=hp["lin_neurons"]),
        "encoder_out": Linear(hp["lin_neurons"], 1)})
    gen = torch.Generator().manual_seed(seed)
    _random_init(modules, gen)
    _random_biases(modules, gen)
    return dict(modules.items())


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS):
    """Everything ``run`` trains with, as ``wsj0mix_separation.build``
    builds it, with an ``SISNREstimator``; every split cropped."""
    hp = recipe_hparams(hparams, data_folder, output_folder, overrides,
                        [("train_data", "wsj_tr"), ("valid_data", "wsj_cv"),
                         ("test_data", "wsj_tt")])
    run_on_main(prepare_wsjmix, kwargs={
        "data_folder": hp["data_folder"], "save_folder": hp["save_folder"],
        "num_spks": hp["num_spks"]})
    datasets, crop = dataio_prep(hp, eval_crop=True)
    return assemble(hp, datasets, crop, run_opts, SISNREstimator)


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS):
    """``train.py`` end to end: ``build``, ``fit``, ``evaluate`` with the
    checkpoint of the least validation L1.  Returns the Brain; its
    ``stage_stats["TEST"]["si-snr-l1"]`` is the test L1."""
    return fit_and_test(build(data_folder, output_folder, overrides,
                              run_opts, hparams), min_key="si-snr-l1")
