"""The port's training step (``ConformerASRBrain`` on ``core.Brain``)
against a JAX ``Brain`` built the way the LibriSpeech recipe builds its
own (``recipes/LibriSpeech/ASR/transformer/train.py:32-90``):

Fbank -> global InputNormalization (updated in training) ->
ConvolutionFrontEnd (BatchNorm statistics updated) -> TransformerASR ->
ctc_lin / seq_lin with f32 log_softmax -> 0.3 CTC + 0.7 label-smoothed
KL (both ``batchmean``), the Noam schedule stepped after each
optimizer step, clip-by-global-norm 5.0.

Toy config (d_model 32, 2 encoder and 1 decoder layers, vocab 32, 40
mels, f32, dropout 0).  The JAX weights move to the port through
``bridge.py``; after the steps, parameters and the BatchNorm and
normalization statistics are compared in the port's layout and, through
``bridge.to_jax_conformer_asr``, in the JAX layout.  The CPU runs the
plain versions of the kernels (CTC recursions, depthwise conv).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechbrain_tpu.core import Brain as JBrain
from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JTransformerASR,
)
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu.nnet.losses import ctc_loss as j_ctc_loss
from speechbrain_tpu.nnet.losses import kldiv_loss as j_kldiv_loss
from speechbrain_tpu.nnet.schedulers import NoamScheduler as JNoam
from speechbrain_tpu.parallel.mesh import make_mesh
from speechbrain_tpu.processing.features import (
    GlobalNormState as JNormState,
)
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASRBrain

from .test_torch_kernels import one_torch_thread  # noqa: F401

CFG = dict(
    CONFORMER_SMALL, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=2, num_decoder_layers=1,
    d_ffn=64, kernel_size=7, vocab_size=32, transformer_dropout=0.0,
    lr_adam=1e-3, n_warmup_steps=4, augmentation=None,
)
LR0 = 1e-3  # the first step's learning rate (hparams "lr"), then Noam


class _JaxRecipeBrain(JBrain):
    """The recipe's ``ASR`` Brain without SpecAugment and the WER search."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # one device, as the port trains: the test suite's 8 virtual CPU
        # devices would pad the batch with masked replica rows
        self.mesh = make_mesh(jax.devices()[:1])
        self.fbank = JFbank(n_mels=CFG["n_mels"])
        self.noam = JNoam(CFG["lr_adam"], CFG["n_warmup_steps"])

    def compute_forward(self, batch, stage):
        feats = self.fbank(batch["sig"])
        feats, new_norm = self.hparams.normalize(
            feats, batch["sig_lens"], state=self._bound_extra["norm"],
            epoch=0, training=stage == JStage.TRAIN,
        )
        self._new_extra = {"norm": new_norm}
        src = self.modules.frontend(feats)
        enc, dec = self.modules.transformer(
            src, batch["tokens_bos"], wav_len=batch["sig_lens"], pad_idx=0)
        ctc_logp = jax.nn.log_softmax(
            self.modules.ctc_lin(enc).astype(jnp.float32), -1)
        seq_logp = jax.nn.log_softmax(
            self.modules.seq_lin(dec).astype(jnp.float32), -1)
        return ctc_logp, seq_logp

    def init_extra_state(self, batch):
        return {"norm": JNormState.init(CFG["n_mels"])}

    def compute_objectives(self, predictions, batch, stage):
        ctc_logp, seq_logp = predictions
        mask = batch["batch_mask"]
        loss_ctc = j_ctc_loss(ctc_logp, batch["tokens"],
                              batch["sig_lens"] * mask,
                              batch["tokens_lens"] * mask, blank_index=0,
                              reduction="batchmean")
        loss_seq = j_kldiv_loss(seq_logp, batch["tokens_eos"],
                                length=batch["tokens_eos_lens"] * mask,
                                label_smoothing=0.1, reduction="batchmean")
        return 0.3 * loss_ctc + 0.7 * loss_seq

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        if should_step:
            _, self.lr = self.noam()


def _batch(seed, B=3, U=5, seconds=0.5):
    """Synthetic batch with ragged signals and token counts; padded
    tokens are 0 (the pad index), eos follows the last real token."""
    rng = np.random.default_rng(seed)
    n_tok = np.array([U, U - 1, U - 2][:B])
    tokens = np.zeros((B, U), np.int64)
    bos = np.zeros((B, U + 1), np.int64)
    eos = np.zeros((B, U + 1), np.int64)
    for b, n in enumerate(n_tok):
        t = rng.integers(3, CFG["vocab_size"], n)
        t[1] = t[0]  # a repeated label: the CTC skip rule
        tokens[b, :n] = t
        bos[b, 0], bos[b, 1:n + 1] = 1, t
        eos[b, :n], eos[b, n] = t, 2
    return {
        "sig": (0.1 * rng.standard_normal((B, int(16000 * seconds)))
                ).astype(np.float32),
        "sig_lens": np.array([1.0, 0.8, 0.6][:B], np.float32),
        "tokens": tokens, "tokens_bos": bos, "tokens_eos": eos,
        "tokens_lens": (n_tok / U).astype(np.float32),
        "tokens_eos_lens": ((n_tok + 1) / (U + 1)).astype(np.float32),
    }


def _randomize(tree, rng, names=("bias", "pos_bias_u", "pos_bias_v")):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(dict(v), rng, names)
        elif k in names:
            out[k] = jnp.asarray(0.2 * rng.standard_normal(np.shape(v)),
                                 jnp.float32)
        else:
            out[k] = jnp.asarray(v)
    return out


def _jax_brain(opt, run_opts=None):
    modules = {
        "frontend": JFrontEnd(num_blocks=2, out_channels=CFG["frontend_channels"]),
        "transformer": JTransformerASR(
            tgt_vocab=CFG["vocab_size"], input_size=CFG["input_size"],
            d_model=CFG["d_model"], nhead=CFG["nhead"],
            num_encoder_layers=CFG["num_encoder_layers"],
            num_decoder_layers=CFG["num_decoder_layers"], d_ffn=CFG["d_ffn"],
            dropout=0.0, activation="relu", normalize_before=True,
            kernel_size=CFG["kernel_size"], encoder_module="conformer",
            attention_type="RelPosMHAXL",
        ),
        "ctc_lin": JLinear(n_neurons=CFG["vocab_size"]),
        "seq_lin": JLinear(n_neurons=CFG["vocab_size"]),
    }
    brain = _JaxRecipeBrain(
        modules=modules, opt_class=opt,
        hparams={"lr": LR0,
                 "normalize": JInputNorm(norm_type="global",
                                         update_until_epoch=4)},
        run_opts={"seed": 0, "loss_sync_interval": 1, **(run_opts or {})},
    )
    brain._ensure_initialized(brain.prepare_batch(_batch(0)))
    state = jax.device_get(brain.train_state)
    params = _randomize(state["params"], np.random.default_rng(5))
    brain.train_state = {**brain.train_state, "params": params}
    return brain


def _jax_pieces(brain):
    state = jax.device_get(brain.train_state)
    p = state["params"]
    return {
        "frontend": {"params": p["frontend"],
                     "batch_stats": state["model_state"]["frontend"]["batch_stats"]},
        "transformer": p["transformer"], "ctc_lin": p["ctc_lin"],
        "seq_lin": p["seq_lin"], "norm": state["extra"]["norm"],
    }


def _to_port(pieces):
    return bridge.conformer_asr_state_dict(
        pieces["frontend"], pieces["transformer"], pieces["ctc_lin"],
        pieces["seq_lin"], pieces["norm"])


def _port_brain(jbrain, opt, run_opts=None):
    brain = ConformerASRBrain(
        CFG, opt_class=opt, device="cpu",
        run_opts={"loss_sync_interval": 1, **(run_opts or {})},
        hparams={"lr": LR0},
    )
    brain.modules.load_state_dict(_to_port(_jax_pieces(jbrain)))
    return brain


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _compare(jbrain, pbrain, atol, loose=(), loose_atol=None, skip=()):
    """Post-step state in the port's layout and in the JAX layout: every
    entry within ``atol``; entries whose name contains one of ``loose``
    within ``loose_atol``; those containing one of ``skip`` are not
    compared.  Returns the largest deviation."""
    port_sd = {k: v.numpy() for k, v in pbrain.modules.state_dict().items()}
    jax_sd = {k: v.numpy() for k, v in _to_port(_jax_pieces(jbrain)).items()}
    assert port_sd.keys() == jax_sd.keys()
    worst = 0.0
    pairs = [(port_sd, jax_sd)]
    j_flat = _flat(_jax_pieces(jbrain))
    p_flat = _flat(bridge.to_jax_conformer_asr(pbrain.modules.state_dict()))
    assert p_flat.keys() == j_flat.keys()
    pairs.append((p_flat, j_flat))
    for got, ref in pairs:
        for k in ref:
            if any(s in k for s in skip):
                continue
            dev = float(np.max(np.abs(got[k] - ref[k]))) if ref[k].size else 0.0
            bound = loose_atol if any(s in k for s in loose) else atol
            assert dev <= bound, f"{k}: max|port - jax| {dev} > {bound}"
            worst = max(worst, dev)
    return worst


def _loss_close(a, b, rtol=1e-5):
    assert abs(float(a) - float(b)) <= rtol * max(1.0, abs(float(b))), (a, b)


def test_sgd_one_step_matches_jax():
    """SGD, one step (clip 5.0): the loss within 1e-5 relative and every
    post-step parameter and statistic within 1e-5 (the tolerance of the
    JAX package's dp-invariance check; f32 sums in other orders)."""
    jb = _jax_brain(lambda lr: optax.sgd(lr))
    pb = _port_brain(jb, lambda p: torch.optim.SGD(p, lr=LR0))
    batch = _batch(1)
    jb.step = pb.step = 1
    j_loss = jb.fit_batch(batch)
    p_loss = pb.fit_batch(batch)
    _loss_close(p_loss, j_loss)
    assert pb.optimizer_step == jb.optimizer_step == 1
    assert pb.lr == pytest.approx(jb.lr, rel=1e-12)
    _compare(jb, pb, atol=1e-5)


def _adamw_jax(lr):
    return optax.adamw(lr, b1=0.9, b2=0.98, eps=1e-9, weight_decay=1e-4)


def _adamw_port(params):
    return torch.optim.AdamW(params, betas=(0.9, 0.98), eps=1e-9,
                             weight_decay=1e-4)


# The front-end convolutions' biases feed a training-mode BatchNorm,
# which removes them; the attention key biases and the columns of
# ``pos_proj`` that multiply the nearly constant low-frequency features
# of the relative positional encoding add a per-row constant to the
# scores, which the softmax removes.  Their gradient is 0 analytically and rounding noise
# (~1e-10) numerically, which Adam's g / (sqrt(v) + 1e-9) turns into
# steps of up to +-lr with a sign that differs between the frameworks
# (the JAX package's dp-invariance check uses SGD for this reason).
# They, and the running means they shift, are held to 2 lr per step
# instead; the SGD tests hold them to 1e-5.
_NOISE = ("convs.0.bias", "convs.1.bias", "norms.0.running_mean",
          "norms.1.running_mean", "Conv2d_0/Conv_0/bias",
          "Conv2d_1/Conv_0/bias", "BatchNorm1d_0/BatchNorm_0/mean",
          "BatchNorm1d_1/BatchNorm_0/mean", "pos_proj", "k_proj.bias",
          "k_proj/bias")


def test_adamw_three_steps_match_jax():
    """AdamW (0.9, 0.98, 1e-9, weight decay 1e-4) with clip 5.0 and the
    Noam schedule over 3 steps on 3 batches: each loss within 1e-5
    relative, every parameter within 1e-5 but the noise-driven ones
    (see ``_NOISE``)."""
    jb = _jax_brain(_adamw_jax)
    pb = _port_brain(jb, _adamw_port)
    for i in range(3):
        batch = _batch(10 + i)
        jb.step = pb.step = i + 1
        _loss_close(pb.fit_batch(batch), jb.fit_batch(batch))
        assert pb.lr == pytest.approx(jb.lr, rel=1e-12)
    _compare(jb, pb, atol=1e-5, loose=_NOISE, loose_atol=2 * 3 * 2e-3)


def test_grad_accumulation_matches_jax():
    """``grad_accumulation_factor`` 2 (SGD): the optimizer steps on the
    second batch with the mean of the two gradients."""
    opts = {"grad_accumulation_factor": 2}
    jb = _jax_brain(lambda lr: optax.sgd(lr), opts)
    pb = _port_brain(jb, lambda p: torch.optim.SGD(p, lr=LR0), opts)
    for step in (1, 2):
        batch = _batch(20 + step)
        jb.step = pb.step = step
        _loss_close(pb.fit_batch(batch), jb.fit_batch(batch))
    assert pb.optimizer_step == jb.optimizer_step == 1
    _compare(jb, pb, atol=1e-5)


def test_nonfinite_loss_zeroes_gradients_and_counts_like_jax():
    """A batch whose loss is not finite: the gradients are zeroed but
    the optimizer still steps (AdamW: only its decay and moments move
    the parameters), the statistics still update, and the loss counts
    toward the patience at the sync."""
    jb = _jax_brain(_adamw_jax)
    pb = _port_brain(jb, _adamw_port)
    batch = _batch(30)
    batch["sig"][0, :100] = np.inf
    key = "transformer.custom_src_module.weight"
    w0 = pb.modules.state_dict()[key].clone()
    jb.step = pb.step = 1
    j_loss, p_loss = jb.fit_batch(batch), pb.fit_batch(batch)
    assert not np.isfinite(j_loss) and not np.isfinite(p_loss)
    assert pb.nonfinite_count == jb.nonfinite_count == 1
    assert pb.optimizer_step == jb.optimizer_step == 1
    # the statistics took the inf (NaN in both); the parameters agree
    _compare(jb, pb, atol=1e-5, skip=("normalize.", "norm/", "running_",
                                      "BatchNorm_0/mean", "BatchNorm_0/var"))
    # zero gradients: only the weight decay moved the weights
    torch.testing.assert_close(pb.modules.state_dict()[key],
                               w0 * (1 - LR0 * 1e-4), atol=1e-7, rtol=0)
    pb.nonfinite_patience = 0
    pb.step = 2
    with pytest.raises(ValueError, match="patience"):
        pb.fit_batch(batch)


def test_fit_batches_equals_fit_batch_steps():
    """``fit_batches`` over K = 2 gives the same losses and parameters
    as two ``fit_batch`` steps at the same learning rate."""
    opts = {"loss_sync_interval": 100}
    jb = _jax_brain(_adamw_jax)
    a = _port_brain(jb, _adamw_port, opts)
    b = _port_brain(jb, _adamw_port, opts)
    # a constant learning rate in both (no Noam step between batches)
    a.on_fit_batch_end = b.on_fit_batch_end = lambda *args: None
    batches = [_batch(40), _batch(41)]
    losses = a.fit_batches(batches)
    singles = []
    for i, batch in enumerate(batches):
        b.step = i + 1
        singles.append(b.fit_batch(batch))
    torch.testing.assert_close(losses, torch.stack(singles), atol=0, rtol=0)
    for (k, x), y in zip(a.modules.state_dict().items(),
                         b.modules.state_dict().values()):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=k)
    assert a.optimizer_step == b.optimizer_step == 2


def test_evaluate_batch_matches_jax_and_leaves_state():
    jb = _jax_brain(lambda lr: optax.sgd(lr))
    pb = _port_brain(jb, lambda p: torch.optim.SGD(p, lr=LR0))
    before = {k: v.clone() for k, v in pb.modules.state_dict().items()}
    batch = _batch(50)
    _loss_close(pb.evaluate_batch(batch, None),
                jb.evaluate_batch(batch, JStage.VALID))
    for k, v in pb.modules.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_trained_state_dict_serves():
    """The brain's modules load into ``ConformerASR`` for serving."""
    from speechbrain_tpu_torch.asr import ConformerASR

    pb = ConformerASRBrain(CFG, device="cpu",
                           run_opts={"loss_sync_interval": 1})
    pb.step = 1
    pb.fit_batch(_batch(60))
    asr = ConformerASR(CFG, device="cpu")
    asr.load_state_dict(pb.modules.state_dict())
    assert all(p.dtype == torch.float32 for p in asr.parameters())
    hyps, scores = asr.transcribe(torch.zeros(1, 8000), torch.ones(1),
                                  beam_size=2)
    assert len(hyps) == 1 and np.isfinite(scores).all()
