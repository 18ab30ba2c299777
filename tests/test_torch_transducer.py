"""The conformer-transducer slice of the port against the JAX package,
on the CPU, from the same numpy inputs.

- The RNN-T loss (K8 alpha, K9 beta and the occupancy gradients, their
  plain versions on the CPU) through both entries,
  ``transducer_loss_logits`` and ``transducer_loss_per_seq``, against the
  JAX Pallas entries in interpret mode and against the scan backend
  ``transducer_forward_loss`` with ``jax.grad``: ragged lengths, T = 1,
  U_b = 0 and U_b = U, U+1 > 128, blank != 0, ``normalize_by_T``.  A row
  with T_b = 0 follows the kernels (loss 0, zero gradient).  Tolerance
  1e-4 (the JAX package's own for these entries).
- ``transducer_loss`` (reductions, length rounding), ``GRU``,
  ``Embedding`` and ``Transducer_joint`` through the bridge, within 1e-5.
- ``ConformerTransducer``'s logits against the JAX modules (f32, toy
  config), and ``ConformerTransducerBrain`` against a JAX ``Brain`` built
  as the recipe's ``Transducer``
  (``recipes/LibriSpeech/ASR/transducer/train.py:27-100``): one SGD step
  and 3 AdamW steps within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import speechbrain_tpu.ops.pallas.transducer as jpt
from speechbrain_tpu.core import Brain as JBrain
from speechbrain_tpu.core import Stage as JStage
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JTransformerASR,
)
from speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu.nnet.loss.transducer_loss import (
    transducer_forward_loss as j_scan_loss,
)
from speechbrain_tpu.nnet.losses import transducer_loss as j_transducer_loss
from speechbrain_tpu.nnet.RNN import GRU as JGRU
from speechbrain_tpu.nnet.schedulers import NoamScheduler as JNoam
from speechbrain_tpu.nnet.transducer.transducer_joint import (
    Transducer_joint as JJoint,
)
from speechbrain_tpu.parallel.mesh import make_mesh
from speechbrain_tpu.processing.features import (
    GlobalNormState as JNormState,
)
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import (
    CONFORMER_TRANSDUCER,
    ConformerTransducer,
    ConformerTransducerBrain,
)
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.loss.transducer_loss import (
    TransducerLoss,
    transducer_forward_loss,
)
from speechbrain_tpu_torch.nnet.losses import transducer_loss
from speechbrain_tpu_torch.nnet.RNN import GRU
from speechbrain_tpu_torch.nnet.transducer.transducer_joint import (
    Transducer_joint,
)
from speechbrain_tpu_torch.ops import transducer as ot

from .test_torch_kernels import jax_value_and_grad
from .test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.fixture
def interpret(monkeypatch):
    """The JAX lattice kernels in Pallas interpret mode (as the JAX
    package's own tests run them on the CPU)."""
    monkeypatch.setattr(
        jpt.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, T, U, V, t_lens, u_lens, blank, seed):
    """Random logits; random labels other than blank, padded with the pad
    id 0 past each U_b."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, U)).astype(np.int32)
    targets[targets == blank] = (blank + 1) % V
    for b, n in enumerate(u_lens):
        targets[b, n:] = 0
    return (logits, targets, np.asarray(t_lens, np.int32),
            np.asarray(u_lens, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_loss_and_grad(entry, x, targets, t_lens, u_lens, blank, norm):
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    loss = entry(xt, *_torch(targets, t_lens, u_lens), blank,
                 normalize_by_T=norm)
    loss.sum().backward()
    return loss.detach().numpy(), xt.grad.numpy()


def _value_and_grad(fn):
    """``fn(z)`` and the gradient of its sum, from one compiled function
    (``test_torch_kernels.jax_value_and_grad``)."""
    def f(z):
        out = fn(z)
        return out.sum(), out
    return jax_value_and_grad(f)


def _close(got, ref, what, tol=1e-4):
    assert np.shape(got) == np.shape(ref), (what, np.shape(got), np.shape(ref))
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref)), initial=0.0))
    assert err <= tol, f"{what}: max|port - jax| {err} > {tol}"


# (B, T, U, V, t_lens, u_lens, blank, normalize_by_T)
CASES = {
    "ragged": (3, 9, 4, 7, [9, 7, 5], [4, 3, 2], 0, False),
    "blank3_norm": (3, 9, 4, 7, [9, 6, 4], [4, 1, 3], 3, True),
    "T1": (2, 1, 3, 5, [1, 1], [3, 0], 0, False),
    "u0_and_uU": (3, 6, 4, 6, [6, 5, 3], [0, 4, 4], 0, True),
    "U1_above_128": (2, 4, 130, 5, [4, 3], [130, 71], 2, False),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_loss_logits_matches_jax(interpret, case):
    """``transducer_loss_logits`` against ``transducer_loss_pallas_logits``
    (interpret mode) and against the scan on log_softmax, loss and
    d loss / d logits."""
    B, T, U, V, tl, ul, blank, norm = case
    x, tg, tl, ul = _inputs(B, T, U, V, tl, ul, blank, seed=U + T)
    got, g_got = _port_loss_and_grad(ot.transducer_loss_logits, x, tg, tl,
                                     ul, blank, norm)

    def pallas(z):
        return jpt.transducer_loss_pallas_logits(z, tg, tl, ul, blank, norm)

    def scan(z):
        return j_scan_loss(jax.nn.log_softmax(z, -1), tg, tl, ul, blank, norm)

    xj = jnp.asarray(x)
    for name, fn in (("pallas", pallas), ("scan", scan)):
        (_, loss), grad = _value_and_grad(fn)(xj)
        _close(got, loss, f"{name} loss")
        _close(g_got, grad, f"{name} grad")


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_loss_per_seq_matches_jax(interpret, case):
    """``transducer_loss_per_seq`` against ``transducer_loss_pallas`` and
    the scan, on log-probabilities."""
    B, T, U, V, tl, ul, blank, norm = case
    x, tg, tl, ul = _inputs(B, T, U, V, tl, ul, blank, seed=U + T + 1)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))
    got, g_got = _port_loss_and_grad(ot.transducer_loss_per_seq, lp, tg, tl,
                                     ul, blank, norm)
    for name, fn in (("pallas", jpt.transducer_loss_pallas),
                     ("scan", j_scan_loss)):
        def f(z, fn=fn):
            return fn(z, tg, tl, ul, blank, norm)

        (_, loss), grad = _value_and_grad(f)(jnp.asarray(lp))
        _close(got, loss, f"{name} loss")
        _close(g_got, grad, f"{name} grad")


@pytest.mark.parametrize("logits", [True, False])
def test_wide_lattice_matches_jax(interpret, logits):
    """U+1 = 1030 columns, above the 1024 that the port's kernels once
    took: the plain recursions against the JAX Pallas entries (interpret
    mode), loss and gradient.  (JAX's scan form walks U in Python-sized
    steps: a minute at this width, so it is left to the narrow cases.)"""
    x, tg, tl, ul = _inputs(2, 8, 1029, 2, [8, 6], [1029, 700], 0, seed=3)
    if not logits:
        x = np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))
    entry = ot.transducer_loss_logits if logits else ot.transducer_loss_per_seq
    got, g_got = _port_loss_and_grad(entry, x, tg, tl, ul, 0, False)
    pallas = (jpt.transducer_loss_pallas_logits if logits
              else jpt.transducer_loss_pallas)

    def fn(z):
        return pallas(z, tg, tl, ul, 0, False)

    (_, loss), grad = _value_and_grad(fn)(jnp.asarray(x))
    # losses ~ 1e3 (a thousand emissions, V = 2), where one f32 ulp is
    # 6e-5: the two forms' sums agree to a few ulps, 1e-6 relative; the
    # occupancies exp(alpha + beta - logZ) in [-1, 0] carry that absolute
    # error of the exponent as a relative one
    np.testing.assert_allclose(got, np.asarray(loss), rtol=1e-6)
    _close(g_got, grad, "grad", tol=1e-3)


def test_zero_frame_row_follows_the_kernels(interpret):
    """A row with T_b = 0 (a masked replica row): the lattice kernels never
    harvest it, so loss 0 and zero gradient, as the JAX Pallas entry
    gives; the scan backend gives -blank[b, 0, 0] instead (the row's U_b
    is 0 too, as a masked row's is)."""
    x, tg, tl, ul = _inputs(3, 6, 3, 5, [6, 0, 4], [3, 0, 1], 0, seed=4)
    got, g_got = _port_loss_and_grad(ot.transducer_loss_logits, x, tg, tl,
                                     ul, 0, False)
    assert got[1] == 0.0 and not np.any(g_got[1])
    pallas = jpt.transducer_loss_pallas_logits(jnp.asarray(x), tg, tl, ul, 0)
    _close(got, pallas, "pallas loss")
    scan = np.asarray(j_scan_loss(jax.nn.log_softmax(jnp.asarray(x), -1),
                                  tg, tl, ul, 0))
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))
    np.testing.assert_allclose(scan[1], -lp[1, 0, 0, 0], rtol=1e-6)
    _close(got[[0, 2]], scan[[0, 2]], "scan loss, other rows")


def _plain_vs_tpu_kernels(B, T, U, V, t_lens, u_lens, seed):
    """K8 and K9's plain versions against ``_run_forward`` and
    ``_run_backward`` on ``_pad_tables``' tables: alpha on the live cells
    (t < T_b, u <= U_b), final, dblank and demit everywhere, within 1e-4."""
    x, tg, tl, ul = _inputs(B, T, U, V, t_lens, u_lens, 0, seed=seed)
    lp = jax.nn.log_softmax(jnp.asarray(x), -1)
    blank_lp = lp[..., 0]
    emit_lp = jnp.take_along_axis(lp[:, :, :U], tg[:, None, :, None], -1)[..., 0]
    bf, ef, tp, up, _, _ = jpt._pad_tables(blank_lp, emit_lp, tl, ul)
    alpha_j, final_j = jpt._run_forward(bf, ef, tp, up)
    db_j, de_j = jpt._run_backward(bf, ef, alpha_j, up, tp, final_j)
    alpha_j = np.swapaxes(np.asarray(alpha_j), 0, 1)[:B, :, :U + 1]
    db_j = np.swapaxes(np.asarray(db_j), 0, 1)[:B, :, :U + 1]
    de_j = np.swapaxes(np.asarray(de_j), 0, 1)[:B, :, :U]

    blank, emit = ot.transducer_tables(
        *_torch(np.asarray(lp), tg), 0, *_torch(tl, ul))
    np.testing.assert_array_equal(blank.numpy(), np.swapaxes(
        np.asarray(bf), 0, 1)[:B, :, :U + 1])
    alpha, final = ot.transducer_alpha(blank, emit, *_torch(tl, ul))
    db, de = ot.transducer_beta_grad(blank, emit, alpha, *_torch(tl, ul), final)
    live = np.zeros_like(alpha_j, bool)
    for b in range(B):
        live[b, :tl[b], :ul[b] + 1] = True
    _close(alpha.numpy()[live], alpha_j[live], "alpha")
    _close(final.numpy(), np.asarray(final_j)[:B], "final")
    _close(db.numpy(), db_j, "dblank")
    _close(de.numpy(), de_j, "demit")


def test_kernel_functions_match_the_tpu_kernels(interpret):
    """K8 and K9's plain versions against ``_run_forward`` and
    ``_run_backward`` on ``_pad_tables``' tables: alpha on the live cells
    (t < T_b, u <= U_b), final, dblank and demit everywhere."""
    _plain_vs_tpu_kernels(3, 7, 5, 6, [7, 5, 3], [5, 2, 0], seed=9)


@pytest.mark.parametrize("U", [0, 31, 32, 63, 64, 96, 128])
def test_plain_matches_jax_at_chain_widths(interpret, U):
    """The same at the widths where the card kernels change shape (one to
    five chain warps of 32 columns, one a lane: U+1 = 1 ... 129),
    B 3, T 5: a U_b = U row, a U_b = 0 row and a T_b = 0 row (final 0,
    zero gradients, as the TPU kernels give).  Tolerance 1e-4, the JAX
    package's own for these entries."""
    _plain_vs_tpu_kernels(3, 5, U, 6, [5, 3, 0], [U, 0, min(U, 7)],
                          seed=100 + U)


def test_scan_form_matches_jax():
    """The port's copy of the scan form, loss and gradient through
    autograd, against JAX's with ``jax.grad`` (a T_b = 0 row included: the
    scan's own semantics)."""
    x, tg, tl, ul = _inputs(3, 8, 4, 6, [8, 0, 5], [4, 2, 1], 0, seed=2)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))
    for norm in (False, True):
        got, g_got = _port_loss_and_grad(
            lambda *a, normalize_by_T: transducer_forward_loss(
                *a, normalize_by_T=normalize_by_T),
            lp, tg, tl, ul, 0, norm)

        def f(z, norm=norm):
            return j_scan_loss(z, tg, tl, ul, 0, norm)

        _close(got, f(jnp.asarray(lp)), "scan loss")
        _close(g_got, jax.grad(lambda z: f(z).sum())(jnp.asarray(lp)),
               "scan grad")


@pytest.mark.parametrize("reduction", ["mean", "batch", "sum"])
def test_transducer_loss_reductions_and_rounding(reduction):
    """``transducer_loss`` with relative lengths whose absolute values fall
    on .5 (T 6: 0.75 -> 4.5 -> 4, 0.25 -> 1.5 -> 2; U 4: 0.625 -> 2.5 ->
    2): both round half to even; against JAX's ``transducer_loss`` (scan
    backend on the CPU; no row has T_b = 0)."""
    x, tg, _, _ = _inputs(3, 6, 4, 5, [6, 6, 6], [4, 2, 2], 0, seed=6)
    rel_t = np.array([1.0, 0.75, 0.25], np.float32)
    rel_u = np.array([1.0, 0.625, 0.5], np.float32)
    got = transducer_loss(*_torch(x, tg, rel_t, rel_u), blank_index=0,
                          reduction=reduction)
    ref = j_transducer_loss(jnp.asarray(x), tg, rel_t, rel_u, blank_index=0,
                            reduction=reduction)
    _close(got.numpy(), ref, f"transducer_loss {reduction}")
    per_seq = TransducerLoss(0)(*_torch(x, tg), torch.tensor([6, 4, 2]),
                                torch.tensor([4, 2, 2]))
    batch = transducer_loss(*_torch(x, tg, rel_t, rel_u), blank_index=0,
                            reduction="batch")
    torch.testing.assert_close(batch, per_seq, atol=0, rtol=0)


def _randomized(params, rng, names=("bias", "u_bias")):
    """Random biases (Flax initialises them to zero, which would hide a
    misplaced bias)."""
    out = {}
    for k, v in params.items():
        if hasattr(v, "items"):
            out[k] = _randomized(dict(v), rng, names)
        elif any(k.endswith(n) for n in names):
            out[k] = jnp.asarray(0.3 * rng.standard_normal(np.shape(v)),
                                 jnp.float32)
        else:
            out[k] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("layers,bidir", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("with_hx", [False, True])
def test_gru_matches_jax(layers, bidir, with_hx):
    """Outputs and last states through the bridge, with and without an
    incoming state in torch's (L*D, B, H) layout."""
    rng = np.random.default_rng(layers + 2 * bidir)
    B, T, C, H = 3, 7, 5, 6
    D = 2 if bidir else 1
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    hx = rng.standard_normal((layers * D, B, H)).astype(np.float32)
    jgru = JGRU(hidden_size=H, num_layers=layers, bidirectional=bidir)
    params = jgru.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomized(params, rng)
    jhx = jnp.asarray(hx) if with_hx else None
    y_ref, h_ref = jgru.apply({"params": params}, jnp.asarray(x), hx=jhx,
                              train=False)
    gru = GRU(C, H, num_layers=layers, bidirectional=bidir)
    gru.load_state_dict(bridge.gru(params))
    with torch.no_grad():
        y, h = gru(torch.from_numpy(x),
                   hx=torch.from_numpy(hx) if with_hx else None)
    _close(y.numpy(), y_ref, "gru y", 1e-5)
    _close(h.numpy(), h_ref, "gru h", 1e-5)
    back = bridge.to_jax_gru(gru.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("one_hot", [False, True])
def test_embedding_matches_jax(one_hot):
    tokens = np.array([[0, 3, 5, 1], [2, 2, 0, 4]], np.int32)
    jemb = JEmbedding(num_embeddings=6, embedding_dim=4,
                      consider_as_one_hot=one_hot, blank_id=2)
    v = jemb.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    ref = jemb.apply(v, jnp.asarray(tokens))
    emb = Embedding(6, 4, consider_as_one_hot=one_hot, blank_id=2)
    emb.load_state_dict(bridge.embedding(v.get("params", {})))
    with torch.no_grad():
        got = emb(torch.from_numpy(tokens))
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got.numpy(), ref, "embedding", 1e-5)


@pytest.mark.parametrize("joint", ["sum", "concat"])
@pytest.mark.parametrize("act", ["tanh", "relu", "leaky_relu"])
def test_transducer_joint_matches_jax(joint, act):
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 5, 4)).astype(np.float32)
    pred = rng.standard_normal((2, 3, 4 if joint == "sum" else 6)).astype(
        np.float32)
    jj = JJoint(joint=joint, joint_dim=7, nonlinearity=act)
    v = jj.init(jax.random.PRNGKey(2), jnp.asarray(enc), jnp.asarray(pred))
    ref = jj.apply(v, jnp.asarray(enc), jnp.asarray(pred))
    mod = Transducer_joint(joint, 7, act, input_size=enc.shape[-1] + pred.shape[-1])
    if joint == "concat":
        mod.linear.load_state_dict(bridge.dense(v["params"]["Dense_0"]))
    with torch.no_grad():
        got = mod(*_torch(enc, pred))
    _close(got.numpy(), ref, "joint", 1e-5)


# ------------------------------------------------------------------
# the model and the training step

CFG = dict(
    CONFORMER_TRANSDUCER, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=2, d_ffn=64, kernel_size=7,
    vocab_size=32, dec_emb_dim=16, dec_neurons=24, joint_dim=20,
    transformer_dropout=0.0, lr_adam=1e-3, n_warmup_steps=4,
    augmentation=None,
)
LR0 = 1e-3  # the first step's learning rate (hparams "lr"), then Noam


class _JaxRecipeBrain(JBrain):
    """The recipe's ``Transducer`` Brain without SpecAugment and the test
    search."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # one device, as the port trains (no masked replica rows)
        self.mesh = make_mesh(jax.devices()[:1])
        self.fbank = JFbank(n_mels=CFG["n_mels"])
        self.noam = JNoam(CFG["lr_adam"], CFG["n_warmup_steps"])

    def compute_forward(self, batch, stage):
        feats = self.fbank(batch["sig"])
        feats, new_norm = self.hparams.normalize(
            feats, batch["sig_lens"], state=self._bound_extra["norm"],
            epoch=0, training=stage == JStage.TRAIN)
        self._new_extra = {"norm": new_norm}
        src = self.modules.frontend(feats)
        enc = self.modules.transformer(src, batch["sig_lens"], method="encode")
        enc = self.modules.enc_lin(enc)
        pred, _ = self.modules.dec(self.modules.emb(batch["tokens_blank"]))
        pred = self.modules.dec_lin(pred)
        joint = jnp.tanh(enc[:, :, None, :] + pred[:, None, :, :])
        return self.modules.out_lin(joint).astype(jnp.float32), enc

    def init_extra_state(self, batch):
        return {"norm": JNormState.init(CFG["n_mels"])}

    def compute_objectives(self, predictions, batch, stage):
        logits, _ = predictions
        mask = batch["batch_mask"]
        return j_transducer_loss(
            logits, batch["tokens"], batch["sig_lens"] * mask,
            batch["tokens_lens"] * mask, blank_index=0, use_pallas=True)

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        if should_step:
            _, self.lr = self.noam()


def _batch(seed, B=3, U=5, seconds=0.5):
    """Ragged signals and token counts; tokens padded with 0 (the pad id,
    which is also blank), tokens_blank = [blank] + tokens."""
    rng = np.random.default_rng(seed)
    n_tok = np.array([U, U - 1, U - 2][:B])
    tokens = np.zeros((B, U), np.int64)
    for b, n in enumerate(n_tok):
        tokens[b, :n] = rng.integers(1, CFG["vocab_size"], n)
    return {
        "sig": (0.1 * rng.standard_normal((B, int(16000 * seconds)))
                ).astype(np.float32),
        "sig_lens": np.array([1.0, 0.8, 0.6][:B], np.float32),
        "tokens": tokens,
        "tokens_lens": (n_tok / U).astype(np.float32),
        "tokens_blank": np.concatenate([np.zeros((B, 1), np.int64), tokens], 1),
    }


def _jax_modules():
    return {
        "frontend": JFrontEnd(num_blocks=2, out_channels=CFG["frontend_channels"]),
        "transformer": JTransformerASR(
            tgt_vocab=CFG["vocab_size"], input_size=CFG["input_size"],
            d_model=CFG["d_model"], nhead=CFG["nhead"],
            num_encoder_layers=CFG["num_encoder_layers"],
            num_decoder_layers=0, d_ffn=CFG["d_ffn"], dropout=0.0,
            kernel_size=CFG["kernel_size"], encoder_module="conformer",
            attention_type="RelPosMHAXL",
        ),
        "enc_lin": JLinear(n_neurons=CFG["joint_dim"]),
        "emb": JEmbedding(num_embeddings=CFG["vocab_size"],
                          embedding_dim=CFG["dec_emb_dim"]),
        "dec": JGRU(hidden_size=CFG["dec_neurons"], num_layers=1),
        "dec_lin": JLinear(n_neurons=CFG["joint_dim"]),
        "out_lin": JLinear(n_neurons=CFG["vocab_size"]),
    }


def _jax_brain(opt):
    brain = _JaxRecipeBrain(
        modules=_jax_modules(), opt_class=opt,
        hparams={"lr": LR0,
                 "normalize": JInputNorm(norm_type="global",
                                         update_until_epoch=4)},
        run_opts={"seed": 0, "loss_sync_interval": 1},
    )
    brain._ensure_initialized(brain.prepare_batch(_batch(0)))
    state = jax.device_get(brain.train_state)
    params = _randomized(state["params"], np.random.default_rng(5),
                         ("bias", "u_bias", "pos_bias_u", "pos_bias_v"))
    brain.train_state = {**brain.train_state, "params": params}
    return brain


_NAMES = ("enc_lin", "emb", "dec", "dec_lin", "out_lin")


def _jax_pieces(brain):
    state = jax.device_get(brain.train_state)
    p = state["params"]
    return {
        "frontend": {"params": p["frontend"],
                     "batch_stats": state["model_state"]["frontend"]["batch_stats"]},
        "transformer": p["transformer"], **{n: p[n] for n in _NAMES},
        "norm": state["extra"]["norm"],
    }


def _to_port(pieces):
    return bridge.conformer_transducer_state_dict(
        pieces["frontend"], pieces["transformer"],
        *(pieces[n] for n in _NAMES), pieces["norm"])


def _port_brain(jbrain, opt):
    brain = ConformerTransducerBrain(
        CFG, opt_class=opt, device="cpu", run_opts={"loss_sync_interval": 1},
        hparams={"lr": LR0})
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


def _compare(jbrain, pbrain, atol, loose=(), loose_atol=None):
    """Post-step parameters and statistics, in the port's layout and in
    the JAX layout (``bridge.to_jax_conformer_transducer``)."""
    port_sd = {k: v.numpy() for k, v in pbrain.modules.state_dict().items()}
    jax_sd = {k: v.numpy() for k, v in _to_port(_jax_pieces(jbrain)).items()}
    j_flat = _flat(_jax_pieces(jbrain))
    p_flat = _flat(bridge.to_jax_conformer_transducer(pbrain.modules.state_dict()))
    for got, ref in ((port_sd, jax_sd), (p_flat, j_flat)):
        assert got.keys() == ref.keys()
        for k in ref:
            dev = float(np.max(np.abs(got[k] - ref[k]))) if ref[k].size else 0.0
            bound = loose_atol if any(s in k for s in loose) else atol
            assert dev <= bound, f"{k}: max|port - jax| {dev} > {bound}"


def _loss_close(a, b, rtol=1e-5):
    assert abs(float(a) - float(b)) <= rtol * max(1.0, abs(float(b))), (a, b)


def _jax_forward_eval(jb, batch):
    """The JAX brain's ``compute_forward`` in eval mode, outside jit."""
    st = jb.train_state
    jb._bind(st["params"], st["model_state"], st["extra"], None, train=False)
    return jb.compute_forward(jb.prepare_batch(batch), JStage.VALID)


def test_model_logits_match_jax():
    """``ConformerTransducer`` in eval mode (stored normalization and
    BatchNorm statistics) against the JAX modules, f32: the encoder side
    within 1e-5 and the logits within 1e-4."""
    jb = _jax_brain(lambda lr: optax.sgd(lr))
    model = ConformerTransducer(CFG, device="cpu")
    model.load_state_dict(_to_port(_jax_pieces(jb)))
    batch = _batch(3)
    j_logits, j_enc = _jax_forward_eval(jb, batch)
    with torch.no_grad():
        logits, enc = model(*_torch(batch["sig"], batch["sig_lens"],
                                    batch["tokens_blank"]))
    assert logits.shape == j_logits.shape and logits.dtype == torch.float32
    _close(enc.numpy(), j_enc, "enc", 1e-5)
    _close(logits.numpy(), j_logits, "logits")


def test_sgd_one_step_matches_jax():
    """SGD, one step (clip 5.0): the loss within 1e-5 relative and every
    post-step parameter and statistic within 1e-5."""
    jb = _jax_brain(lambda lr: optax.sgd(lr))
    pb = _port_brain(jb, lambda p: torch.optim.SGD(p, lr=LR0))
    batch = _batch(1)
    jb.step = pb.step = 1
    _loss_close(pb.fit_batch(batch), jb.fit_batch(batch))
    assert pb.optimizer_step == jb.optimizer_step == 1
    assert pb.lr == pytest.approx(jb.lr, rel=1e-12)
    _compare(jb, pb, atol=1e-5)


# Parameters whose gradient is zero analytically (the front-end conv
# biases before a training BatchNorm, the attention key biases and the
# ``pos_proj`` columns of the constant low-frequency PE features: the
# softmax removes them), and the running means they shift: Adam turns
# their rounding noise into steps of up to +-lr of either sign in both
# frameworks, so they are held to 2 lr per step (the SGD test holds them
# to 1e-5).
_NOISE = ("convs.0.bias", "convs.1.bias", "norms.0.running_mean",
          "norms.1.running_mean", "Conv2d_0/Conv_0/bias",
          "Conv2d_1/Conv_0/bias", "BatchNorm1d_0/BatchNorm_0/mean",
          "BatchNorm1d_1/BatchNorm_0/mean", "pos_proj", "k_proj.bias",
          "k_proj/bias")


def test_adamw_three_steps_match_jax():
    """AdamW (0.9, 0.98, 1e-9, weight decay 1e-4) with clip 5.0 and the
    Noam schedule over 3 steps on 3 batches: each loss within 1e-5
    relative, every parameter within 1e-5 but the noise-driven ones."""
    def j_opt(lr):
        return optax.adamw(lr, b1=0.9, b2=0.98, eps=1e-9, weight_decay=1e-4)

    jb = _jax_brain(j_opt)
    pb = _port_brain(jb, None)  # the brain's default: the recipe's AdamW
    for i in range(3):
        batch = _batch(10 + i)
        jb.step = pb.step = i + 1
        _loss_close(pb.fit_batch(batch), jb.fit_batch(batch))
        assert pb.lr == pytest.approx(jb.lr, rel=1e-12)
    _compare(jb, pb, atol=1e-5, loose=_NOISE, loose_atol=2 * 3 * 2e-3)


def test_evaluate_runs_the_forward_lattice_only(monkeypatch):
    """A training step runs K8 and K9 once each, ``evaluate_batch`` K8
    only (here their plain versions, counted), and evaluation leaves
    every parameter and statistic as it was; its loss is JAX's."""
    calls = {"alpha": 0, "beta": 0}
    for key, name in (("alpha", "transducer_alpha_plain"),
                      ("beta", "transducer_beta_grad_plain")):
        fn = getattr(ot, name)

        def counted(*args, key=key, fn=fn):
            calls[key] += 1
            return fn(*args)

        monkeypatch.setattr(ot, name, counted)
    jb = _jax_brain(lambda lr: optax.sgd(lr))
    pb = _port_brain(jb, lambda p: torch.optim.SGD(p, lr=LR0))
    before = {k: v.clone() for k, v in pb.modules.state_dict().items()}
    batch = _batch(50)
    _loss_close(pb.evaluate_batch(batch, None),
                jb.evaluate_batch(batch, JStage.VALID))
    assert calls == {"alpha": 1, "beta": 0}
    for k, v in pb.modules.state_dict().items():
        assert torch.equal(v, before[k]), k
    pb.step = 1
    pb.fit_batch(batch)
    assert calls == {"alpha": 2, "beta": 1}


def test_masked_rows_give_zero_loss():
    """Rows of ``batch_mask`` 0 (a padded batch's replica rows) get
    T_b = U_b = 0: loss 0 in the per-utterance losses, so the ``mean``
    divides the real rows' sum by the padded batch size, as on the TPU."""
    pb = ConformerTransducerBrain(CFG, device="cpu")
    batch = pb.prepare_batch(_batch(7))
    batch["batch_mask"] = torch.tensor([1.0, 1.0, 0.0])
    pb.modules.eval()
    with torch.no_grad():
        logits, _ = pb.compute_forward(batch, None)
        full = pb.compute_objectives((logits, None), batch, None)
        per = transducer_loss(logits, batch["tokens"], batch["sig_lens"],
                              batch["tokens_lens"], 0, reduction="batch")
    torch.testing.assert_close(full, per[:2].sum() / 3)


def test_bridge_round_trip():
    """JAX pieces -> port state_dict -> JAX pieces, exactly; the model's
    own state_dict keys are the bridge's."""
    jb = _jax_brain(lambda lr: optax.sgd(lr))
    pieces = _jax_pieces(jb)
    sd = _to_port(pieces)
    model = ConformerTransducer(CFG, device="cpu")
    assert set(sd) == set(model.state_dict())
    back = _flat(bridge.to_jax_conformer_transducer(sd))
    ref = _flat(pieces)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
