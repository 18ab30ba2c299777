"""The CRDNN encoder of the transducer recipe's ``train.yaml`` against the
JAX package on the CPU, through ``bridge.py``: ``LayerNorm`` (3-d and
4-d, f32 and bf16), ``Dropout2d`` (its channel-shaped mask and keep
rate; no effect in eval), ``LiGRU`` (uni- and bidirectional, 2 layers:
training-mode outputs, last states, gradients and running statistics
after a step at Flax's momentum 0.95; eval mode; resuming from ``hx``;
bf16; the recurrent mask shared over time) and ``CRDNN`` (forward,
gradients and statistics; the bridge both ways).

Tolerances: f32 outputs and statistics within 1e-5 absolute; f32
gradients within 1e-5 of the largest entry of each tensor (the LiGRU's);
the CRDNN's train-mode outputs within 2e-5 of their largest entry and
its gradients within 5e-5 of the model's largest gradient entry (see
``test_crdnn_matches_jax``); bf16 within the bounds stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JCRDNN
from speechbrain_tpu.nnet.dropout import Dropout2d as JDropout2d
from speechbrain_tpu.nnet.normalization import LayerNorm as JLayerNorm
from speechbrain_tpu.nnet.RNN import LiGRU as JLiGRU
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.nnet.dropout import Dropout2d
from speechbrain_tpu_torch.nnet.normalization import LayerNorm
from speechbrain_tpu_torch.nnet.RNN import LiGRU

from .test_torch_kernels import one_torch_thread  # noqa: F401


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    dev = float(np.max(np.abs(got - want), initial=0))
    assert dev <= tol, f"{what}: max|port - jax| {dev} > {tol}"


def _close_rel(got, want, what, tol=1e-5):
    """Within ``tol`` of the largest entry of ``want``."""
    got, want = _np(got), _np(want)
    scale = max(float(np.max(np.abs(want), initial=0)), 1e-6)
    dev = float(np.max(np.abs(got - want), initial=0))
    assert dev <= tol * scale, f"{what}: {dev} > {tol} x {scale}"


def _randomize(tree, rng, scale=0.3):
    """Random values for zero-initialised leaves (biases, BatchNorm
    statistics), so that a misplaced one shows."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(dict(v), rng, scale)
        elif k in ("bias", "mean"):
            out[k] = jnp.asarray(scale * rng.standard_normal(np.shape(v)),
                                 jnp.float32)
        elif k in ("scale", "var"):
            out[k] = jnp.asarray(1 + scale * rng.random(np.shape(v)),
                                 jnp.float32)
        else:
            out[k] = jnp.asarray(v)
    return out


# ------------------------------------------------------------------ LayerNorm

@pytest.mark.parametrize("shape", [(3, 5, 7), (3, 5, 6, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(shape, dtype):
    """Normalized over every axis after (batch, time), affine parameters of
    the normalized shape; bf16 statistics in f32 as Flax computes them:
    the outputs equal to one bf16 rounding (2^-8 relative, 1e-5 in f32)."""
    rng = np.random.default_rng(len(shape))
    x = (2 + 3 * rng.standard_normal(shape)).astype(np.float32)
    jln = JLayerNorm()
    v = jln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": _randomize(v["params"], rng)}
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jln.apply(v, jx)
    ln = LayerNorm(shape[2:])
    ln.load_state_dict(bridge.layer_norm(v["params"]["LayerNorm_0"]))
    with torch.no_grad():
        got = ln(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype) and want.dtype == jx.dtype
    if dtype == "float32":
        _close(got, want, "layer norm")
    else:
        _close_rel(got.float(), want.astype(jnp.float32), "bf16 layer norm",
                   2 ** -8)


# ------------------------------------------------------------------ Dropout2d

def test_dropout2d_mask_is_channel_shaped():
    """One keep mask of shape (B, 1, 1, C): each (batch, channel) is kept
    or dropped over every time step and frequency, with the keep rate
    1 - p over 256 x 64 draws (within 4 standard deviations), the kept
    entries scaled by 1 / (1 - p); eval mode and p = 0 pass the input
    unchanged, as JAX's ``train=False`` does."""
    p = 0.3
    drop = Dropout2d(p).train()
    drop.generator = torch.Generator().manual_seed(5)
    x = torch.ones(256, 7, 5, 64)
    y = drop(x)
    assert torch.equal(y, y[:, :1, :1].expand_as(y))
    scaled = float(torch.tensor(1 / (1 - p)))  # 1 / (1 - p) in f32
    assert set(torch.unique(y).tolist()) == {0.0, scaled}
    kept = float((y[:, 0, 0] > 0).float().mean())
    assert abs(kept - (1 - p)) <= 4 * (p * (1 - p) / (256 * 64)) ** 0.5
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout2d(0.0).train()(x), x)
    want = JDropout2d(drop_rate=p).apply({}, jnp.asarray(x.numpy()),
                                         train=False)
    _close(drop(x), want, "eval dropout2d", 0.0)


# ------------------------------------------------------------------ LiGRU

B, T, C, H, LAYERS = 3, 6, 5, 4, 2


def _jax_ligru(bidir, x, rng):
    net = JLiGRU(hidden_size=H, num_layers=LAYERS, bidirectional=bidir)
    v = jax.jit(net.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    return net, {"params": _randomize(v["params"], rng),
                 "batch_stats": _randomize(v["batch_stats"], rng)}


def _port_ligru(bidir, v):
    net = LiGRU(C, H, num_layers=LAYERS, bidirectional=bidir)
    net.load_state_dict(bridge.ligru_state_dict(v["params"],
                                                v["batch_stats"]))
    return net


def _grads(net):
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in net.named_parameters()}
    sd.update(net.named_buffers())
    return bridge.to_jax_ligru(sd)[0]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


@pytest.mark.parametrize("bidir", [False, True])
def test_ligru_training_step_matches_jax(bidir):
    """Training mode, 2 layers, from an incoming ``hx`` in torch's
    (layers x D, B, H) layout: the outputs and last states within 1e-5,
    every parameter's gradient of a loss over both within 1e-5 of its
    largest entry, and the BatchNorms' running statistics after the step
    (``running = 0.95 running + 0.05 batch``, biased variance) within
    1e-5."""
    rng = np.random.default_rng(10 + bidir)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    D = 2 if bidir else 1
    hx = rng.standard_normal((LAYERS * D, B, H)).astype(np.float32)
    jnet, v = _jax_ligru(bidir, x, rng)

    def loss_fn(params, x, hx):
        (y, h), upd = jnet.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, x, hx=hx,
                                 train=True, mutable=["batch_stats"])
        return (y * y).sum() + (h ** 3).sum(), (y, h, upd["batch_stats"])

    (_, (y, h, stats)), (g, gx, ghx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        v["params"], jnp.asarray(x), jnp.asarray(hx))
    net = _port_ligru(bidir, v).train()
    xt = torch.from_numpy(x).requires_grad_()
    hxt = torch.from_numpy(hx).requires_grad_()
    yt, ht = net(xt, hx=hxt)
    ((yt * yt).sum() + (ht ** 3).sum()).backward()
    _close(yt.detach(), y, "y")
    _close(ht.detach(), h, "h")
    got = _flat(_grads(net))
    for k, want in _flat(g).items():
        _close_rel(got[k], want, f"grad {k}")
    _close_rel(xt.grad, gx, "grad x")
    _close_rel(hxt.grad, ghx, "grad hx")
    _, got_stats = bridge.to_jax_ligru(net.state_dict())
    for k, want in _flat(stats).items():
        _close(_flat(got_stats)[k], want, f"running {k}")


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("with_hx", [False, True])
def test_ligru_eval_matches_jax(bidir, with_hx):
    """Eval mode (the stored statistics), with and without an incoming
    state: outputs and last states within 1e-5; a sequence run in two
    halves, the second resumed from the first's ``h``, gives the whole
    run's outputs (unidirectional)."""
    rng = np.random.default_rng(20 + 2 * bidir + with_hx)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    D = 2 if bidir else 1
    hx = rng.standard_normal((LAYERS * D, B, H)).astype(np.float32)
    jnet, v = _jax_ligru(bidir, x, rng)
    jhx = jnp.asarray(hx) if with_hx else None
    y, h = jnet.apply(v, jnp.asarray(x), hx=jhx, train=False)
    net = _port_ligru(bidir, v).eval()
    with torch.no_grad():
        yt, ht = net(torch.from_numpy(x),
                     hx=torch.from_numpy(hx) if with_hx else None)
        _close(yt, y, "eval y")
        _close(ht, h, "eval h")
        if not bidir:
            y1, h1 = net(torch.from_numpy(x[:, :2]),
                         hx=torch.from_numpy(hx) if with_hx else None)
            y2, h2 = net(torch.from_numpy(x[:, 2:]), hx=h1)
            _close(torch.cat([y1, y2], 1), y, "resumed y")
            _close(h2, h, "resumed h")


def test_ligru_bf16_matches_jax():
    """bf16 input and f32 parameters: both run the recurrence in bf16
    (the port's ``addmm`` rounds w_t + h u once, JAX rounds the product
    and the sum), so outputs and last states agree within 3e-2 of their
    largest entry (a few bf16 ulps compounded over 6 steps and 2 layers),
    and the outputs stay bf16."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    jnet, v = _jax_ligru(True, x, rng)
    (y, h), _ = jnet.apply(v, jnp.asarray(x, jnp.bfloat16), train=True,
                           mutable=["batch_stats"])
    net = _port_ligru(True, v).train()
    with torch.no_grad():
        yt, ht = net(torch.from_numpy(x).to(torch.bfloat16))
    assert yt.dtype == ht.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    _close_rel(yt.float(), y.astype(jnp.float32), "bf16 y", 3e-2)
    _close_rel(ht.float(), h.astype(jnp.float32), "bf16 h", 3e-2)


def test_ligru_recurrent_mask_is_shared_over_time():
    """The recurrent dropout mask is one (N, H) keep mask a sequence, held
    over every step: with the BatchNorm's scale 0, its bias sets the
    candidate to 1 and the update gate to sigmoid(-30), so each output
    is the mask itself, constant over time, 0 or 1 / (1 - p), with the
    keep rate 1 - p over 2 x 64 x 128 entries (within 4 standard
    deviations); no dropout acts between layers (the second layer's
    outputs keep its own mask only)."""
    p, Bm, Hm = 0.4, 64, 128
    net = LiGRU(3, Hm, num_layers=2, bidirectional=True, dropout=p).train()
    net.drop.generator = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for layer in net.layers:
            layer.bn.weight.zero_()
            layer.weight_hh.zero_()
            layer.bn.bias[:Hm] = 1.0
            layer.bn.bias[Hm:] = -30.0
        y, _ = net(torch.randn(Bm, 9, 3))
    assert torch.allclose(y, y[:, :1].expand_as(y), atol=1e-6)
    vals = y[:, 0]
    scaled = 1 / (1 - p)
    assert bool(((vals.abs() < 1e-6) | ((vals - scaled).abs() < 1e-5)).all())
    kept = float((vals > 0.5).float().mean())
    assert abs(kept - (1 - p)) <= 4 * (p * (1 - p) / vals.numel()) ** 0.5


# ------------------------------------------------------------------ CRDNN

CRDNN_KW = dict(cnn_channels=(4, 6), rnn_neurons=5, dnn_neurons=7,
                rnn_layers=1, dnn_blocks=2, dropout=0.0)


def _jax_crdnn(x, rng):
    net = JCRDNN(**CRDNN_KW)
    # jitted: Flax's eager init of the conv/scan stack takes ~17 s
    v = jax.jit(net.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(2)}, jnp.asarray(x), train=False)
    return net, {"params": _randomize(v["params"], rng),
                 "batch_stats": _randomize(v["batch_stats"], rng)}


def test_crdnn_matches_jax():
    """Training mode (dropout 0; one LiGRU layer, the 2-layer LiGRU is held
    above), then eval mode.  The train-mode BatchNorms take Flax's
    E[x^2] - E[x]^2 variance over 36 rows of the CNN's mostly positive
    features, whose cancellation turns the frameworks' ~1e-7 rounding of
    the LiGRU's input GEMM into up to 1.3e-5 of the outputs' largest entry
    (seeds 40-42): the outputs are held within 2e-5 of it, every gradient
    of the mean square of the outputs within 5e-5 of the model's largest
    gradient entry (a conv kernel's gradient sums 288 such products; the
    DNN blocks' Linear biases before a training BatchNorm have gradient 0
    up to rounding, and the first conv's biases a small one), every
    BatchNorm's
    running statistics after the step (the LiGRU's at momentum 0.95, the
    DNN blocks' at 0.1) within 1e-5; eval mode (the stored statistics, no
    cancellation) within 1e-5."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    jnet, v = _jax_crdnn(x, rng)

    def loss_fn(params):
        y, upd = jnet.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return (y * y).mean(), (y, upd["batch_stats"])

    (_, (y, stats)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    net = CRDNN(16, **CRDNN_KW)
    net.load_state_dict(bridge.crdnn_state_dict(v["params"],
                                                v["batch_stats"]))
    net.train()
    yt = net(torch.from_numpy(x))
    (yt * yt).mean().backward()
    _close_rel(yt.detach(), y, "crdnn y", 2e-5)
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in net.named_parameters()}
    sd.update(net.named_buffers())
    got = _flat(bridge.to_jax_crdnn(sd)["params"])
    want = _flat(g)
    assert got.keys() == want.keys()
    G = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        _close(got[k], want[k], f"grad {k}", 5e-5 * G)
    got_stats = _flat(bridge.to_jax_crdnn(net.state_dict())["batch_stats"])
    for k, w in _flat(stats).items():
        _close(got_stats[k], w, f"running {k}")
    y_eval = jax.jit(jnet.apply, static_argnames="train")({"params": v["params"], "batch_stats": stats},
                        jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(net.eval()(torch.from_numpy(x)), y_eval, "crdnn eval y")


def test_crdnn_bridge_round_trip():
    """JAX variables -> the port's state_dict -> JAX variables, exactly;
    the state_dict's keys are the module's own."""
    rng = np.random.default_rng(50)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    _, v = _jax_crdnn(x, rng)
    sd = bridge.crdnn_state_dict(v["params"], v["batch_stats"])
    assert set(sd) == set(CRDNN(16, **CRDNN_KW).state_dict())
    back = bridge.to_jax_crdnn(sd)
    for part in ("params", "batch_stats"):
        got, want = _flat(back[part]), _flat(v[part])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_crdnn_other_rnn_classes_wait():
    """Every ``rnn_class`` of the JAX module builds ("lstm" and "gru" no
    longer wait: ``test_torch_separation_rnn.py`` holds them to JAX); a
    class JAX does not have raises."""
    from speechbrain_tpu_torch.nnet.RNN import GRU, LSTM

    for name, cls in (("lstm", LSTM), ("gru", GRU), ("ligru", LiGRU)):
        assert type(CRDNN(16, rnn_class=name, **CRDNN_KW).rnn) is cls
    with pytest.raises(ValueError, match="rnn_class 'qrnn'"):
        CRDNN(16, rnn_class="qrnn")
