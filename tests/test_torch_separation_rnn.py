"""The recurrent layers and the separation models built on them, on the
port against the JAX package, on the same seeded numpy inputs and the
bridge's weights:

- ``asr._random_init`` gives every recurrent weight (the LiGRU's
  ``weight_hh``; each ``weight_hh_l{k}[_reverse]`` of a ``torch.nn.GRU``,
  ``LSTM`` or ``RNN``, the conformer-transducer's prediction GRU among
  them) orthogonal columns, as JAX's orthogonal ``u``;
- ``LSTM``, ``GRU`` and ``RNN`` (tanh, relu): outputs, last states, the
  input's, the initial state's and every parameter's gradient; one and
  two layers, one and two directions, with and without ``hx``, a 4-d
  input;
- one clipped Adam step of the LSTM on both sides (optax's
  ``clip_by_global_norm`` + ``adam`` against ``core.clip_by_global_norm_``
  + ``torch.optim.Adam``), parameter by parameter: the LSTM's ``bias_hh``
  is a zero buffer, so the step leaves it zero and moves ``bias_ih`` as
  JAX moves its one bias;
- the CRDNN with ``rnn_class`` "lstm", "gru" and "ligru", each behind a
  projection;
- ``SBRNNBlock``, the "rnn" ``Dual_Path_Model`` and
  ``SepformerWrapper(use_rnn=True)`` (the DPRNN);
- every class of ``resepformer.py`` (``SBTransformerBlock_wnormandskip``,
  ``SegLSTM``, ``MemLSTM`` in each ``mem_type``, the pipeline in both
  modes, ``ResourceEfficientSeparator``, ``SkiMSeparator``,
  ``ResepformerWrapper``, ``RESepformer``);
- the bridge's round trips, exact both ways;
- the recipe's four new dicts (``dprnn.yaml``, ``skim.yaml``,
  ``resepformer.yaml``, ``sepformer-customdataset.yaml``) at toy widths:
  the first batch's loss against the JAX recipe's
  ``Separation.compute_objectives`` on the JAX model with the same
  weights, then one epoch and the test pass through ``run``;
- the DPRNN's chunk of padding (see
  ``test_dprnn_padding_chunk_gradients``).

Tolerances, set from float64 runs of the port at these widths (each f32
run, JAX's and the port's, checked against it again at a quarter of the
tolerance where a test says so): the recurrences' f32 outputs and states
lie within 2e-7 of their scale of float64, their gradients within 1e-6
of each tensor's scale; the tests hold the two f32 runs to 2e-6
(outputs, states) and 2e-5 (gradients).  The models' outputs are held to
2e-6 of their scale and their parameter gradients to 2e-5 of each
tensor's scale, or of 5 % of the largest gradient for the models with
attention (the key projection's bias has an analytic gradient of 0: f32
noise in both).  After the Adam step the parameters agree within 1e-6
absolute (lr 1e-2: the first step moves each entry by ~lr, and f32
rounds the update at ~1e-9).  The recipe's losses (the negative SI-SNR
in dB) within 2e-5.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechbrain_tpu.lobes.models import dual_path as JD
from speechbrain_tpu.lobes.models import resepformer as JR
from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JCRDNN
from speechbrain_tpu.nnet import RNN as JRNN
from speechbrain_tpu.nnet import losses as jl
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import CONFORMER_TRANSDUCER, ConformerTransducer
from speechbrain_tpu_torch.asr import _random_init
from speechbrain_tpu_torch.core import Stage, clip_by_global_norm_
from speechbrain_tpu_torch.lobes.models import dual_path as PD
from speechbrain_tpu_torch.lobes.models import resepformer as PR
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.nnet import RNN as PRNN
from speechbrain_tpu_torch.nnet import losses as pl
from speechbrain_tpu_torch.recipes import wsj0mix_separation as recipe

from .test_torch_kernels import jax_value_and_grad, one_torch_thread  # noqa: F401
from .test_torch_timit import _load_path

SEPARATION = Path(__file__).resolve().parents[1] / "recipes/WSJ0Mix/separation"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(tree, rng, scale=0.3):
    """Normal noise of each leaf's shape (leaves: arrays or the shapes
    ``jax.eval_shape`` gives, so that ``init`` need not compile)."""
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        tree)


def _close_to_scale(got, want, rel, what="", floor=1e-6):
    scale = max(float(np.abs(want).max()), floor)
    dev = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert dev <= rel * scale, f"{what}: {dev} > {rel} x {scale}"


def _flat(xs):
    """Arrays, tensors, or tuples/lists of them, nested -> a flat list."""
    if isinstance(xs, (tuple, list)):
        return [a for x in xs for a in _flat(x)]
    return [xs]


def _check(jfwd, params, pm, inputs, to_sd, rng, out_tol=2e-6,
           grad_tol=2e-5, floor_frac=None, f64=False):
    """``jfwd(params, *inputs)`` (JAX) and ``pm(*inputs)`` (the port, its
    weights ``to_sd(params)``) on the same numpy ``inputs``: every output
    within ``out_tol`` of its scale; the loss sum(out . R) over random R
    differentiated by the inputs (within ``grad_tol`` of each one's
    scale) and by every parameter (within ``grad_tol`` of each tensor's
    scale, or of ``floor_frac`` of the largest gradient); with ``f64`` the
    port also in float64, both f32 runs within a quarter of those
    tolerances of it."""
    shapes = _flat(jax.eval_shape(jfwd, params, *inputs))
    Rs = [rng.standard_normal(s.shape).astype(np.float32) for s in shapes]

    def jf(pa):
        outs = _flat(jfwd(pa[0], *pa[1]))
        return sum((o * R).sum() for o, R in zip(outs, Rs)), outs

    (_, jouts), (jg, jgx) = jax_value_and_grad(jf)(
        (params, tuple(map(jnp.asarray, inputs))))
    pm.load_state_dict(to_sd(jax.device_get(params)))
    pm.eval()
    xt = [_t(a).requires_grad_() for a in inputs]
    outs = _flat(pm(*xt))
    assert len(outs) == len(jouts)
    for o, jo in zip(outs, jouts):
        assert tuple(o.shape) == jo.shape
        _close_to_scale(o.detach().numpy(), _np(jo), out_tol, "output")
    sum((o * _t(R)).sum() for o, R in zip(outs, Rs)).backward()
    for a, g in zip(xt, jgx):
        _close_to_scale(a.grad.numpy(), _np(g), grad_tol, "input")
    want = to_sd(jax.device_get(jg))
    G = max((float(v.abs().max()) for v in want.values()), default=0.0)
    floor = floor_frac * G if floor_frac else 1e-6
    for name, p in pm.named_parameters():
        _close_to_scale(p.grad.numpy(), want[name].numpy(), grad_tol, name,
                        floor=floor)
    if not f64:
        return
    grads32 = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    pm.double().zero_grad()
    xs64 = [_t(a).double().requires_grad_() for a in inputs]
    outs64 = _flat(pm(*xs64))
    sum((o * _t(R).double()).sum() for o, R in zip(outs64, Rs)).backward()
    for o, jo, o64 in zip(outs, jouts, outs64):
        for got in (o.detach().numpy(), _np(jo)):
            _close_to_scale(got, o64.detach().numpy(), out_tol / 4,
                            "float64 output")
    for a, g, a64 in zip(xt, jgx, xs64):
        for got in (a.grad.numpy(), _np(g)):
            _close_to_scale(got, a64.grad.numpy(), grad_tol / 4,
                            "float64 input")
    for name, p in pm.named_parameters():
        for got in (grads32[name], want[name].numpy()):
            _close_to_scale(got, p.grad.numpy(), grad_tol / 4, name,
                            floor=floor)


# ------------------------------------------------------------ the init repair


@pytest.mark.parametrize("kind", ["GRU", "LSTM", "RNN", "port_LSTM",
                                  "conformer_transducer"])
def test_random_init_makes_recurrent_weights_orthogonal(kind):
    """Every ``weight_hh`` and ``weight_hh_l{k}[_reverse]`` that
    ``asr._random_init`` draws has orthonormal columns (W^T W = I within
    1e-5), as JAX's orthogonal ``u`` (H, G H) has orthonormal rows; the
    recurrent biases stay zero.  Lecun-normal draws of a (G H, H) matrix
    are far from it (max |W^T W - I| ~ 4 at H 16)."""
    if kind == "conformer_transducer":
        cfg = dict(CONFORMER_TRANSDUCER, n_mels=40, frontend_channels=(8, 8),
                   input_size=80, d_model=32, nhead=2, num_encoder_layers=1,
                   d_ffn=64, kernel_size=7, vocab_size=32, dec_emb_dim=16,
                   dec_neurons=24, joint_dim=20, augmentation=None)
        module = ConformerTransducer(cfg, device="cpu")  # the prediction GRU
    else:
        cls = (getattr(PRNN, kind[5:]) if kind.startswith("port_")
               else getattr(torch.nn, kind))
        module = cls(12, 16, num_layers=2, bidirectional=True)
        _random_init(module, torch.Generator().manual_seed(0))
    names = [n for n, _ in module.named_parameters() if "weight_hh" in n]
    assert names
    for name, w in module.named_parameters():
        if "weight_hh" in name:
            H = w.shape[1]
            gram = w.detach().double().T @ w.detach().double()
            dev = float((gram - torch.eye(H, dtype=torch.float64)).abs().max())
            assert dev <= 1e-5, (name, dev)
        elif "bias_hh" in name:
            assert not w.detach().any(), name


# ------------------------------------------------------------ LSTM, GRU, RNN

B, T, C, H = 2, 7, 5, 4
RNN_KINDS = ["LSTM", "GRU", "RNN_tanh", "RNN_relu"]
RNN_CASES = [
    # (layers, bidirectional, with hx, 4-d input)
    (1, False, False, False),
    (1, True, True, False),
    (2, False, True, False),
    (2, True, False, False),
    (2, True, True, True),
]


def _recurrences(kind, layers, bidir, input_size):
    kw = dict(num_layers=layers, bidirectional=bidir)
    name, _, act = kind.partition("_")
    if act:
        kw["nonlinearity"] = act
    jm = getattr(JRNN, name)(hidden_size=H, **kw)
    pm = getattr(PRNN, name)(input_size, H, **kw)
    to_sd = {"LSTM": bridge.lstm, "GRU": bridge.gru, "RNN": bridge.rnn}[name]
    return jm, pm, to_sd


@pytest.mark.parametrize("case", RNN_CASES,
                         ids=lambda c: "L{}-{}-{}-{}".format(
                             c[0], "bi" if c[1] else "uni",
                             "hx" if c[2] else "zero", "4d" if c[3] else "3d"))
@pytest.mark.parametrize("kind", RNN_KINDS)
def test_recurrence_matches_jax(kind, case):
    """Outputs and last states (the LSTM's h and c), the input's, the
    initial state's and every parameter's gradient (the GRU's recurrent
    bias too); float64 checks the tolerances again."""
    layers, bidir, with_hx, four_d = case
    rng = np.random.default_rng(RNN_KINDS.index(kind) * 10
                                + RNN_CASES.index(case))
    x = rng.standard_normal((B, T, C) if not four_d else (B, T, 2, 3))
    x = x.astype(np.float32)
    jm, pm, to_sd = _recurrences(kind, layers, bidir, C if not four_d else 6)
    D = 2 if bidir else 1
    n_state = 2 if kind == "LSTM" else 1
    hx = [rng.standard_normal((layers * D, B, H)).astype(np.float32)
          for _ in range(n_state)]
    inputs = [x] + (hx if with_hx else [])

    def pack(hx):
        if not hx:
            return None
        return tuple(hx) if n_state == 2 else hx[0]

    def jfwd(params, x, *hx):
        return jm.apply({"params": params}, x, hx=pack(hx), train=False)

    params = _randomize(jax.eval_shape(
        functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
        x)["params"], rng)
    _check(jfwd, params, PortCall(pm, lambda m, x, *hx: m(x, hx=pack(hx))),
           inputs, to_sd, rng, f64=True)


class PortCall(torch.nn.Module):
    """A port module called through ``call(module, *inputs)``: its
    state_dict and parameters are the module's own."""

    def __init__(self, module, call):
        super().__init__()
        self.m = module
        self.call = call

    def forward(self, *inputs):
        return self.call(self.m, *inputs)

    def state_dict(self, *args, **kwargs):
        return self.m.state_dict(*args, **kwargs)

    def load_state_dict(self, sd, strict=True):
        return self.m.load_state_dict(sd, strict)

    def named_parameters(self, *args, **kwargs):
        return self.m.named_parameters(*args, **kwargs)


def test_lstm_and_rnn_have_no_recurrent_bias_parameter():
    """The LSTM's and RNN's ``bias_hh`` are zero buffers, in the state_dict
    but not among the parameters; the GRU's is a parameter (JAX's
    ``u_bias``)."""
    for cls, trained in ((PRNN.LSTM, False), (PRNN.RNN, False),
                         (PRNN.GRU, True)):
        m = cls(3, 4, num_layers=2, bidirectional=True)
        params = {n for n, _ in m.named_parameters()}
        hh = [k for k in m.state_dict() if "bias_hh" in k]
        assert len(hh) == 4
        assert all((k in params) == trained for k in hh), cls
        assert trained or all(not m.state_dict()[k].any() for k in hh)


def test_lstm_adam_step_matches_jax():
    """One step of clip-by-global-norm 5 (the yamls' ``max_grad_norm``;
    the gradient's norm here ~30) and Adam at lr 1e-2 on both sides, from
    the same weights and inputs: every parameter after the step within
    1e-6 of JAX's through the bridge, ``bias_hh`` still exactly zero, and
    the effective bias ``bias_ih + bias_hh`` equal to JAX's one bias.  A
    trainable ``bias_hh`` would take ``bias_ih``'s gradient: the clip
    would count it twice and Adam would move the sum by 2 lr."""
    rng = np.random.default_rng(7)
    jm = JRNN.LSTM(hidden_size=H, num_layers=2, bidirectional=True)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    R = rng.standard_normal((B, T, 2 * H)).astype(np.float32) * 20
    params = _randomize(jax.eval_shape(
        functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
        x)["params"], rng)
    params = jax.tree_util.tree_map(jnp.asarray, params)

    def loss(p):
        return (jm.apply({"params": p}, jnp.asarray(x), train=False)[0]
                * R).sum()

    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-2))
    (_, _), grads = jax_value_and_grad(lambda p: (loss(p), None))(params)
    def step(p, g):  # jitted: eagerly optax compiles op by op
        return (optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]),
                optax.global_norm(g))

    after, gnorm = jax.device_get(jax.jit(step)(params, grads))
    gnorm = float(gnorm)
    pm = PRNN.LSTM(C, H, num_layers=2, bidirectional=True)
    pm.load_state_dict(bridge.lstm(jax.device_get(params)))
    torch_opt = torch.optim.Adam(pm.parameters(), lr=1e-2, betas=(0.9, 0.999),
                                 eps=1e-8)
    (pm(_t(x))[0] * _t(R)).sum().backward()
    grads_t = [p.grad for p in pm.parameters()]
    norm = float(clip_by_global_norm_(grads_t, 5.0))
    assert gnorm > 5.0 and abs(norm - gnorm) <= 1e-5 * gnorm
    torch_opt.step()
    sd = pm.state_dict()
    hh = [k for k in sd if "bias_hh" in k]
    assert len(hh) == 4 and all(not sd[k].any() for k in hh)
    want = bridge.lstm(after)
    for k in sd:
        eff = sd[k]
        if "bias_ih" in k:  # the effective bias
            eff = eff + sd[k.replace("_ih_", "_hh_")]
        np.testing.assert_allclose(eff.numpy(), want[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    back = bridge.to_jax_lstm(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(after):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, leaf, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn"])
def test_recurrence_bridge_round_trip_is_exact(kind):
    """JAX params -> the port -> JAX, and port -> JAX -> port, bit for bit
    (the zero ``bias_hh`` of the LSTM and RNN has no JAX entry)."""
    rng = np.random.default_rng(len(kind))
    name = kind.upper()
    jm = getattr(JRNN, name)(hidden_size=H, num_layers=2, bidirectional=True)
    pm = getattr(PRNN, name)(C, H, num_layers=2, bidirectional=True)
    fwd = getattr(bridge, kind)
    back = getattr(bridge, f"to_jax_{kind}")
    x = np.ones((1, 3, C), np.float32)
    _round_trip(jm, pm, x, {"train": False}, fwd, back, rng)


def _round_trip(jm, pm, x, kw, fwd, back, rng):
    params = _randomize(jax.eval_shape(functools.partial(jm.init, **kw),
                                       jax.random.PRNGKey(0), x)["params"],
                        rng)
    pm.load_state_dict(fwd(params))  # every entry, no other
    again = back(pm.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], _np(leaf))
    with torch.no_grad():
        for p in pm.parameters():
            p.copy_(torch.randn(p.shape))
    sd2 = pm.state_dict()
    sd3 = fwd(back(sd2))
    assert sd3.keys() == sd2.keys()
    assert all(torch.equal(sd2[k], sd3[k]) for k in sd2)


# ------------------------------------------------------------ CRDNN


def _crdnn_kw(rnn_class):
    return dict(cnn_channels=(4, 6), rnn_neurons=5, dnn_neurons=7,
                rnn_layers=2, dnn_blocks=1, dropout=0.0, rnn_class=rnn_class,
                projection_dim=6)


@pytest.mark.parametrize("rnn_class", ["lstm", "gru", "ligru"])
def test_crdnn_rnn_classes_match_jax(rnn_class):
    """The CRDNN with each ``rnn_class`` (two bidirectional layers) behind
    a ``projection_dim`` Linear, in eval mode (the stored BatchNorm
    statistics): outputs within 1e-5 of their scale, every gradient of
    the mean square of the outputs within 5e-5 of the model's largest
    gradient entry (``test_torch_crdnn.py``'s bounds), and the bridge
    both ways exact."""
    rng = np.random.default_rng(["lstm", "gru", "ligru"].index(rnn_class))
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    jnet = JCRDNN(**_crdnn_kw(rnn_class))
    v = jax.eval_shape(functools.partial(jnet.init, train=False),
                       {"params": jax.random.PRNGKey(2)}, jnp.asarray(x))
    v = {"params": _randomize(v["params"], rng),
         "batch_stats": jax.tree_util.tree_map(
             np.abs, _randomize(v["batch_stats"], rng, 1.0))}
    assert ("rnn" in v["batch_stats"]) == (rnn_class == "ligru")
    assert "Dense_0" in v["params"]

    def loss_fn(params):
        y = jnet.apply({"params": params, "batch_stats": v["batch_stats"]},
                       jnp.asarray(x), train=False)
        return (y * y).mean(), y

    (_, y), g = jax_value_and_grad(loss_fn)(v["params"])
    net = CRDNN(16, **_crdnn_kw(rnn_class)).eval()
    sd = bridge.crdnn_state_dict(v["params"], v["batch_stats"])
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    yt = net(_t(x))
    (yt * yt).mean().backward()
    _close_to_scale(yt.detach().numpy(), _np(y), 1e-5, "crdnn y")
    grads = {k: p.grad for k, p in net.named_parameters()}
    grads.update((k, torch.zeros_like(b)) for k, b in net.named_buffers())
    got = dict(jax.tree_util.tree_leaves_with_path(
        bridge.to_jax_crdnn(grads)["params"]))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(g))
    assert len(got) == len(want)
    G = max(float(np.abs(w).max()) for _, w in want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, atol=5e-5 * G, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    back = bridge.to_jax_crdnn(net.state_dict())
    for part in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(v[part])
        b = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(a) == len(b)
        for path, leaf in a:
            np.testing.assert_array_equal(b[path], _np(leaf))


# ------------------------------------------------------------ separation


DP = dict(in_channels=16, out_channels=16, num_layers=2, K=10, num_spks=2,
          use_rnn=True)
DPRNN = dict(encoder_out_nchannels=16, masknet_chunksize=10,
             masknet_numlayers=2, encoder_kernel_size=8, use_rnn=True)
SKIM = dict(encoder_out_nchannels=16, unit=8, segment_size=10, num_blocks=3,
            encoder_kernel_size=8, causal=False)
PIPE = dict(input_size=16, hidden_size=8, output_size=12, num_blocks=3,
            segment_size=10, nhead=4, d_ffn=32)
RESEP = dict(encoder_out_nchannels=16, chunk_size=10, num_blocks=2,
             intra_numlayers=1, intra_nhead=4, intra_dffn=32,
             encoder_kernel_size=8)


def _sep_case(name, rng):
    """(JAX module, port module, inputs, JAX params -> port state_dict,
    the JAX call's keywords, float64 check, gradient floor)."""
    x = rng.standard_normal((2, 23, 16)).astype(np.float32)
    wav = rng.standard_normal((1, 203)).astype(np.float32)
    sub = bridge._prefixed
    attention = 0.05
    if name == "SBRNNBlock":
        return (JD.SBRNNBlock(hidden_channels=8), PD.SBRNNBlock(16, 8), [x],
                lambda p: sub("mdl", bridge.lstm(p["LSTM_0"])), False, None)
    if name == "Dual_Path_Model_rnn":
        return (JD.Dual_Path_Model(**DP), PD.Dual_Path_Model(**DP),
                [rng.standard_normal((2, 57, 16)).astype(np.float32)],
                bridge._dual_path, False, None)
    if name == "SepformerWrapper_rnn":
        return (JD.SepformerWrapper(**DPRNN), PD.SepformerWrapper(**DPRNN),
                [wav], bridge.sepformer_state_dict, True, None)
    if name.startswith("wnormandskip"):
        norm, skip = name.endswith(("norm_skip", "norm")), "skip" in name
        kw = dict(num_layers=1, d_model=16, nhead=4, d_ffn=32)
        return (JR.SBTransformerBlock_wnormandskip(use_norm=norm,
                                                   use_skip=skip, **kw),
                PR.SBTransformerBlock_wnormandskip(use_norm=norm,
                                                   use_skip=skip, **kw),
                [x], bridge._resep_block, False, attention)
    if name.startswith("SegLSTM"):
        bidir = "bi" in name
        d = 2 if bidir else 1
        inputs = [x[:, :10]]
        if "hc" in name:
            inputs += [rng.standard_normal((d, 2, 8)).astype(np.float32)
                       for _ in range(2)]
        return (JR.SegLSTM(input_size=16, hidden_size=8, bidirectional=bidir),
                PR.SegLSTM(16, 8, bidirectional=bidir), inputs,
                bridge._resep_block, False, None)
    if name.startswith("MemLSTM"):
        _, mem_type, direction = name.split("_")
        bidir = direction == "bi"
        d = 2 if bidir else 1
        hc = [rng.standard_normal((d, 2 * 5, 8)).astype(np.float32)
              for _ in range(2)]
        return (JR.MemLSTM(hidden_size=8, bidirectional=bidir,
                           mem_type=mem_type),
                PR.MemLSTM(8, bidirectional=bidir, mem_type=mem_type), hc,
                bridge._resep_block, False, None)
    if name.startswith("Pipeline"):
        mem_type = name.split("_")[1]
        kw = dict(PIPE, mem_type=mem_type)
        return (JR.ResourceEfficientSeparationPipeline(**kw),
                PR.ResourceEfficientSeparationPipeline(**kw),
                [rng.standard_normal((2, 43, 16)).astype(np.float32)],
                bridge._pipeline, False,
                attention if mem_type == "av" else None)
    if name == "ResourceEfficientSeparator":
        kw = dict(input_dim=16, unit=8, segment_size=10, layer=2,
                  causal=False)
        return (JR.ResourceEfficientSeparator(**kw),
                PR.ResourceEfficientSeparator(**kw),
                [rng.standard_normal((2, 43, 16)).astype(np.float32)],
                lambda p: sub("pipeline", bridge._pipeline(p["pipeline"])),
                False, None)
    if name == "SkiMSeparator":
        return (JR.SkiMSeparator(**SKIM), PR.SkiMSeparator(**SKIM), [wav],
                bridge.skim_state_dict, True, None)
    if name == "ResepformerWrapper":
        kw = dict(SKIM, mem_type="av", num_blocks=2)
        return (JR.ResepformerWrapper(**kw), PR.ResepformerWrapper(**kw),
                [wav], bridge.skim_state_dict, True, attention)
    return (JR.RESepformer(**RESEP), PR.RESepformer(**RESEP), [wav],
            bridge.resepformer_state_dict, True, attention)


SEP_CLASSES = ["SBRNNBlock", "Dual_Path_Model_rnn", "SepformerWrapper_rnn",
               "wnormandskip_norm_skip", "wnormandskip_skip",
               "wnormandskip_norm", "SegLSTM_uni", "SegLSTM_bi_hc",
               "MemLSTM_hc_bi", "MemLSTM_hc_uni", "MemLSTM_h_bi",
               "MemLSTM_c_uni", "MemLSTM_id_bi", "Pipeline_hc", "Pipeline_h",
               "Pipeline_id", "Pipeline_av", "ResourceEfficientSeparator",
               "SkiMSeparator", "ResepformerWrapper", "RESepformer"]


@pytest.mark.parametrize("name", SEP_CLASSES)
def test_separation_rnn_classes_match_jax(name):
    """Outputs (a SegLSTM's states and a MemLSTM's (h, c) too) within 2e-6
    of their scale, the inputs' and every parameter's gradient within 2e-5
    of each tensor's scale (or of 5 % of the largest gradient where there
    is attention), weights drawn at random and carried by the bridge; the
    four models also in float64."""
    rng = np.random.default_rng(SEP_CLASSES.index(name))
    jm, pm, inputs, to_sd, f64, floor_frac = _sep_case(name, rng)
    if name.startswith("MemLSTM"):  # (h, c) and the segment count
        def jargs(h, c):
            return (h, c), 5

        pm = PortCall(pm, lambda m, h, c: m((h, c), 5))
    elif name.startswith("SegLSTM"):  # x and the optional (h, c)
        def jargs(x, *hc):
            return x, tuple(hc) or None

        pm = PortCall(pm, lambda m, x, *hc: m(x, tuple(hc) or None))
    else:
        def jargs(*xs):
            return xs

    def jfwd(params, *xs):
        return jm.apply({"params": params}, *jargs(*xs), train=False)

    variables = jax.eval_shape(
        lambda key, *xs: jm.init(key, *jargs(*xs), train=False),
        jax.random.PRNGKey(0), *inputs)
    params = _randomize(variables.get("params", {}), rng)
    if name == "MemLSTM_id_bi":
        assert not params and not list(pm.named_parameters())
    _check(jfwd, params, pm, inputs, to_sd, rng, floor_frac=floor_frac,
           f64=f64)


@pytest.mark.parametrize("name", ["dprnn", "skim", "resepformer_av",
                                  "resepformer_module"])
def test_separation_rnn_bridge_round_trip_is_exact(name):
    """JAX params -> the port's state_dict -> JAX params, and a port
    state_dict -> JAX -> port, bit for bit, every entry."""
    rng = np.random.default_rng(len(name))
    wav = np.ones((1, 203), np.float32)
    if name == "dprnn":
        jm, pm = JD.SepformerWrapper(**DPRNN), PD.SepformerWrapper(**DPRNN)
        fwd, back = bridge.sepformer_state_dict, bridge.to_jax_sepformer
    elif name.startswith("resepformer_module"):
        jm, pm = JR.RESepformer(**RESEP), PR.RESepformer(**RESEP)
        fwd, back = bridge.resepformer_state_dict, bridge.to_jax_resepformer
    else:
        kw = (dict(SKIM, mem_type="av", num_blocks=2) if name.endswith("av")
              else SKIM)
        jm, pm = JR.SkiMSeparator(**kw), PR.SkiMSeparator(**kw)
        fwd, back = bridge.skim_state_dict, bridge.to_jax_skim
    _round_trip(jm, pm, wav, {"train": False}, fwd, back, rng)


def test_resepformer_wrapper_is_skim_and_ignores_unit_in_av_mode():
    """``ResepformerWrapper`` is ``SkiMSeparator`` in both packages; in the
    "av" mode of ``resepformer.yaml`` the pipeline has 2 transformer
    segment blocks and 1 memory block and no LSTM, whatever ``unit``."""
    assert PR.ResepformerWrapper is PR.SkiMSeparator
    assert JR.ResepformerWrapper is JR.SkiMSeparator
    hp = recipe.HPARAMS_RESEPFORMER
    a = recipe.build_model(dict(hp, unit=8, encoder_out_nchannels=16))
    b = recipe.build_model(dict(hp, unit=512, encoder_out_nchannels=16))
    assert a.state_dict().keys() == b.state_dict().keys()
    pipe = a.masknet.pipeline
    assert (len(pipe.seg), len(pipe.mem)) == (2, 1)
    assert not any(isinstance(m, torch.nn.LSTM) for m in a.modules())
    skim = recipe.build_model(dict(recipe.HPARAMS_SKIM,
                                   encoder_out_nchannels=16, unit=8))
    lstms = [m for m in skim.modules() if isinstance(m, torch.nn.LSTM)]
    assert len(lstms) == 4 + 3 * 2 and all(m.bidirectional for m in lstms)


# ------------------------------------------------------------ padding chunk


def test_dprnn_padding_chunk_gradients():
    """A fault of the JAX package's init that the port keeps out:
    ``dprnn.yaml``'s crops (T' 3999 at 4 s) end in a chunk of padding
    alone, which the bias-free 1x1 convolution leaves zero.  At zero LSTM
    biases (Flax's init) layer 0's intra BiLSTM outputs exact zeros there
    and its LayerNorm multiplies their gradient by 1/sqrt(eps) (1e3), all
    of it onto that LSTM's biases (~180 at the yaml's widths, where the
    other gradients' largest entries have a median of 0.27).  Here at a
    toy width (T' 39: the last of 8 chunks of 10 is padding), on the
    weights of ``recipes.wsj0mix_separation.build_model``: with the LSTM
    biases zeroed, JAX's gradient on them is over 20 times what it is at
    the port's init, which draws them (PyTorch's range), and the port's
    intra outputs on that chunk are exact zeros; at the port's init they
    are not, and the port's gradients equal JAX's on the same weights."""
    kw = dict(DPRNN, encoder_kernel_size=16)
    rng = np.random.default_rng(0)
    Tw = 8 * 38 + 16  # T' 39
    s = (0.1 * rng.standard_normal((2, 2, Tw))).astype(np.float32)
    targets = np.stack([s[0], s[1]], -1)
    port = recipe.build_model(dict(recipe.HPARAMS_DPRNN, **kw), seed=0)
    drawn = {k: v.clone() for k, v in port.state_dict().items()}
    zero = {k: (torch.zeros_like(v) if ".rnns." in k and "bias" in k else v)
            for k, v in drawn.items()}
    jm = JD.SepformerWrapper(**kw)

    def loss(params):
        est = jm.apply({"params": params}, jnp.asarray(s[0] + s[1]),
                       train=True)
        return jl.get_si_snr_with_pitwrapper(jnp.asarray(targets), est).mean()

    grad = jax_value_and_grad(lambda p: (loss(p), None))
    biases = {}
    for name, sd in (("zero", zero), ("drawn", drawn)):
        (_, _), g = grad(bridge.to_jax_sepformer(sd))
        lstm = g["Dual_Path_Model_0"]["intra_0"]["LSTM_0"]
        biases[name] = max(float(jnp.abs(lstm[n]["bias"]).max())
                           for n in ("l0_wx", "l0_bwd_wx"))
        port.load_state_dict(sd)
        port.zero_grad()
        seen = []
        hook = port.masknet.intra[0].register_forward_hook(
            lambda m, i, o: seen.append(o.detach()))
        pl.get_si_snr_with_pitwrapper(_t(targets),
                                      port(_t(s[0] + s[1]))).mean().backward()
        hook.remove()
        padding = seen[0].reshape(2, -1, 10, 16)[:, -1]
        assert bool(padding.any()) == (name == "drawn")
        want = bridge.sepformer_state_dict(jax.device_get(g))
        G = max(float(v.abs().max()) for v in want.values())
        for pname, p in port.named_parameters():
            _close_to_scale(p.grad.numpy(), want[pname].numpy(), 2e-5, pname,
                            floor=0.05 * G)
    assert biases["zero"] > 20 * biases["drawn"], biases


# ------------------------------------------------------------ the recipe

TOY = {
    "dprnn": (recipe.HPARAMS_DPRNN, dict(
        encoder_out_nchannels=16, masknet_chunksize=10, masknet_numlayers=2)),
    "skim": (recipe.HPARAMS_SKIM, dict(
        encoder_out_nchannels=16, unit=8, segment_size=10, num_blocks=2)),
    "resepformer": (recipe.HPARAMS_RESEPFORMER, dict(
        encoder_out_nchannels=16, segment_size=10)),
    "sepformer-customdataset": (recipe.HPARAMS_SEPFORMER_CUSTOMDATASET, dict(
        encoder_out_nchannels=16, masknet_chunksize=10, masknet_numlayers=1,
        intra_numlayers=1, inter_numlayers=1, intra_nhead=4, inter_nhead=4,
        intra_dffn=32, inter_dffn=32)),
}
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}


def _jax_model(name, hp):
    """The JAX model the yaml builds, at ``hp``'s widths, and the bridge
    from the port's state_dict."""
    if name in ("dprnn", "sepformer-customdataset"):
        keys = ("encoder_kernel_size", "encoder_out_nchannels",
                "masknet_chunksize", "masknet_numlayers", "intra_numlayers",
                "inter_numlayers", "intra_nhead", "inter_nhead", "intra_dffn",
                "inter_dffn", "use_rnn")
        return (JD.SepformerWrapper(masknet_numspks=hp["num_spks"],
                                    **{k: hp[k] for k in keys}),
                bridge.to_jax_sepformer)
    keys = ("encoder_kernel_size", "encoder_out_nchannels", "causal", "unit",
            "segment_size", "num_blocks", "mem_type")
    cls = JR.SkiMSeparator if name == "skim" else JR.ResepformerWrapper
    return (cls(num_spks=hp["num_spks"], **{k: hp[k] for k in keys}),
            bridge.to_jax_skim)


@pytest.mark.parametrize("name", list(TOY))
def test_new_yamls_match_jax_and_train_through_run(name, tmp_path):
    """Each new dict at toy widths: the first training batch's loss (the
    capped PIT negative SI-SNR, a dummy row weighted 0) on the port
    against the JAX recipe's ``Separation.compute_objectives`` on the JAX
    model with the same weights, within 2e-5 dB; then one epoch and the
    test pass through ``run``, every loss finite."""
    hparams, toy = TOY[name]
    data = str(tmp_path / "wsj")
    recipe.write_synthetic_wsj0mix(data, {"tr": 3, "cv": 1, "tt": 1},
                                   (0.2, 0.3), seed=6)
    overrides = dict(toy, training_signal_len=2400, number_of_epochs=1,
                     batch_size=2)
    parts = recipe.build(data, str(tmp_path / "first"), overrides, RUN_OPTS,
                         hparams=hparams)
    brain, hp = parts["brain"], parts["hparams"]
    batch = brain.prepare_batch(next(iter(parts["train_loader"])))
    batch["batch_mask"] = torch.tensor([1.0, 0.0])  # the second row a dummy
    with torch.no_grad():
        got = float(brain._loss(batch, Stage.TRAIN))
    jm, to_jax = _jax_model(name, hp)
    params = to_jax(brain.modules.state_dict(), "masknet.")
    train = _load_path("wsj_train_rnn", SEPARATION / "train.py")
    stub = type("Stub", (), {"hparams": type("H", (), {
        "loss_upper_lim": hp["loss_upper_lim"]})})()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    est = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(
        params, jbatch["mix_sig"])
    want = float(train.Separation.compute_objectives(stub, est, jbatch,
                                                     Stage.TRAIN))
    assert abs(got - want) <= 2e-5, (got, want)
    out = recipe.run(data, str(tmp_path / "out"), overrides, RUN_OPTS,
                     hparams=hparams)
    assert np.isfinite(out.avg_train_loss)
    assert np.isfinite(out.stage_stats["VALID"]["si-snr"])
    assert np.isfinite(out.stage_stats["TEST"]["si-snr"])
