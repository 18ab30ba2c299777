"""The WSJ0-2mix separation modules on the port against the JAX package,
on the same numpy inputs and weights (through ``bridge.py``):

- ``ConvTranspose1d`` with asymmetric taps (Flax applies the kernel
  unflipped, PyTorch flipped: the bridge reverses the taps), at the
  decoders' stride 8 x 16 taps and with ``padding``/``output_padding``
  other than 0 (one above the padding, where JAX's output is shorter
  than PyTorch's formula), and ``get_padding_elem_transposed``;
- ``PitWrapper`` (with ``reorder_tensor``), ``cal_si_snr``,
  ``get_si_snr_with_pitwrapper``, ``si_snr_loss`` and ``get_mask``,
  values and gradients, with estimates whose best permutation is not the
  identity;
- ``ReduceLROnPlateau``'s rates, exactly, with a checkpoint in the middle
  loaded both ways;
- every ``dual_path`` and ``conv_tasnet`` class of the slice, outputs and
  the input's and every parameter's gradient;
- the chunking and overlap-add of ``Dual_Path_Model`` (reshapes, no
  scatter) against JAX's gather and scatter-add, bit for bit, and
  ``overlap_and_add``; an odd chunk size raises;
- the bridge's round trips, exact both ways;
- the conformer-intra SepFormer's gradients at Flax's zero-bias init
  (a JAX fault: they explode) and at the port's init (finite).

Tolerances, set from a float64 run of the port at these widths: the
f32 outputs of the SepFormer (both block kinds) and Conv-TasNet lie
within 2.5e-7 of their scale of the float64 ones, JAX's and the port's
alike, and their parameter gradients within 1.3e-6 of each tensor's
scale (or of 5 % of the largest gradient); the tests hold the two f32
runs to 2e-6 (outputs) and 2e-5 (gradients) of the scale, and
``test_separation_classes_match_jax`` checks the float64 run again for
the three models (each f32 run within a quarter of those).  The PIT
SI-SNR of f32 signals lies within 1.2e-6 dB of float64 here; the tests
hold the losses to 2e-5 (dB).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models import conv_tasnet as JC
from speechbrain_tpu.lobes.models import dual_path as JD
from speechbrain_tpu.nnet import losses as jl
from speechbrain_tpu.nnet.CNN import ConvTranspose1d as JConvT
from speechbrain_tpu.nnet.CNN import get_padding_elem_transposed as j_pad_t
from speechbrain_tpu.nnet.loss.si_snr_loss import si_snr_loss as j_si_snr_loss
from speechbrain_tpu.nnet.schedulers import ReduceLROnPlateau as JPlateau
from speechbrain_tpu.processing.signal_processing import (
    overlap_and_add as j_overlap_and_add,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.lobes.models import conv_tasnet as PC
from speechbrain_tpu_torch.lobes.models import dual_path as PD
from speechbrain_tpu_torch.nnet import losses as pl
from speechbrain_tpu_torch.nnet.CNN import ConvTranspose1d
from speechbrain_tpu_torch.nnet.CNN import get_padding_elem_transposed
from speechbrain_tpu_torch.nnet.loss.si_snr_loss import si_snr_loss
from speechbrain_tpu_torch.nnet.schedulers import ReduceLROnPlateau
from speechbrain_tpu_torch.processing.signal_processing import overlap_and_add

from .test_torch_kernels import one_torch_thread  # noqa: F401


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


# ------------------------------------------------------------ ConvTranspose1d

CONVT_CASES = [
    # (kernel, stride, padding, output_padding, bias)
    (16, 8, 0, 0, False),  # the SepFormer decoder's
    (4, 2, 1, 0, True),
    (5, 3, 2, 1, True),
    (5, 2, 1, 2, True),  # output_padding > padding: JAX's shorter output
]


@pytest.mark.parametrize("case", CONVT_CASES)
def test_conv_transpose1d_matches_jax(case):
    """Outputs within 1e-6 and the input's, kernel's and bias's gradients
    within 1e-5 of their scale (a few f32 products a term), with taps
    drawn at random (asymmetric), through ``bridge.conv_transpose1d``."""
    k, stride, pad, out_pad, bias = case
    rng = np.random.default_rng(k + 10 * stride + pad)
    x = rng.standard_normal((2, 7, 3)).astype(np.float32)
    jm = JConvT(out_channels=4, kernel_size=k, stride=stride, padding=pad,
                output_padding=out_pad, bias=bias)
    params = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)[
        "params"], rng)
    R = rng.standard_normal(jax.eval_shape(
        jm.apply, {"params": params}, x).shape).astype(np.float32)

    def jf(params, x):
        out = jm.apply({"params": params}, x)
        return (out * R).sum(), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jf, (0, 1), has_aux=True))(params, jnp.asarray(x))
    pm = ConvTranspose1d(3, 4, k, stride, pad, out_pad, bias)
    pm.load_state_dict(bridge.conv_transpose1d(params["ConvTranspose_0"]))
    xt = _t(x).requires_grad_()
    out = pm(xt)
    assert out.shape == jout.shape
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), atol=1e-6)
    (out * _t(R)).sum().backward()
    want = bridge.conv_transpose1d(jg["ConvTranspose_0"])
    _close_to_scale(xt.grad.numpy(), _np(jgx), 1e-5, "input")
    for name, p in pm.named_parameters():
        _close_to_scale(p.grad.numpy(), want[name].numpy(), 1e-5, name)


def test_padding_elem_transposed_matches_jax():
    for args in [(100, 50, 2, 4, 1, 0), (64, 7, 8, 16, 1, 0),
                 (20, 7, 3, 5, 1, 1), (33, 10, 3, 7, 2, 2)]:
        assert get_padding_elem_transposed(*args) == j_pad_t(*args)


# ------------------------------------------------------------ losses


def _sources(rng, B, T, n):
    """Sources and estimates: each estimate a noisy scaled copy of
    another source (a cyclic shift of the sources), so that the best
    permutation is not the identity."""
    s = rng.standard_normal((B, T, n)).astype(np.float32)
    est = 0.7 * np.roll(s, 1, axis=-1) + 0.3 * rng.standard_normal(
        (B, T, n)).astype(np.float32)
    return s, est.astype(np.float32)


LOSS_CASES = ["cal_si_snr", "pit_si_snr_2", "pit_si_snr_3", "pit_mse_reorder",
              "si_snr_loss_lens", "si_snr_loss_3d"]


@pytest.mark.parametrize("kind", LOSS_CASES)
def test_separation_losses_match_jax(kind):
    """Values within 2e-5 + 2e-6 relative (dB for the SI-SNRs: f32's
    rounding of ~30 dB is 4e-6) and the estimates' and the
    sources' gradients within 2e-5 of their scale;
    the PIT permutations equal, and not the identity."""
    rng = np.random.default_rng(LOSS_CASES.index(kind))
    n = 3 if kind == "pit_si_snr_3" else 2
    src, est = _sources(rng, 3, 64, n)
    R = rng.standard_normal(3).astype(np.float32)
    if kind == "cal_si_snr":  # time first, (T, B, C)
        src, est = src.transpose(1, 0, 2), est.transpose(1, 0, 2)
        R = rng.standard_normal((1, 3, n)).astype(np.float32)
        jf, pf = jl.cal_si_snr, pl.cal_si_snr
    elif kind.startswith("pit_si_snr"):
        jpit, ppit = jl.PitWrapper(jl.cal_si_snr), pl.PitWrapper(pl.cal_si_snr)
        want_perm = _np(jax.jit(jpit)(jnp.asarray(src), jnp.asarray(est))[1])
        got_perm = ppit(_t(src), _t(est))[1].numpy()
        assert (got_perm == want_perm).all() and (
            want_perm != np.arange(n)).any(axis=-1).all()
        jf, pf = jl.get_si_snr_with_pitwrapper, pl.get_si_snr_with_pitwrapper
    elif kind == "pit_mse_reorder":
        jpit = jl.PitWrapper(lambda p, t: (p - t) ** 2)
        ppit = pl.PitWrapper(lambda p, t: (p - t) ** 2)

        def jf(s, e):
            loss, perm = jpit(e, s)
            return loss + jpit.reorder_tensor(e, perm)[:, :, 0].mean(-1)

        def pf(s, e):
            loss, perm = ppit(e, s)
            return loss + ppit.reorder_tensor(e, perm)[:, :, 0].mean(-1)
    elif kind == "si_snr_loss_lens":
        lens = np.array([1.0, 0.55, 0.8], np.float32)
        src, est = src[..., 0], est[..., 0]
        R = np.float32(1.0)

        def jf(s, e):
            return j_si_snr_loss(e, s, jnp.asarray(lens))

        def pf(s, e):
            return si_snr_loss(e, s, _t(lens))
    else:
        src, est = src[..., :1], est[..., :1]

        def jf(s, e):
            return j_si_snr_loss(e, s, reduction="none")

        def pf(s, e):
            return si_snr_loss(e, s, reduction="none")

    def jloss(s, e):
        out = jf(s, e)
        return (out * R).sum(), out

    (_, want), (jgs, jge) = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(jnp.asarray(src), jnp.asarray(est))
    st, et = _t(src).requires_grad_(), _t(est).requires_grad_()
    got = pf(st, et)
    (got * _t(R)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=2e-5,
                               rtol=2e-6)
    _close_to_scale(et.grad.numpy(), _np(jge), 2e-5, "estimates")
    _close_to_scale(st.grad.numpy(), _np(jgs), 2e-5, "sources")


@pytest.mark.parametrize("n", [2, 3])
def test_pit_ties_pick_the_first_permutation(n):
    """Where several permutations score the same (two sources alike, each
    estimate alike), both pick the first of them in
    ``itertools.permutations`` order, JAX's ``argmin``; rows without a
    tie still pick their own best."""
    rng = np.random.default_rng(n)
    src, est = _sources(rng, 3, 32, n)
    src[0, :, 1] = src[0, :, 0]  # row 0: sources 0 and 1 alike
    est[0] = est[0, :, :1]  # and every estimate alike
    jpit, ppit = jl.PitWrapper(jl.cal_si_snr), pl.PitWrapper(pl.cal_si_snr)
    want = _np(jax.jit(jpit)(jnp.asarray(src), jnp.asarray(est))[1])
    got = ppit(_t(src), _t(est))[1].numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == np.arange(n)).all()


@pytest.mark.parametrize("shape", [(6, 3, 2), (6, 2, 3, 2)])
def test_get_mask_matches_jax(shape):
    lengths = np.array([4, 1, 6])[:shape[-2]]
    want = _np(jl.get_mask(jnp.ones(shape), jnp.asarray(lengths)))
    got = pl.get_mask(torch.ones(shape), _t(lengths)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ schedule


def test_reduce_lr_on_plateau_matches_jax_and_resumes(tmp_path):
    """12 epochs of losses that improve, stall (longer and shorter than
    the patience) and tie the anchor, past ``dont_halve_until_epoch``:
    JAX's ``(current, next)`` pairs exactly; at epoch 6 each schedule is
    saved and the other framework's loads it, and both continue as the
    uninterrupted ones."""
    losses = [5.0, 4.0, 4.5, 3.0, 3.2, 3.3, 3.4, 3.0, 3.0, 3.1, 3.2, 3.3]
    kw = dict(lr_min=1e-3, factor=0.5, patience=2, dont_halve_until_epoch=2)
    j, p = JPlateau(**kw), ReduceLROnPlateau(**kw)
    lr_j = lr_p = 0.1
    pairs_j, pairs_p = [], []
    for epoch, loss in enumerate(losses, 1):
        pj, pp = j(lr_j, epoch, loss), p(lr_p, epoch, loss)
        lr_j, lr_p = pj[1], pp[1]
        pairs_j.append(pj)
        pairs_p.append(pp)
        if epoch == 6:
            j._save(tmp_path / "j.json")
            p._save(tmp_path / "p.json")
            j, p = JPlateau(**kw), ReduceLROnPlateau(**kw)
            j._load(tmp_path / "p.json")
            p._load(tmp_path / "j.json")
    assert pairs_p == pairs_j
    assert len({b for _, b in pairs_p}) >= 3  # two halvings
    assert p.losses == j.losses == losses
    assert (p.anchor, p.patience_counter) == (j.anchor, j.patience_counter)


# ------------------------------------------------------------ the classes

SEP = dict(encoder_out_nchannels=16, masknet_chunksize=10,
           masknet_numlayers=2, intra_numlayers=1, inter_numlayers=1,
           intra_nhead=4, inter_nhead=4, intra_dffn=32, inter_dffn=32,
           encoder_kernel_size=8)
DP = dict(in_channels=16, out_channels=16, num_layers=1, K=10, num_spks=2,
          intra_numlayers=1, inter_numlayers=1, intra_nhead=4, inter_nhead=4,
          intra_dffn=32, inter_dffn=32)
TASNET = dict(N=16, B=8, H=16, P=3, X=2, R=2, C=2, L=8)


def _case(name, rng):
    """(JAX module, port module, input, JAX params -> port state_dict)."""
    x = rng.standard_normal((2, 23, 16)).astype(np.float32)
    wav = rng.standard_normal((2, 203)).astype(np.float32)
    sub = bridge._prefixed
    if name == "Encoder":
        return (JD.Encoder(kernel_size=8, out_channels=16),
                PD.Encoder(8, 16), wav,
                lambda p: sub("conv", bridge.conv1d(p["Conv1d_0"]["Conv_0"])))
    if name == "Decoder":
        return (JD.Decoder(kernel_size=8, in_channels=16), PD.Decoder(8, 16),
                x, lambda p: sub("conv", bridge.conv_transpose1d(
                    p["ConvTranspose1d_0"]["ConvTranspose_0"])))
    if name == "SBTransformerBlock":
        return (JD.SBTransformerBlock(num_layers=2, d_model=16, nhead=4,
                                      d_ffn=32),
                PD.SBTransformerBlock(2, 16, 4, 32), x,
                lambda p: sub("mdl", bridge._encoder_stack(
                    p["TransformerEncoder_0"])))
    if name == "SBConformerEncoderBlock":
        return (JD.SBConformerEncoderBlock(num_layers=1, d_model=16, nhead=4,
                                           d_ffn=32, kernel_size=5),
                PD.SBConformerEncoderBlock(1, 16, 4, d_ffn=32, kernel_size=5),
                x, lambda p: sub("mdl", bridge._encoder_stack(p["encoder"])))
    if name.startswith("Dual_Path_Model"):
        kw = dict(DP, **({"intra_block": "conformer",
                          "conformer_kernel_size": 5}
                         if name.endswith("conformer") else {}))
        return (JD.Dual_Path_Model(**kw), PD.Dual_Path_Model(**kw),
                rng.standard_normal((2, 57, 16)).astype(np.float32),
                bridge._dual_path)
    if name.startswith("SepformerWrapper"):
        kw = dict(SEP, **({"intra_block": "conformer",
                           "conformer_kernel_size": 5}
                          if name.endswith("conformer") else {}))
        return (JD.SepformerWrapper(**kw), PD.SepformerWrapper(**kw), wav,
                bridge.sepformer_state_dict)
    if name == "GlobalLayerNorm":
        return (JD.GlobalLayerNorm(), PD.GlobalLayerNorm(16), x,
                bridge._tasnet_norm)
    if name == "CumulativeLayerNorm":
        return (JD.CumulativeLayerNorm(), PD.CumulativeLayerNorm(16), x,
                lambda p: bridge.layer_norm(p["LayerNorm_0"]))
    if name == "tasnet.Encoder":
        return (JC.Encoder(L=8, N=16), PC.Encoder(8, 16), wav,
                lambda p: sub("conv", bridge.conv1d(p["conv1d_U"]["Conv_0"])))
    if name == "tasnet.Decoder":
        mask = rng.uniform(0, 1, (2, 23, 2, 16)).astype(np.float32)
        return (JC.Decoder(L=8, N=16), PC.Decoder(8, 16), (x, mask),
                lambda p: sub("basis", bridge.dense(
                    p["basis_signals"]["Dense_0"])))
    if name in ("ChannelwiseLayerNorm", "tasnet.GlobalLayerNorm"):
        cls = name.split(".")[-1]
        return (getattr(JC, cls)(), getattr(PC, cls)(16), x,
                bridge._tasnet_norm)
    if name == "Chomp1d":
        return JC.Chomp1d(chomp_size=3), PC.Chomp1d(3), x, None
    if name.startswith("DepthwiseSeparableConv"):
        causal = name.endswith("causal")
        return (JC.DepthwiseSeparableConv(out_channels=8, kernel_size=3,
                                          dilation=2, causal=causal),
                PC.DepthwiseSeparableConv(16, 8, 3, dilation=2,
                                          causal=causal), x, bridge._dsconv)
    if name.startswith("TemporalBlock_"):
        norm = name.split("_")[1]
        return (JC.TemporalBlock(out_channels=12, kernel_size=3, dilation=4,
                                 norm_type=norm),
                PC.TemporalBlock(16, 12, 3, dilation=4, norm_type=norm), x,
                bridge._temporal_block)
    if name == "TemporalBlocksSequential":
        return (JC.TemporalBlocksSequential(H=12, P=3, R=2, X=2),
                PC.TemporalBlocksSequential(16, 12, 3, 2, 2), x,
                bridge._temporal_blocks)
    if name.startswith("MaskNet"):
        nonlin = name.split("_")[1]
        kw = dict(N=16, B=8, H=12, P=3, X=2, R=1, C=2, mask_nonlinear=nonlin)
        return JC.MaskNet(**kw), PC.MaskNet(**kw), x, bridge._masknet
    return (JC.ConvTasNet(**TASNET), PC.ConvTasNet(**TASNET),
            rng.standard_normal((2, 256)).astype(np.float32),
            bridge.convtasnet_state_dict)


CLASSES = ["Encoder", "Decoder", "SBTransformerBlock",
           "SBConformerEncoderBlock", "Dual_Path_Model",
           "SepformerWrapper", "SepformerWrapper_conformer",
           "GlobalLayerNorm", "CumulativeLayerNorm", "tasnet.Encoder",
           "tasnet.Decoder", "ChannelwiseLayerNorm", "tasnet.GlobalLayerNorm",
           "Chomp1d", "DepthwiseSeparableConv",
           "DepthwiseSeparableConv_causal", "TemporalBlock_gLN",
           "TemporalBlock_cLN", "TemporalBlock_LN", "TemporalBlocksSequential",
           "MaskNet_relu", "MaskNet_softmax", "ConvTasNet"]


@pytest.mark.parametrize("name", CLASSES)
def test_separation_classes_match_jax(name):
    """Outputs within 2e-6 of their scale, the input's and every
    parameter's gradient within 2e-5 of each tensor's scale, or of 5 % of
    the largest parameter gradient (the attention's key bias has an
    analytic gradient of 0: f32 noise in both), weights drawn at random
    and carried by the bridge; the transformer blocks in eval (dropout 0
    either way).  For the three models the port also runs in float64,
    and both f32 runs lie within a quarter of those tolerances of it."""
    rng = np.random.default_rng(CLASSES.index(name))
    jm, pm, x, to_sd = _case(name, rng)
    xs = x if isinstance(x, tuple) else (x,)
    kw = ({"train": False} if name.startswith(("SB", "Dual_Path", "Sepformer"))
          else {})
    variables = _randomize(jax.eval_shape(functools.partial(jm.init, **kw),
                                          jax.random.PRNGKey(0), *xs), rng)
    params = variables.get("params", {})
    out_shape = jax.eval_shape(functools.partial(jm.apply, **kw),
                               variables, *xs).shape
    R = rng.standard_normal(out_shape).astype(np.float32)

    def jf(params, inputs):
        out = jm.apply({"params": params}, *inputs, **kw)
        return (out * R).sum(), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(params, tuple(map(jnp.asarray, xs)))
    if to_sd is not None:
        pm.load_state_dict(to_sd(jax.device_get(params)))
    pm.eval()
    xt = [_t(a).requires_grad_() for a in xs]
    out = pm(*xt)
    assert out.shape == jout.shape
    _close_to_scale(out.detach().numpy(), _np(jout), 2e-6, "output")
    (out * _t(R)).sum().backward()
    for a, g in zip(xt, jgx):
        _close_to_scale(a.grad.numpy(), _np(g), 2e-5, "input")
    if to_sd is None:
        return
    want = to_sd(jax.device_get(jg))
    G = max(float(v.abs().max()) for v in want.values())
    for pname, p in pm.named_parameters():
        _close_to_scale(p.grad.numpy(), want[pname].numpy(), 2e-5, pname,
                        floor=0.05 * G)
    if name not in ("SepformerWrapper", "SepformerWrapper_conformer",
                    "ConvTasNet"):
        return
    grads32 = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    pm.double().zero_grad()
    out64 = pm(*[_t(a).double() for a in xs])
    (out64 * _t(R).double()).sum().backward()
    for got in (out.detach().numpy(), _np(jout)):
        _close_to_scale(got, out64.detach().numpy(), 5e-7, "float64 output")
    for pname, p in pm.named_parameters():
        for got in (grads32[pname], want[pname].numpy()):
            _close_to_scale(got, p.grad.numpy(), 5e-6, pname, floor=0.05 * G)


# ------------------------------------------------------------ chunking


def _jax_chunk_and_ola(x, K, out):
    """JAX's ``Dual_Path_Model`` chunking (the gather) and overlap-add (the
    scatter-add over the count), as in ``speechbrain_tpu/lobes/models/
    dual_path.py``."""
    B, T, N = x.shape
    P = K // 2
    gap = K - (P + T % K) % K
    xp = jnp.pad(x, ((0, 0), (P, gap + P), (0, 0)))
    Tp = xp.shape[1]
    S = (Tp - K) // P + 1
    idx = (jnp.arange(S) * P)[:, None] + jnp.arange(K)[None, :]
    chunks = xp[:, idx, :]
    flat = idx.reshape(-1)
    ola = jnp.zeros((B, Tp, out.shape[-1]), out.dtype).at[:, flat].add(
        out.reshape(B, S * K, -1))
    counts = jnp.zeros((Tp,)).at[flat].add(1.0)
    ola = ola / jnp.maximum(counts[None, :, None], 1.0)
    return chunks, ola[:, P:P + T]


@pytest.mark.parametrize("K,T", [(10, 57), (10, 60), (250, 3999), (6, 13),
                                 (4, 3)])
def test_chunk_and_overlap_add_match_jax_gather_scatter(K, T):
    """The chunks equal JAX's gather and the overlap-add JAX's scatter-add
    divided by the count, bit for bit (a frame sums at most two values,
    in either order); the overlap-add of the chunks gives the input back,
    and the chunking's gradient equals JAX's."""
    rng = np.random.default_rng(K + T)
    x = rng.standard_normal((2, T, 3)).astype(np.float32)
    chunks = PD._chunk(_t(x), K)
    out = rng.standard_normal(chunks.shape).astype(np.float32)
    jfn = jax.jit(_jax_chunk_and_ola, static_argnums=1)
    jchunks, jola = jfn(jnp.asarray(x), K, jnp.asarray(out))
    np.testing.assert_array_equal(chunks.numpy(), _np(jchunks))
    np.testing.assert_array_equal(PD._overlap_add(_t(out), T).numpy(),
                                  _np(jola))
    np.testing.assert_array_equal(PD._overlap_add(chunks, T).numpy(), x)
    jg = jax.jit(jax.grad(lambda x: (
        _jax_chunk_and_ola(x, K, jnp.asarray(out))[0] * out).sum()))(
            jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (PD._chunk(xt, K) * _t(out)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(jg), atol=1e-6)


def test_odd_chunk_sizes_and_hops_raise():
    """The reshapes need a hop of half the chunk (the yamls' 250 frames,
    Conv-TasNet's L / 2): other shapes raise, where JAX would gather."""
    with pytest.raises(ValueError, match="even"):
        PD.Dual_Path_Model(16, 16, K=9)
    with pytest.raises(ValueError, match="twice the hop"):
        overlap_and_add(torch.ones(2, 4, 5), 2)


@pytest.mark.parametrize("frames,length,step", [(17, 8, 4), (5, 16, 8),
                                                (6, 6, 3), (1, 4, 2)])
def test_overlap_and_add_matches_jax(frames, length, step):
    x = np.random.default_rng(frames).standard_normal(
        (2, 3, frames, length)).astype(np.float32)
    want = _np(j_overlap_and_add(jnp.asarray(x), step))
    got = overlap_and_add(_t(x), step).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ------------------------------------------------------------ bridge


@pytest.mark.parametrize("name", ["sepformer", "sepformer_conformer",
                                  "convtasnet", "convtasnet_cLN",
                                  "conv_transpose"])
def test_separation_bridge_round_trip_is_exact(name):
    """JAX params -> the port's state_dict -> JAX params, and a port
    state_dict -> JAX -> port, equal bit for bit, every entry."""
    rng = np.random.default_rng(len(name))
    if name.startswith("sepformer"):
        kw = dict(SEP, **({"intra_block": "conformer",
                           "conformer_kernel_size": 5}
                          if name.endswith("conformer") else {}))
        jm, pm = JD.SepformerWrapper(**kw), PD.SepformerWrapper(**kw)
        x, kw = np.ones((1, 203), np.float32), {"train": False}
        fwd, back = bridge.sepformer_state_dict, bridge.to_jax_sepformer
    elif name.startswith("convtasnet"):
        norm = "cLN" if name.endswith("cLN") else "gLN"
        jm = JC.ConvTasNet(**TASNET, norm_type=norm)
        pm = PC.ConvTasNet(**TASNET, norm_type=norm)
        x, kw = np.ones((1, 256), np.float32), {}
        fwd = bridge.convtasnet_state_dict

        def back(sd):
            return bridge.to_jax_convtasnet(sd, X=TASNET["X"], norm_type=norm)
    else:
        jm, pm = JConvT(out_channels=4, kernel_size=16, stride=8), \
            ConvTranspose1d(3, 4, 16, 8)
        x, kw = np.ones((1, 5, 3), np.float32), {}
        fwd, back = bridge.conv_transpose1d, bridge.to_jax_conv_transpose1d
    params = _randomize(jax.eval_shape(functools.partial(jm.init, **kw),
                                       jax.random.PRNGKey(0), x)["params"], rng)
    if name == "conv_transpose":
        params = params["ConvTranspose_0"]
    sd = fwd(params)
    pm.load_state_dict(sd)  # every entry, no other
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


def test_conformer_intra_init_gives_finite_gradients():
    """A JAX fault the port repairs in its initialization: at Flax's init
    (every bias zero) the conformer-intra SepFormer keeps a chunk of
    padding alone exactly zero through its intra blocks (no absolute
    position is added), each LayerNorm there multiplies the gradient by
    1/sqrt(eps), and four conformer layers give gradients above 1e30 (the
    yaml's 4 s crops always end in such a chunk: T' 3999).  The
    transformer blocks add the positional encoding and stay finite.
    ``recipes.wsj0mix_separation.build_model`` draws the biases (PyTorch's
    default range): through the bridge, the same JAX model's gradients
    are then below 1e3, and the port's equal them."""
    from speechbrain_tpu_torch.recipes.wsj0mix_separation import build_model

    kw = dict(SEP, masknet_numlayers=1, intra_numlayers=4,
              conformer_kernel_size=3, encoder_kernel_size=16)
    rng = np.random.default_rng(0)
    T = 8 * 38 + 16  # T' 39: the last of 8 chunks of 10 is padding
    s = (0.1 * rng.standard_normal((2, 2, T))).astype(np.float32)
    targets = np.stack([s[0], s[1]], -1)
    worst = {}
    for block in ("transformer", "conformer"):
        jm = JD.SepformerWrapper(intra_block=block, **kw)

        def loss(params):
            est = jm.apply({"params": params}, jnp.asarray(s[0] + s[1]),
                           train=True)
            return jl.get_si_snr_with_pitwrapper(jnp.asarray(targets),
                                                 est).mean()

        grad = jax.jit(jax.value_and_grad(loss))
        flax_params = jm.init(jax.random.PRNGKey(0), jnp.asarray(s[0]),
                              train=False)["params"]
        port = build_model(dict(kw, model="SepformerWrapper",
                                num_spks=2, intra_block=block,
                                masknet_chunksize=10), seed=0)
        port_params = bridge.to_jax_sepformer(port.state_dict())
        for name, params in (("flax", flax_params), ("port", port_params)):
            _, g = grad(params)
            worst[block, name] = max(float(jnp.abs(x).max())
                                     for x in jax.tree_util.tree_leaves(g))
        if block == "conformer":
            xt = _t(s[0] + s[1])
            pl.get_si_snr_with_pitwrapper(_t(targets), port(xt)).mean().backward()
            want = bridge.sepformer_state_dict(jax.device_get(grad(
                port_params)[1]))
            for pname, p in port.named_parameters():
                _close_to_scale(p.grad.numpy(), want[pname].numpy(), 2e-5,
                                pname, floor=0.05 * worst[block, "port"])
    assert worst["conformer", "flax"] > 1e30
    assert worst["transformer", "flax"] < 1e3
    assert worst["conformer", "port"] < 1e3
    assert worst["transformer", "port"] < 1e3
