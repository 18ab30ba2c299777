"""The spectral-mask enhancement slice on the port against the JAX
package, on the same numpy inputs and weights (through ``bridge.py``):

- ``ISTFT`` (the real inverse DFT, the overlap-add as shifted reshapes or
  ``F.fold``, the squared-window normalisation, ``center``, ``sig_length``,
  ``normalized_stft``, ``n_fft`` None and the 5-d multichannel input),
  outputs and the input's gradient, and the STFT -> ISTFT round trip;
- ``resynthesize`` (the noisy phase through ``atan2``, the peak
  normalisation with and without a peak above 1), outputs and both
  inputs' gradients;
- ``CNNTransformerSE`` (causal or not, with and without ``lengths``, with
  and without ``in_proj``, each output activation) and
  ``SpectralMaskWrapper``, outputs and the input's and every parameter's
  gradient; the bridge's round trips, exact both ways;
- the WHAM!/WHAMR! recipe: ``prepare_wham`` against JAX's (``wav8k`` and
  ``wav16k``), the dynamic mixing keyed by (seed, epoch, mixture id)
  (JAX's shared generator shown beside it), the validation set not mixed,
  an epoch of the CNN-Transformer yaml with dynamic mixing resumed bit
  for bit, and two SepFormer yamls through ``run``.

Tolerances, from float64 runs of the port at these widths: the ISTFT's
f32 output lies within 3e-7 of its scale from float64 (JAX's and the
port's differ in the FFT's and the overlap-add's order of sums), so the
two are held to 2e-6 of the scale and the gradients to 2e-6; the models
as the separation models are held (``test_torch_separation.py``): 2e-6
(outputs) and 2e-5 (gradients) of each tensor's scale, or of 5 % of the
largest parameter gradient.  The spectral-mask wrapper squares the
masked magnitude and divides by the peak: the port's own f32 gradients
of ``in_proj`` and the first attention's projections lie up to 7.5e-5 of
their scale from its float64 ones (257 bins of squared magnitudes sum
into each), so its outputs are held to 1e-5, its gradients to 2e-4, and
both f32 runs to 2e-4 of the port's float64 run.
"""

import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models.transformer import TransformerSE as JSE
from speechbrain_tpu.processing import features as jf
from speechbrain_tpu.processing.signal_processing import (
    resynthesize as j_resynthesize,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.lobes.models.transformer import TransformerSE as PSE
from speechbrain_tpu_torch.processing import features as pf
from speechbrain_tpu_torch.processing.signal_processing import resynthesize

from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_separation import _close_to_scale, _np, _randomize, _t

# (sample_rate, win ms, hop ms, n_fft, center, normalized, channels,
# sig_length): 512 at hop 128 (the yamls'), hops that do not divide the
# frame (F.fold), n_fft None, normalized, multichannel, a cut
ISTFT_CASES = [
    (8000, 32.0, 16.0, 512, True, False, 0, None),
    (16000, 25.0, 10.0, 400, True, False, 0, None),
    (8000, 32.0, 16.0, None, True, True, 0, 900),
    (8000, 20.0, 8.0, 256, False, False, 2, None),
    (16000, 32.0, 16.0, 512, True, False, 3, 1500),
]


@pytest.mark.parametrize("case", ISTFT_CASES)
def test_istft_matches_jax(case):
    """Outputs and the input's gradient within 2e-6 of their scale."""
    sr, win, hop, n_fft, center, normalized, channels, sig_length = case
    rng = np.random.default_rng(ISTFT_CASES.index(case))
    freq = (n_fft or 2 * 128) // 2 + 1
    shape = (2, 13, freq, 2) + ((channels,) if channels else ())
    x = rng.standard_normal(shape).astype(np.float32)
    kw = dict(win_length=win, hop_length=hop, n_fft=n_fft,
              normalized_stft=normalized, center=center)
    jistft = jf.ISTFT(sr, **kw)
    out_shape = jax.eval_shape(
        lambda x: jistft(x, sig_length=sig_length), x).shape
    R = rng.standard_normal(out_shape).astype(np.float32)
    jout, jvjp = jax.vjp(jax.jit(lambda x: jistft(x, sig_length=sig_length)),
                         jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(R))
    xt = _t(x).requires_grad_()
    out = pf.ISTFT(sr, **kw)(xt, sig_length=sig_length)
    assert out.shape == jout.shape
    _close_to_scale(out.detach().numpy(), _np(jout), 2e-6, "output")
    (out * _t(R)).sum().backward()
    _close_to_scale(xt.grad.numpy(), _np(jg), 2e-6, "input")


@pytest.mark.parametrize("n_fft,hop_ms", [(512, 16.0), (400, 10.0)])
def test_stft_istft_round_trip(n_fft, hop_ms):
    """STFT then ISTFT gives the signal back (within 2e-6 of its scale)
    on both sides, and the two inverses agree."""
    sr = 8000 if n_fft == 512 else 16000
    win = 1000.0 * (n_fft // 2 if n_fft == 512 else n_fft) / sr
    hop = int(sr * hop_ms / 1000)
    rng = np.random.default_rng(n_fft)
    T = 30 * hop
    x = rng.standard_normal((2, T)).astype(np.float32)
    kw = dict(win_length=win, hop_length=hop_ms, n_fft=n_fft)
    got = pf.ISTFT(sr, **kw)(pf.STFT(sr, **kw)(_t(x)), sig_length=T)
    want = jax.jit(lambda x: jf.ISTFT(sr, **kw)(jf.STFT(sr, **kw)(x),
                                                 sig_length=T))(jnp.asarray(x))
    _close_to_scale(got.numpy(), x, 2e-6, "port round trip")
    _close_to_scale(_np(want), x, 2e-6, "JAX round trip")
    _close_to_scale(got.numpy(), _np(want), 2e-6, "port vs JAX")


@pytest.mark.parametrize("gain", [0.05, 4.0])
def test_resynthesize_matches_jax(gain):
    """The enhanced magnitude's and the noisy input's gradients within
    2e-5 of their scale, outputs within 2e-6; at ``gain`` 4 each row's
    peak exceeds 1, so the normalisation divides."""
    rng = np.random.default_rng(int(gain * 100))
    T = 2048  # 16 hops: the ISTFT gives T samples (sig_length only cuts)
    noisy = (gain * rng.standard_normal((2, T))).astype(np.float32)
    kw = dict(win_length=32.0, hop_length=16.0, n_fft=512)
    jstft, jistft = jf.STFT(8000, **kw), jf.ISTFT(8000, **kw)
    n_frames = jax.eval_shape(jstft, noisy).shape[1]
    mag = (gain * rng.uniform(0.1, 2.0, (2, n_frames + 1, 257))).astype(
        np.float32)  # one frame more than the phase: cut to the fewer
    R = rng.standard_normal((2, T)).astype(np.float32)

    def jfn(mag, noisy):
        return (j_resynthesize(mag, noisy, jstft, jistft) * R).sum()

    jout = jax.jit(lambda m, n: j_resynthesize(m, n, jstft, jistft))(
        jnp.asarray(mag), jnp.asarray(noisy))
    jg = jax.jit(jax.grad(jfn, (0, 1)))(jnp.asarray(mag), jnp.asarray(noisy))
    mt, nt = _t(mag).requires_grad_(), _t(noisy).requires_grad_()
    out = resynthesize(mt, nt, pf.STFT(8000, **kw), pf.ISTFT(8000, **kw))
    assert out.shape == jout.shape == (2, T)
    if gain > 1:
        assert float(out.detach().abs().max()) == pytest.approx(1.0)
    _close_to_scale(out.detach().numpy(), _np(jout), 2e-6, "output")
    (out * _t(R)).sum().backward()
    _close_to_scale(mt.grad.numpy(), _np(jg[0]), 2e-5, "magnitude")
    _close_to_scale(nt.grad.numpy(), _np(jg[1]), 2e-5, "noisy")


# (d_model, input width, causal, lengths, output activation)
SE_CASES = [
    (16, 33, False, False, "sigmoid"),
    (16, 33, True, True, "relu"),
    (16, 16, True, False, "softplus"),
    (16, 24, False, True, "linear"),
]


def _se_pair(d_model, width, causal, act):
    kw = dict(d_model=d_model, output_size=width, output_activation=act,
              nhead=4, num_layers=2, d_ffn=32, causal=causal)
    return JSE.CNNTransformerSE(**kw), PSE.CNNTransformerSE(**kw)


def _check_module(jm, pm, inputs, to_sd, rng, out_tol=2e-6, jkw=None,
                  pkw=None, grad_tol=2e-5, float64=False):
    """Outputs, the first input's and every parameter's gradients of the
    JAX module ``jm`` (eval) and the port's ``pm`` with its weights from
    ``to_sd``; with ``float64`` both f32 runs' gradients also within
    ``grad_tol`` of the port's float64 run.  Returns the JAX params."""
    jkw, pkw = dict(jkw or {}, train=False), pkw or {}
    variables = _randomize(jax.eval_shape(
        functools.partial(jm.init, **jkw), jax.random.PRNGKey(0), *inputs),
        rng)
    params = variables["params"]
    out_shape = jax.eval_shape(functools.partial(jm.apply, **jkw),
                               variables, *inputs).shape
    R = rng.standard_normal(out_shape).astype(np.float32)

    def jfn(params, x, *rest):
        out = jm.apply({"params": params}, x, *rest, **jkw)
        return (out * R).sum(), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jfn, (0, 1), has_aux=True))(params, *map(jnp.asarray, inputs))
    pm.load_state_dict(to_sd(jax.device_get(params)))
    pm.eval()
    xt = _t(inputs[0]).requires_grad_()
    out = pm(xt, *[_t(a) for a in inputs[1:]], **pkw)
    assert out.shape == jout.shape
    _close_to_scale(out.detach().numpy(), _np(jout), out_tol, "output")
    (out * _t(R)).sum().backward()
    _close_to_scale(xt.grad.numpy(), _np(jgx), grad_tol, "input")
    want = to_sd(jax.device_get(jg))
    G = max(float(v.abs().max()) for v in want.values())
    for name, p in pm.named_parameters():
        _close_to_scale(p.grad.numpy(), want[name].numpy(), grad_tol, name,
                        floor=0.05 * G)
    if float64:
        grads32 = {k: p.grad.numpy() for k, p in pm.named_parameters()}
        pm.double().zero_grad()
        out64 = pm(*[_t(a).double() for a in inputs], **pkw)
        (out64 * _t(R).double()).sum().backward()
        for name, p in pm.named_parameters():
            for got in (grads32[name], want[name].numpy()):
                _close_to_scale(got, p.grad.numpy(), grad_tol, name,
                                floor=0.05 * G)
    return params


@pytest.mark.parametrize("case", SE_CASES)
def test_cnn_transformer_se_matches_jax(case):
    d_model, width, causal, with_lengths, act = case
    rng = np.random.default_rng(SE_CASES.index(case))
    jm, pm = _se_pair(d_model, width, causal, act)
    x = rng.uniform(0, 2, (2, 11, width)).astype(np.float32)
    inputs = (x,)
    if with_lengths:
        inputs = (x, np.array([1.0, 0.64], np.float32))
    params = _check_module(jm, pm, inputs,
                           bridge.cnn_transformer_se_state_dict, rng)
    assert ("in_proj" in params) == (width != d_model)
    assert (pm.in_proj is not None) == (width != d_model)


def test_spectral_mask_wrapper_matches_jax():
    """The yamls' STFT (32 ms at 16 ms, n_fft 512) at 8 kHz on 0.26 s of
    noise, a sigmoid mask: the wrapper's output within 1e-5 of its scale,
    the gradients within 2e-4, and both f32 runs' within 2e-4 of float64
    (see the module docstring)."""
    rng = np.random.default_rng(7)
    kw = dict(d_model=16, output_size=257, output_activation="sigmoid",
              nhead=4, num_layers=1, d_ffn=32, causal=False)
    jm = JSE.SpectralMaskWrapper(masker=JSE.CNNTransformerSE(**kw))
    pm = PSE.SpectralMaskWrapper(PSE.CNNTransformerSE(**kw))
    wav = (0.3 * rng.standard_normal((2, 2100))).astype(np.float32)
    _check_module(jm, pm, (wav,), bridge.spectral_mask_state_dict, rng,
                  out_tol=1e-5, grad_tol=2e-4, float64=True)


@pytest.mark.parametrize("name", ["cnn_transformer_se", "spectral_mask"])
def test_enhancement_bridge_round_trip_is_exact(name):
    """JAX params -> the port's state_dict -> JAX params, and a port
    state_dict -> JAX -> port, equal bit for bit, every entry."""
    rng = np.random.default_rng(len(name))
    kw = dict(d_model=16, output_size=33, nhead=4, num_layers=2, d_ffn=32)
    if name == "spectral_mask":
        kw["output_size"] = 129
        jm = JSE.SpectralMaskWrapper(masker=JSE.CNNTransformerSE(**kw),
                                     n_fft=256)
        pm = PSE.SpectralMaskWrapper(PSE.CNNTransformerSE(**kw), n_fft=256)
        x = np.ones((1, 2000), np.float32)
        fwd = bridge.spectral_mask_state_dict
        back = bridge.to_jax_spectral_mask
    else:
        jm, pm = JSE.CNNTransformerSE(**kw), PSE.CNNTransformerSE(**kw)
        x = np.ones((1, 5, 33), np.float32)
        fwd, back = (bridge.cnn_transformer_se_state_dict,
                     bridge.to_jax_cnn_transformer_se)
    params = _randomize(jax.eval_shape(
        functools.partial(jm.init, train=False), jax.random.PRNGKey(0), x)[
            "params"], rng)
    _round_trip(params, pm, fwd, back)


def _round_trip(params, pm, fwd, back):
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


# ------------------------------------------------------------ the WHAM recipe

from speechbrain_tpu_torch.recipes import wham_separation as wham  # noqa: E402

from .test_torch_separation_recipes import (  # noqa: E402
    RECIPES, RUN_OPTS, TOY_SEP)
from .test_torch_timit import _load_path  # noqa: E402

TOY_SE = dict(d_model=16, nhead=2, num_layers=1, d_ffn=32)


@pytest.mark.parametrize("sample_rate", [8000, 16000])
def test_prepare_wham_matches_jax(sample_rate, tmp_path):
    """The port's manifests equal JAX's on a ``wav8k`` and a ``wav16k``
    tree (paths, durations, ``noise_wav``)."""
    data = str(tmp_path / "wham")
    wham.write_synthetic_wham(data, {"tr": 2, "cv": 1, "tt": 1}, (0.2, 0.3),
                              seed=1, sample_rate=sample_rate)
    train = _load_path("wham_train", RECIPES / "WHAMandWHAMR/separation/"
                       "train.py")
    train.prepare_wham(data, str(tmp_path / "jax"), sample_rate=sample_rate)
    wham.prepare_wham(data, str(tmp_path / "port"), sample_rate=sample_rate)
    for split in ("tr", "cv", "tt"):
        port = json.load(open(tmp_path / "port" / f"wham_{split}.json"))
        assert port == json.load(open(tmp_path / "jax" / f"wham_{split}.json"))
        assert all(f"wav{sample_rate // 1000}k" in e["noise_wav"]
                   for e in port.values())


def test_dynamic_mix_is_keyed_by_epoch_and_mixture(tmp_path):
    """``DynamicMix`` gives a mixture the same sources, gains, crops and
    scale whatever was mixed before it, other ones at another epoch; the
    mixture is the scaled sources plus the scaled noise, its peak at most
    0.9; JAX's pipeline, one generator for all, mixes an example
    differently when the order of the reads changes."""
    data = str(tmp_path / "wham")
    wham.write_synthetic_wham(data, {"tr": 3, "cv": 1, "tt": 1}, (0.3, 0.5),
                              seed=2, num_spks=1)
    wham.prepare_wham(data, str(tmp_path / "save"), num_spks=1)
    hp = dict(wham.HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAM_DM,
              training_signal_len=2000, **{
                  f"{s}_data": str(tmp_path / "save" / f"wham_{t}.json")
                  for s, t in (("train", "tr"), ("valid", "cv"),
                               ("test", "tt"))})
    ds, mix = wham.wham_dataio_prep(hp)
    assert isinstance(mix, wham.DynamicMix)
    first = ds["train"][1]
    ds["train"][0]
    again = ds["train"][1]
    assert all(np.array_equal(first[k], again[k]) for k in ("mix_sig",
                                                           "s1_sig"))
    mix.set_epoch(2)
    assert not np.array_equal(ds["train"][1]["mix_sig"], first["mix_sig"])
    mix.set_epoch(0)
    entry = json.load(open(hp["train_data"]))[first["id"]]
    from speechbrain_tpu_torch.dataio.dataio import read_audio

    noise = read_audio(entry["noise_wav"])
    residual = first["mix_sig"] - first["s1_sig"]  # the scaled noise crop
    scale = np.abs(residual).max() / np.abs(noise).max()
    assert 0 < scale <= 1.0 + 1e-6 and np.abs(first["mix_sig"]).max() <= 0.9
    # the validation set is read as it is, not mixed
    v = ds["valid"][0]
    np.testing.assert_array_equal(
        v["mix_sig"], read_audio(json.load(open(hp["valid_data"]))[v["id"]][
            "mix_wav"])[:len(v["mix_sig"])])
    train = _load_path("wham_train_dm", RECIPES / "WHAMandWHAMR/enhancement/"
                       "train.py")
    a = train.dataio_prep(dict(hp))["train"]
    b = train.dataio_prep(dict(hp))["train"]
    in_order = a[1]["mix_sig"]
    b[0]
    assert not np.array_equal(b[1]["mix_sig"], in_order)


def test_wham_dynamic_mixing_resumes_bit_for_bit(tmp_path):
    """The CNN-Transformer enhancement yaml with dynamic mixing: ``run``
    for 1 epoch, then a fresh Brain on a copy of its folder runs epoch 2
    and ends where 2 uninterrupted epochs end, bit for bit (the modules,
    Adam's state, the rate, the plateau schedule, the generator); every
    SI-SNR finite."""
    data = str(tmp_path / "wham")
    wham.write_synthetic_wham(data, {"tr": 3, "cv": 1, "tt": 1}, (0.3, 0.5),
                              seed=3, num_spks=1)
    hp = dict(TOY_SE, training_signal_len=2048, batch_size=2)
    hparams = wham.HPARAMS_ENHANCEMENT_CNNTRANSFORMER_WHAMR_DM

    def fit(out, epochs):
        parts = wham.build(data, out, dict(hp, number_of_epochs=epochs),
                           RUN_OPTS, hparams)
        parts["brain"].fit(parts["epoch_counter"], parts["train_loader"],
                           parts["valid_loader"])
        return parts["brain"]

    first = wham.run(data, str(tmp_path / "first"),
                     dict(hp, number_of_epochs=1), RUN_OPTS, hparams)
    assert np.isfinite(first.stage_stats["TEST"]["si-snr"])
    shutil.copytree(tmp_path / "first", tmp_path / "resumed")
    resumed = fit(str(tmp_path / "resumed"), 2)
    whole = fit(str(tmp_path / "whole"), 2)
    a, b = resumed.modules.state_dict(), whole.modules.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = (resumed.optimizer.state_dict()["state"],
              whole.optimizer.state_dict()["state"])
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert resumed.lr == whole.lr
    assert resumed.lr_scheduler.losses == whole.lr_scheduler.losses
    assert len(resumed.lr_scheduler.losses) == 2
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert isinstance(resumed.hparams.crop, wham.DynamicMix)
    assert resumed.hparams.crop.epoch == 2


def test_wham_16k_separation_yaml_trains_through_run(tmp_path):
    """``sepformer-whamr-16k-DM.yaml`` (enhancement at 16 kHz, dynamic
    mixing) at toy widths on a ``wav16k`` tree, and
    ``separation/sepformer-wham.yaml`` (two sources): one epoch each,
    finite SI-SNRs."""
    for rate, spks, hparams in (
            (16000, 1, wham.HPARAMS_ENHANCEMENT_SEPFORMER_WHAMR_16K_DM),
            (8000, 2, wham.HPARAMS_SEPARATION_SEPFORMER_WHAM)):
        data = str(tmp_path / f"wham{rate}")
        wham.write_synthetic_wham(data, {"tr": 2, "cv": 1, "tt": 1},
                                  (0.3, 0.4), seed=4, sample_rate=rate,
                                  num_spks=spks)
        brain = wham.run(data, str(tmp_path / f"out{rate}"),
                         dict(TOY_SEP, training_signal_len=2400,
                              number_of_epochs=1, batch_size=2), RUN_OPTS,
                         hparams)
        assert brain.modules.masknet.num_spks == spks
        assert np.isfinite(brain.stage_stats["VALID"]["si-snr"])
        assert np.isfinite(brain.stage_stats["TEST"]["si-snr"])
