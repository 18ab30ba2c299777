"""The binaural separation slice on the port against the JAX package:

- ``BinauralConvTasNet`` in each mode ("independent", "parallel",
  "cross": the ILD through the STFT, ``log10`` and the linear resize),
  outputs and the input's and every parameter's gradient, weights carried
  by the bridge; the bridge's round trips, exact both ways; the resize
  refuses to shrink (JAX antialiases there, ``F.interpolate`` does not);
- ``read_audio_multichannel`` against JAX's, on a stereo WAV and on a
  list of files;
- the recipe's loss, the ears folded into time (one permutation an
  example), against the JAX recipe's ``Separation.compute_objectives``
  (``recipes/BinauralWSJ0Mix/separation/train.py`` taken by path);
- the manifests' durations at the files' rate (JAX divides by 8000);
- the five yamls' dicts through ``run`` on a synthetic stereo tree (one
  epoch, every SI-SNR finite).

Tolerances as in ``test_torch_separation.py`` for Conv-TasNet: outputs
within 2e-6 of their scale, gradients within 2e-5 of each tensor's scale
(or of 5 % of the largest parameter gradient); in the "cross" mode (the
ILD's ``log10`` of a ratio of STFT magnitudes) both f32 runs' gradients
also within 2e-5 of the port's float64 run.  The losses within 2e-5 dB.
"""

import functools
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio.dataio import (
    read_audio_multichannel as j_read_multichannel,
)
from speechbrain_tpu.lobes.models import conv_tasnet as JC
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.dataio.dataio import read_audio_multichannel
from speechbrain_tpu_torch.lobes.models import conv_tasnet as PC
from speechbrain_tpu_torch.recipes import binaural_separation as recipe

from .test_torch_enhancement import _check_module, _round_trip
from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_separation import _randomize
from .test_torch_separation_recipe import REPO
from .test_torch_timit import _load_path

BINAURAL = REPO / "recipes/BinauralWSJ0Mix/separation"
TOY = dict(N=16, B=8, H=16, X=2, R=1, C=2, L=8)
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
MODES = ["independent", "parallel", "cross"]


@pytest.mark.parametrize("mode", MODES)
def test_binaural_convtasnet_matches_jax(mode):
    rng = np.random.default_rng(MODES.index(mode))
    jm = JC.BinauralConvTasNet(mode=mode, **TOY)
    pm = PC.BinauralConvTasNet(mode=mode, **TOY)
    mix = (0.3 * rng.standard_normal((2, 2048, 2))).astype(np.float32)
    _check_module(jm, pm, (mix,), bridge.binaural_convtasnet_state_dict, rng,
                  float64=mode == "cross", jkw={}, pkw={})


def test_binaural_resize_refuses_to_shrink():
    """The ILD's frames (hop 128) resized to fewer encoder frames (L 512,
    hop 256) would need JAX's antialiasing: the port asserts."""
    pm = PC.BinauralConvTasNet(mode="cross", **dict(TOY, L=512)).eval()
    with pytest.raises(AssertionError):
        pm(torch.ones(1, 4096, 2))


@pytest.mark.parametrize("mode", MODES)
def test_binaural_bridge_round_trip_is_exact(mode):
    rng = np.random.default_rng(10 + MODES.index(mode))
    jm = JC.BinauralConvTasNet(mode=mode, **TOY)
    params = _randomize(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), np.ones((1, 2048, 2), np.float32))[
            "params"], rng)
    _round_trip(params, PC.BinauralConvTasNet(mode=mode, **TOY),
                bridge.binaural_convtasnet_state_dict,
                functools.partial(bridge.to_jax_binaural_convtasnet,
                                  X=TOY["X"]))


def _write_stereo(path, pcm, rate=8000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes())


def test_read_audio_multichannel_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    _write_stereo(a, rng.integers(-30000, 30000, (400, 2)))
    _write_stereo(b, rng.integers(-30000, 30000, (400, 1)))
    for obj in (str(a), {"files": [str(a), str(b)], "start": 10, "stop": 300},
                {"file": str(b)}):
        got, want = read_audio_multichannel(obj), j_read_multichannel(obj)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert read_audio_multichannel(str(a)).shape == (400, 2)


def test_binaural_loss_folds_ears_into_time_as_jax():
    """The port's ``BinauralSeparation.compute_objectives`` against the
    JAX recipe's on the same (B, T, 2, 2) estimates, some rows' best
    permutation swapped, a dummy row weighted 0; the folded loss takes
    one permutation for both ears, so it differs from the mean of the
    ears' own PIT losses when the ears would pick differently."""
    train = _load_path("binaural_train", BINAURAL / "train.py")
    rng = np.random.default_rng(5)
    B, T = 3, 400
    src = rng.standard_normal((B, T, 2, 2)).astype(np.float32)
    est = (src + 0.3 * rng.standard_normal(src.shape)).astype(np.float32)
    est[0] = est[0][..., ::-1]  # both ears swapped
    est[1, :, 1] = est[1, :, 1, ::-1]  # the right ear alone
    batch = {"s1_sig": src[..., 0], "s2_sig": src[..., 1],
             "mix_sig": src.sum(-1), "batch_mask": np.array([1, 1, 0],
                                                            np.float32)}
    hp = {"num_spks": 2, "loss_upper_lim": 999999}

    class JSelf:
        hparams = type("H", (), hp)

    want = float(train.Separation.compute_objectives(
        JSelf(), jnp.asarray(est), {k: jnp.asarray(v) for k, v in
                                    batch.items()}, None))
    brain = recipe.BinauralSeparation(
        dict(recipe.HPARAMS_CROSS, **TOY), run_opts={"device": "cpu"})
    got = float(brain.compute_objectives(
        torch.from_numpy(est), brain.prepare_batch(batch), None))
    assert abs(got - want) <= 2e-5
    per_ear = np.mean([float(brain.pit_si_snr(
        torch.from_numpy(src[:2, :, e]), torch.from_numpy(est[:2, :, e]))[0]
        .mean()) for e in range(2)])
    assert abs(per_ear - got) > 1.0


def test_binaural_durations_follow_the_file_rate(tmp_path):
    """At 16 kHz the port's durations are the files' seconds; JAX's
    ``prepare_binaural_wsjmix`` divides by 8000, doubling them (ROADMAP
    Queue 3)."""
    data = str(tmp_path / "bi16k")
    recipe.write_synthetic_binaural(data, {"tr": 2, "cv": 1, "tt": 1},
                                    (0.3, 0.4), seed=4, sample_rate=16000)
    train = _load_path("binaural_train_rate", BINAURAL / "train.py")
    train.prepare_binaural_wsjmix(data, str(tmp_path / "jax"))
    recipe.prepare_binaural_wsjmix(data, str(tmp_path / "port"))
    jm = json.load(open(tmp_path / "jax" / "binaural_tr.json"))
    pm = json.load(open(tmp_path / "port" / "binaural_tr.json"))
    assert jm.keys() == pm.keys()
    for key, entry in pm.items():
        with wave.open(entry["mix_wav"]) as w:
            assert w.getnchannels() == 2
            seconds = w.getnframes() / w.getframerate()
        assert entry["duration"] == round(seconds, 3)
        assert jm[key]["duration"] == round(2 * seconds, 3)


@pytest.mark.parametrize("yaml", sorted(recipe.YAMLS))
def test_binaural_yamls_train_through_run(yaml, tmp_path):
    """Each yaml's dict at toy widths through ``run`` on a stereo tree:
    one epoch, the test pass from the best checkpoint, finite SI-SNRs;
    crops keyed by epoch and mixture (the tree's mixtures are longer than
    the crop)."""
    data = str(tmp_path / "bi")
    recipe.write_synthetic_binaural(data, {"tr": 2, "cv": 1, "tt": 1},
                                    (0.3, 0.4), seed=6)
    brain = recipe.run(data, str(tmp_path / "out"),
                       dict(TOY, training_signal_len=2400, number_of_epochs=1,
                            batch_size=2), RUN_OPTS,
                       hparams=recipe.YAMLS[yaml])
    assert np.isfinite(brain.avg_train_loss)
    assert np.isfinite(brain.stage_stats["VALID"]["si-snr"])
    assert np.isfinite(brain.stage_stats["TEST"]["si-snr"])
    assert brain.hparams.crop.epoch == 1
