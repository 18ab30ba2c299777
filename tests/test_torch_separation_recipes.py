"""The rest of the separation family on the port against the JAX package:

- the four dual-path blocks that no yaml reaches
  (``PyTorchPositionalEncoding``, ``PytorchTransformerBlock``, ``DPTNetBlock``, ``Dual_Computation_Block``
  with and without its Linear layers, norms and skip), outputs and
  gradients through the bridge, its round trips, and the
  ``FastTransformerBlock`` stub;
- the ``Separation`` loss at ``num_spks`` 1 (enhancement) and 3 against the
  JAX recipes' ``compute_objectives`` (WHAM!'s and LibriMix's
  ``train.py``, taken by path);
- every one of the 26 yamls of WHAMandWHAMR, LibriMix, Aishell1Mix,
  BinauralWSJ0Mix and REAL-M (loaded by JAX's ``load_hyperpyyaml``)
  against its dict in the port, and each dict's model built at toy
  widths;
- the LibriMix and Aishell1Mix preparations against JAX's; the 3-mix
  yamls' manifest names (a JAX fault); the LibriMix 3-mix and Aishell1Mix
  2-mix-with-noise yamls through ``run``;
- REAL-M: the estimator's forward at B 1 equal to the JAX script's on the
  same weights and draws; the rows' pairing at B 3 (each estimate with
  its own mixture and target: a JAX fault, shown on the JAX script's
  rows); the recipe through ``run``, its checkpoint keeping the best
  ``si-snr-l1``.

Tolerances: the blocks as the separation classes (outputs 2e-6, gradients
2e-5 of each tensor's scale, ``test_torch_separation.py``); the losses
within 2e-5 dB; REAL-M's sigmoid outputs and targets within 1e-6.
"""

import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models import dual_path as JD
from speechbrain_tpu.lobes.models.Xvector import Xvector as JXvector
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.lobes.models import dual_path as PD
from speechbrain_tpu_torch.recipes import (binaural_separation,
                                           librimix_separation, realm_sisnr,
                                           wham_separation, wsj0mix_separation)

from .test_torch_enhancement import _check_module, _round_trip
from .test_torch_kernels import one_torch_thread  # noqa: F401
from .test_torch_separation import _randomize
from .test_torch_timit import _load_path

REPO = Path(__file__).resolve().parents[1]
RECIPES = REPO / "recipes"
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}
TOY_SEP = dict(encoder_out_nchannels=16, masknet_chunksize=10,
               masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1,
               intra_nhead=4, inter_nhead=4, intra_dffn=32, inter_dffn=32)

# ------------------------------------------------------------ blocks

BLOCKS = {
    "PytorchTransformerBlock": (
        lambda: JD.PytorchTransformerBlock(out_channels=16, num_layers=2,
                                           nhead=4, d_ffn=32),
        lambda: PD.PytorchTransformerBlock(16, num_layers=2, nhead=4,
                                           d_ffn=32),
        (2, 10, 16), bridge.pytorch_transformer_block_state_dict,
        bridge.to_jax_pytorch_transformer_block),
    "DPTNetBlock": (
        lambda: JD.DPTNetBlock(d_model=16, nhead=4, dim_feedforward=24),
        lambda: PD.DPTNetBlock(16, 4, dim_feedforward=24),
        (2, 10, 16), bridge.dptnet_block_state_dict,
        bridge.to_jax_dptnet_block),
    "Dual_Computation_Block": (
        lambda: JD.Dual_Computation_Block(out_channels=16, nhead=4, d_ffn=32),
        lambda: PD.Dual_Computation_Block(16, nhead=4, d_ffn=32),
        (2, 5, 6, 16), bridge.dual_computation_block_state_dict,
        bridge.to_jax_dual_computation_block),
    "Dual_Computation_Block_linear_nonorm_noskip": (
        lambda: JD.Dual_Computation_Block(
            out_channels=16, nhead=4, d_ffn=32, intra_numlayers=2, norm=None,
            skip_around_intra=False, linear_layer_after_inter_intra=True),
        lambda: PD.Dual_Computation_Block(
            16, nhead=4, d_ffn=32, intra_numlayers=2, norm=None,
            skip_around_intra=False, linear_layer_after_inter_intra=True),
        (2, 5, 6, 16), bridge.dual_computation_block_state_dict,
        bridge.to_jax_dual_computation_block),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_dual_path_blocks_match_jax(name):
    jmake, pmake, shape, fwd, _ = BLOCKS[name]
    rng = np.random.default_rng(sorted(BLOCKS).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    _check_module(jmake(), pmake(), (x,), fwd, rng)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_dual_path_blocks_bridge_round_trip_is_exact(name):
    jmake, pmake, shape, fwd, back = BLOCKS[name]
    rng = np.random.default_rng(20 + sorted(BLOCKS).index(name))
    params = _randomize(jax.eval_shape(
        functools.partial(jmake().init, train=False), jax.random.PRNGKey(0),
        np.ones(shape, np.float32))["params"], rng)
    _round_trip(params, pmake(), fwd, back)


def test_pytorch_positional_encoding_matches_jax():
    """The tutorial's sinusoids added (eval: no dropout), within 1e-6."""
    x = np.random.default_rng(0).standard_normal((2, 37, 12)).astype(
        np.float32)
    jm = JD.PyTorchPositionalEncoding(d_model=12)
    want = jm.apply(jm.init(jax.random.PRNGKey(0), x, train=False), x,
                    train=False)
    got = PD.PyTorchPositionalEncoding(12).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_fast_transformer_block_raises_import_error():
    with pytest.raises(ImportError):
        JD.FastTransformerBlock()
    with pytest.raises(ImportError, match="fast_transformers"):
        PD.FastTransformerBlock(out_channels=16)


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("num_spks,script", [
    (1, "WHAMandWHAMR/enhancement/train.py"),
    (3, "LibriMix/separation/train.py")])
def test_separation_loss_matches_jax(num_spks, script):
    """The port's ``Separation.compute_objectives`` (``s1_sig`` ...
    ``s{n}_sig`` stacked) against the JAX recipe's on the same estimates
    (at 3 sources each row's best of the 6 permutations another), a
    dummy row weighted 0, within 2e-5 dB."""
    train = _load_path(f"sep_train_{num_spks}", RECIPES / script)
    rng = np.random.default_rng(num_spks)
    B, T = 3, 500
    src = rng.standard_normal((B, T, num_spks)).astype(np.float32)
    est = (src + 0.5 * rng.standard_normal(src.shape)).astype(np.float32)
    est[0] = est[0][:, ::-1]
    est[1] = np.roll(est[1], 1, axis=-1)
    batch = {f"s{i + 1}_sig": src[..., i] for i in range(num_spks)}
    batch.update(mix_sig=src.sum(-1), batch_mask=np.array([1, 1, 0],
                                                          np.float32))
    hp = SimpleNamespace(num_spks=num_spks, loss_upper_lim=999999)
    want = float(train.Separation.compute_objectives(
        SimpleNamespace(hparams=hp), jnp.asarray(est),
        {k: jnp.asarray(v) for k, v in batch.items()}, None))
    brain = wsj0mix_separation.Separation(
        dict(TOY_SEP, num_spks=num_spks), run_opts={"device": "cpu"})
    got = float(brain.compute_objectives(torch.from_numpy(est),
                                         brain.prepare_batch(batch), None))
    assert abs(got - want) <= 2e-5
    perms = brain.pit_si_snr._permutations(num_spks, "cpu")
    assert perms.shape == ((1, 1) if num_spks == 1 else (6, 3))


# ------------------------------------------------------------ the 26 yamls

YAML_DICTS = (
    [(f"WHAMandWHAMR/{k}", v) for k, v in wham_separation.YAMLS.items()]
    + list(librimix_separation.YAMLS.items())
    + [(f"BinauralWSJ0Mix/separation/{k}", v)
       for k, v in binaural_separation.YAMLS.items()]
    + [(f"REAL-M/sisnr-estimation/{k}", v)
       for k, v in realm_sisnr.YAMLS.items()])
SCALARS = ("seed", "sample_rate", "num_spks", "training_signal_len",
           "batch_size", "number_of_epochs", "lr", "max_grad_norm",
           "loss_upper_lim", "limit_training_signal_len", "dynamic_mixing",
           "use_wham_noise", "binaural_model", "snr_low", "snr_high", "n_fft")
MODEL_FIELDS = {
    "SepformerWrapper": ("encoder_kernel_size", "encoder_out_nchannels",
                         "masknet_chunksize", "masknet_numlayers",
                         "intra_numlayers", "inter_numlayers", "intra_nhead",
                         "inter_nhead", "intra_dffn", "inter_dffn",
                         "use_rnn"),
    "ConvTasNet": ("N", "B", "H", "P", "X", "R", "L", "norm_type", "causal",
                   "mask_nonlinear"),
    "BinauralConvTasNet": ("mode", "N", "B", "H", "P", "X", "R", "L",
                           "norm_type", "causal", "mask_nonlinear",
                           "sample_rate"),
}


def test_every_yaml_of_the_family_has_a_dict():
    """26 yaml files in the five folders (WHAMandWHAMR 12), each with
    one dict."""
    files = sorted(
        str(p.relative_to(RECIPES)) for folder in (
            "WHAMandWHAMR", "LibriMix", "Aishell1Mix", "BinauralWSJ0Mix",
            "REAL-M") for p in (RECIPES / folder).rglob("*.yaml"))
    assert len(files) == 26
    assert sorted(k for k, _ in YAML_DICTS) == files


@pytest.mark.parametrize("path", [k for k, _ in YAML_DICTS])
def test_yaml_dict_matches_the_jax_yaml(path, tmp_path):
    """The yaml's top-level values, its model's (and masker's, scheduler's)
    fields equal the dict's; the dict's model builds at toy widths and
    runs on a short mixture."""
    hp = dict(YAML_DICTS)[path]
    with open(RECIPES / path) as f:
        y = load_hyperpyyaml(f, {"data_folder": str(tmp_path),
                                 "output_folder": str(tmp_path)})
    for key in SCALARS:
        if key in y:
            assert hp[key] == y[key], key
    for key in SCALARS:
        if key in hp and key not in y:
            # absent from the yaml: the JAX script's default
            assert (key, hp[key]) in (
                ("dynamic_mixing", False), ("max_grad_norm", 5.0),
                ("num_spks", 2), ("limit_training_signal_len", True),
                ("n_fft", None)), key
    if "lr_scheduler" in y:
        s = y["lr_scheduler"]
        assert (hp["lr_factor"], hp["lr_patience"],
                hp["dont_halve_until_epoch"]) == (
                    s.factor, s.patience, s.dont_halve_until_epoch)
    if path.startswith("REAL-M"):
        enc = y["modules"]["encoder"]
        assert list(enc.tdnn_channels) == hp["tdnn_channels"]
        assert enc.lin_neurons == hp["lin_neurons"]
        return
    model = y["modules"]["masknet"]
    assert type(model).__name__ == hp["model"]
    if hp["model"] == "SpectralMaskWrapper":
        assert (model.sample_rate, model.n_fft) == (hp["sample_rate"],
                                                    hp["n_fft"])
        m = model.masker
        assert m.output_size == hp["n_fft"] // 2 + 1
        for key in ("d_model", "output_activation", "num_layers", "d_ffn",
                    "nhead", "causal", "dropout"):
            assert getattr(m, key) == hp[key], key
        toy = dict(d_model=16, nhead=2, num_layers=1, d_ffn=32)
    else:
        for key in MODEL_FIELDS[hp["model"]]:
            assert getattr(model, key) == hp[key], key
        spks = getattr(model, "masknet_numspks", getattr(model, "C", None))
        assert spks == hp["num_spks"]
        toy = dict(TOY_SEP, N=16, B=8, H=16, X=2, R=1)
    net = wsj0mix_separation.build_model(dict(hp, **toy)).eval()
    T = 2048  # the independent yaml's mono model runs on one ear
    out = net(torch.randn((1, T, 2) if hp.get("binaural_model") else (1, T)))
    assert out.shape[:2] == (1, T) and out.shape[-1] == hp["num_spks"]


# ------------------------------------------------------------ LibriMix


@pytest.mark.parametrize("corpus,wham", [("librimix", False),
                                         ("aishell1mix", True)])
def test_mix_preparations_match_jax(corpus, wham, tmp_path):
    """At 8 kHz the port's manifests equal JAX's (the same entries,
    paths and durations), ``use_wham_noise`` reading ``mix_both``."""
    data = str(tmp_path / "tree")
    train_dir = "train-360" if corpus == "librimix" else "train"
    librimix_separation.write_synthetic_librimix(
        data, {train_dir: 2, "dev": 1, "test": 1}, (0.2, 0.3), seed=1,
        train=train_dir)
    folder = "LibriMix" if corpus == "librimix" else "Aishell1Mix"
    train = _load_path(f"{corpus}_train", RECIPES / folder /
                       "separation/train.py")
    getattr(train, f"prepare_{corpus}")(data, str(tmp_path / "jax"),
                                         use_wham_noise=wham)
    getattr(librimix_separation, f"prepare_{corpus}")(
        data, str(tmp_path / "port"), use_wham_noise=wham)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 3
    for name in names:
        port = json.load(open(tmp_path / "port" / name))
        assert port == json.load(open(tmp_path / "jax" / name))
        assert all(("mix_both" if wham else "mix_clean") in e["mix_wav"]
                   and train_dir in e["mix_wav"] or "train" not in name
                   for e in port.values())


def test_three_mix_yamls_name_the_two_mix_manifests(tmp_path):
    """A JAX fault: ``sepformer-libri3mix.yaml`` reads
    ``libri2mix_*.json``, while its prepare step at 3 sources writes
    ``libri3mix_*.json`` (the Aishell1Mix 3-mix yamls alike); the port's
    ``build`` names the manifests from ``num_spks``."""
    with open(RECIPES / "LibriMix/separation/hparams/sepformer-libri3mix.yaml"
              ) as f:
        y = load_hyperpyyaml(f, {"data_folder": str(tmp_path),
                                 "output_folder": str(tmp_path)})
    assert y["num_spks"] == 3 and y["train_data"].endswith(
        "libri2mix_train.json")
    data = str(tmp_path / "libri3")
    librimix_separation.write_synthetic_librimix(
        data, {"train-100": 2, "dev": 1, "test": 1}, (0.2, 0.3), seed=2,
        num_spks=3)
    parts = librimix_separation.build(
        data, str(tmp_path / "out"), dict(TOY_SEP, number_of_epochs=1),
        RUN_OPTS, hparams=librimix_separation.HPARAMS_LIBRI3MIX)
    hp = parts["hparams"]
    assert hp["train_data"].endswith("libri3mix_train.json")
    entry = next(iter(json.load(open(hp["train_data"])).values()))
    assert "s3_wav" in entry
    assert parts["train_loader"].dataset[0]["s3_sig"].shape == (
        hp["training_signal_len"],)


@pytest.mark.parametrize("name", ["HPARAMS_LIBRI3MIX",
                                  "HPARAMS_AISHELL1MIX2_WHAM"])
def test_mix_yamls_train_through_run(name, tmp_path):
    hparams = getattr(librimix_separation, name)
    n = hparams["num_spks"]
    data = str(tmp_path / "tree")
    train_dir = "train" if hparams["corpus"] == "aishell1mix" else "train-100"
    librimix_separation.write_synthetic_librimix(
        data, {train_dir: 2, "dev": 1, "test": 1}, (0.3, 0.4), seed=3,
        num_spks=n, train=train_dir)
    brain = librimix_separation.run(
        data, str(tmp_path / "out"),
        dict(TOY_SEP, training_signal_len=2400, number_of_epochs=1,
             batch_size=2), RUN_OPTS, hparams=hparams)
    assert np.isfinite(brain.avg_train_loss)
    assert np.isfinite(brain.stage_stats["VALID"]["si-snr"])
    assert np.isfinite(brain.stage_stats["TEST"]["si-snr"])


# ------------------------------------------------------------ REAL-M

REALM_TOY = {"tdnn_channels": [8, 8, 8, 8, 16], "lin_neurons": 8}


def _realm_pair(rng, B, T):
    """A port estimator (eval) and the JAX script's ``compute_forward`` on
    a stand-in ``self`` with the same weights (the bridge) and the port's
    degradation draws; returns (port brain, batch, JAX forward)."""
    train = _load_path("realm_train", RECIPES / "REAL-M/sisnr-estimation/"
                       "train.py")
    brain = realm_sisnr.SISNREstimator(REALM_TOY, run_opts={"device": "cpu"})
    brain.modules.eval()
    s = (0.3 * rng.standard_normal((2, B, T))).astype(np.float32)
    batch = brain.prepare_batch({"mix_sig": s[0] + s[1], "s1_sig": s[0],
                                 "s2_sig": s[1]})
    state = brain.generator.get_state()
    targets = torch.stack([batch["s1_sig"], batch["s2_sig"]], -1)
    est = brain.degrade(targets).numpy()
    brain.generator.set_state(state)
    jx = JXvector(tdnn_channels=tuple(REALM_TOY["tdnn_channels"]),
                  lin_neurons=REALM_TOY["lin_neurons"])
    jvars = jax.tree_util.tree_map(np.asarray, bridge.to_jax_xvector(
        brain.modules.encoder.state_dict()))
    jlin = JLinear(n_neurons=1)
    lin = {"params": {"Dense_0": bridge._dense_to_jax(bridge._Sub(
        brain.modules.encoder_out.state_dict()))}}
    seen = {}

    def encoder(x):
        seen["input"] = np.asarray(x)
        return jx.apply(jvars, x, train=False)

    fake = SimpleNamespace(
        hparams=SimpleNamespace(snr_low=-10.0, snr_high=35.0),
        _degrade=lambda targets, mix, key: jnp.asarray(est),
        _bound_rngs={"augment": None},
        modules=SimpleNamespace(encoder=encoder,
                                encoder_out=lambda e: jlin.apply(lin, e)))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    return brain, batch, est, (lambda: train.SISNREstimator.compute_forward(
        fake, jbatch, None)), seen


def test_realm_forward_at_one_example_matches_jax():
    """At B 1 the two row orders agree: the estimator's outputs and the
    compressed oracle SI-SNRs within 1e-6."""
    brain, batch, _, jforward, _ = _realm_pair(np.random.default_rng(0),
                                               1, 1200)
    with torch.no_grad():
        got = brain.compute_forward(batch, Stage.VALID)
    want = jforward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def _rows_pair_up(inp, oracle, est, mix, snr):
    """Whether each row r of the estimator's input holds one (b, s)'s
    estimate beside example b's mixture, with that (b, s)'s target."""
    B, _, S = est.shape
    for r in range(B * S):
        hits = [(b, s) for b in range(B) for s in range(S)
                if np.array_equal(inp[r, :, 0], est[b, :, s])]
        if len(hits) != 1:
            return False
        b, s = hits[0]
        if not (np.array_equal(inp[r, :, 1], mix[b])
                and abs(oracle[r] - snr[b, s]) < 1e-6):
            return False
    return True


def test_realm_rows_pair_each_estimate_with_its_mixture_and_target():
    """A JAX fault the port repairs: at B 3 each of the port's rows holds
    one (example, source)'s estimate, that example's mixture and that
    estimate's target; the JAX script's rows (its estimates example-major,
    its mixtures tiled and its targets flattened source-major) do not."""
    brain, batch, est, jforward, seen = _realm_pair(
        np.random.default_rng(1), 3, 900)
    mix = batch["mix_sig"].numpy()
    targets = torch.stack([batch["s1_sig"], batch["s2_sig"]], -1)
    snr = -brain_snr(targets, torch.from_numpy(est))
    low, high = -10.0, 35.0
    snr_c = np.clip((snr - low) / (high - low), 0.0, 1.0)
    captured = {}
    encoder = brain.modules.encoder
    def spy(module, args):
        captured["input"] = args[0].numpy()

    hook = encoder.register_forward_pre_hook(spy)
    try:
        with torch.no_grad():
            _, oracle = brain.compute_forward(batch, Stage.VALID)
    finally:
        hook.remove()
    assert _rows_pair_up(captured["input"], oracle.numpy(), est, mix, snr_c)
    _, joracle = jforward()
    assert not _rows_pair_up(seen["input"], np.asarray(joracle), est, mix,
                             snr_c)


def brain_snr(targets, est):
    """(B, S) SI-SNR of each estimate against its source, in dB."""
    from speechbrain_tpu_torch.nnet.losses import cal_si_snr

    return cal_si_snr(targets.transpose(0, 1), est.transpose(0, 1))[0].numpy()


def test_realm_recipe_runs_and_keeps_the_best_l1(tmp_path):
    """``run`` for 2 epochs on a wsj0-mix tree: finite L1s, the
    checkpoint kept is the one of the least validation ``si-snr-l1``, and
    the validation crops are the same each epoch."""
    data = str(tmp_path / "wsj")
    wsj0mix_separation.write_synthetic_wsj0mix(
        data, {"tr": 4, "cv": 2, "tt": 2}, (0.3, 0.5), seed=7)
    brain = realm_sisnr.run(
        data, str(tmp_path / "out"),
        dict(REALM_TOY, training_signal_len=2400, number_of_epochs=2,
             batch_size=2), RUN_OPTS)
    assert all(np.isfinite([brain.stage_stats[s]["si-snr-l1"]
                            for s in ("VALID", "TEST")]))
    log = (tmp_path / "out" / "train_log.txt").read_text().splitlines()
    l1 = [float(line.rsplit("si-snr-l1: ", 1)[1].split()[0]) for line in log
          if "si-snr-l1" in line and "epoch:" in line]
    assert len(l1) == 2
    best = brain.checkpointer.find_checkpoint(min_key="si-snr-l1")
    assert best.meta["si-snr-l1"] == pytest.approx(min(l1), rel=1e-2)
    assert len(brain.checkpointer.list_checkpoints()) <= 2  # best, latest
