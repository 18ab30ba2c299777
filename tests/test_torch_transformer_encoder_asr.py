"""``TransformerASR`` with the transformer encoder (``encoder_module=
"transformer"``, the JAX module's default) against the JAX module, and
the LibriSpeech ``transformer.yaml`` recipe (``librispeech_asr.
HPARAMS_TRANSFORMER``) on the port.

Both attention types the JAX module takes with that encoder are covered:
``regularMHA`` (the absolute sine PE added to the projected input; the
encoder states reach the decoder as they are) and ``RelPosMHAXL`` (the
relative encodings; the decoder's PE also added to the encoder states,
the reference's quirk).  Parameters come from the JAX module's ``init``
with the zero-initialised biases and positional biases replaced by random
values and reach the port through ``bridge.py``; inputs are numpy arrays
from a seed.

Tolerances (float32 on the CPU; sums in other orders):

- forward, ``encode``, ``decode`` and each ``decode_step``: 2e-5
  absolute and relative;
- gradients of a weighted sum of both outputs: 2e-4 of each tensor's
  largest gradient (backward sums over the batch and time in other
  orders), and 1e-5 absolute where the gradient is 0 analytically and
  rounding noise numerically (the attention key biases, which the
  softmax removes);
- the recipe's training step (SGD, clip 5.0) against a JAX ``Brain``
  built as the recipe builds its own: the loss within 1e-5 relative and
  every post-step parameter and statistic within 1e-5, as
  ``tests/test_torch_brain.py`` holds the conformer;
- the bridge round trip and the resumed fit: exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.Transformer import (
    get_key_padding_mask as j_kpm,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JTransformerASR,
)
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASRBrain
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.recipes import librispeech_asr as recipe

from .test_torch_brain import (
    _batch,
    _flat,
    _JaxRecipeBrain,
    _loss_close,
    _randomize,
)
from .test_torch_kernels import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
ATTENTION = ["regularMHA", "RelPosMHAXL"]
DIMS = dict(tgt_vocab=24, input_size=20, d_model=32, nhead=2,
            num_encoder_layers=2, num_decoder_layers=2, d_ffn=48)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def assert_augmentation(aug, want):
    """A yaml's JAX ``SpecAugment`` against the port's arguments ``want``
    (the switches are ``<name>_flag`` there; a missing switch is on)."""
    flags = ("time_warp", "freq_mask", "time_mask")
    for key in flags:
        assert getattr(aug, f"{key}_flag") == want.get(key, True), key
    for key, value in want.items():
        if key not in flags:
            got = getattr(aug, key)
            assert (tuple(got) if isinstance(got, list) else got) == value, key


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(seed=0, B=2, T=11, L=5):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, T, DIMS["input_size"])).astype(np.float32)
    tgt = rng.integers(3, DIMS["tgt_vocab"], (B, L)).astype(np.int64)
    tgt[1, -2:] = 0  # padded target positions (pad_idx 0)
    lens = np.array([1.0, 0.7], np.float32)
    return src, tgt, lens, rng


def _pair(attention_type, normalize_before, seed=0):
    """The JAX module with randomized biases and the port's copy."""
    src, tgt, lens, rng = _inputs(seed)
    jm = JTransformerASR(**DIMS, dropout=0.0, encoder_module="transformer",
                         attention_type=attention_type,
                         normalize_before=normalize_before)
    params = jm.init(KEY, jnp.asarray(src), jnp.asarray(tgt),
                     jnp.asarray(lens), train=False)["params"]
    params = _randomize(dict(params), rng)
    m = TransformerASR(**DIMS, encoder_module="transformer",
                       attention_type=attention_type,
                       normalize_before=normalize_before).eval()
    m.load_state_dict(bridge.transformer_asr_state_dict(params))
    return jm, params, m


@pytest.mark.parametrize("normalize_before", [True, False])
@pytest.mark.parametrize("attention_type", ATTENTION)
def test_forward_and_encode_match_jax(attention_type, normalize_before):
    """``forward`` (padded sources and targets) and ``encode``."""
    jm, params, m = _pair(attention_type, normalize_before)
    src, tgt, lens, _ = _inputs()
    v = {"params": params}
    j_enc, j_dec = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(lens), train=False)
    j_raw = jm.apply(v, jnp.asarray(src), jnp.asarray(lens), method="encode")
    with torch.no_grad():
        enc, dec = m(_t(src), _t(tgt), _t(lens))
        raw = m.encode(_t(src), _t(lens))
    for got, ref in ((enc, j_enc), (dec, j_dec), (raw, j_raw)):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=2e-5,
                                   rtol=2e-5)
    # regularMHA hands the encoder states to the decoder as they are;
    # RelPosMHAXL adds the decoder's PE to them (the reference's quirk)
    same = np.array_equal(enc.numpy(), raw.numpy())
    assert same == (attention_type == "regularMHA")


@pytest.mark.parametrize("attention_type", ATTENTION)
def test_decode_and_steps_match_jax(attention_type):
    """``decode`` over the full prefix and ``decode_cache_init`` +
    ``decode_step`` one position at a time (with the beam's predecessor
    rows fused into the cache update)."""
    jm, params, m = _pair(attention_type, True, seed=1)
    src, tgt, lens, _ = _inputs(1)
    v = {"params": params}
    j_raw = jm.apply(v, jnp.asarray(src), jnp.asarray(lens), method="encode")
    j_dec, j_attn = jm.apply(v, jnp.asarray(tgt), j_raw, jnp.asarray(lens),
                             method="decode")
    B, L = tgt.shape
    j_cache = jm.apply(v, j_raw, L, method="decode_cache_init")
    with torch.no_grad():
        raw = m.encode(_t(src), _t(lens))
        dec, attn = m.decode(_t(tgt), raw, _t(lens))
        np.testing.assert_allclose(dec.numpy(), _np(j_dec), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(attn.numpy(), _np(j_attn), atol=2e-5)
        cache = m.decode_cache_init(raw, L)
        for c in cache:
            c["alt"] = torch.zeros_like(c["skv"])
        rows = torch.arange(B)
        for pos in range(L):
            j_out, j_cache = jm.apply(
                v, jnp.asarray(tgt[:, pos]), j_cache, pos, jnp.asarray(lens),
                method="decode_step")
            out, cache = m.decode_step(_t(tgt[:, pos]), cache, pos,
                                       _t(lens), rows=rows)
            np.testing.assert_allclose(out.numpy(), _np(j_out), atol=2e-5,
                                       rtol=2e-5)
            np.testing.assert_allclose(out.numpy(), dec[:, pos].numpy(),
                                       atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("attention_type", ATTENTION)
def test_gradients_match_jax(attention_type):
    """The gradients of ``sum(w1 * enc) + sum(w2 * dec)`` with respect to
    every parameter, held in the port's layout."""
    jm, params, m = _pair(attention_type, True, seed=2)
    src, tgt, lens, rng = _inputs(2)
    w1 = rng.standard_normal((2, src.shape[1], DIMS["d_model"])
                             ).astype(np.float32)
    w2 = rng.standard_normal((2, tgt.shape[1], DIMS["d_model"])
                             ).astype(np.float32)

    def j_loss(p):
        enc, dec = jm.apply({"params": p}, jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(lens), train=False)
        return jnp.sum(enc * w1) + jnp.sum(dec * w2)

    j_grads = bridge.transformer_asr_state_dict(
        jax.jit(jax.grad(j_loss))(params))
    enc, dec = m(_t(src), _t(tgt), _t(lens))
    (torch.sum(enc * _t(w1)) + torch.sum(dec * _t(w2))).backward()
    got = {k: p.grad for k, p in m.named_parameters()}
    assert got.keys() == j_grads.keys()
    for k, ref in j_grads.items():
        ref = ref.numpy()
        bound = max(2e-4 * float(np.abs(ref).max()), 1e-5)
        dev = float(np.abs(got[k].numpy() - ref).max())
        assert dev <= bound, f"{k}: {dev} > {bound}"


@pytest.mark.parametrize("attention_type", ATTENTION)
def test_bridge_round_trips(attention_type):
    """JAX params -> the port's state_dict -> JAX params, exactly, and the
    layer names tell the encoder types apart."""
    _, params, m = _pair(attention_type, False, seed=3)
    back = bridge.to_jax_transformer_asr(m.state_dict())
    j_flat, b_flat = _flat(params), _flat(back)
    assert j_flat.keys() == b_flat.keys()
    for k in j_flat:
        np.testing.assert_array_equal(b_flat[k], j_flat[k], err_msg=k)
    name = ("MultiheadAttention_0" if attention_type == "regularMHA"
            else "RelPosMHAXL_0")
    assert name in back["encoder"]["layer_0"]


def test_conformer_encoder_refuses_regular_attention():
    """As in the JAX module, the conformer takes RelPosMHAXL only."""
    with pytest.raises(ValueError, match="RelPosMHAXL"):
        TransformerASR(**DIMS, encoder_module="conformer",
                       attention_type="regularMHA")
    src, tgt, lens, _ = _inputs()
    jm = JTransformerASR(**DIMS, encoder_module="conformer",
                         attention_type="regularMHA")
    with pytest.raises(ValueError, match="RelPosMHAXL"):
        jm.init(KEY, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(lens),
                train=False)


def test_transformer_yaml_matches_the_dict(tmp_path):
    """``transformer.yaml``, loaded by JAX's ``load_hyperpyyaml``, against
    ``HPARAMS_TRANSFORMER``: the shared values, the model's fields and its
    ``lm_model``."""
    path = REPO / "recipes/LibriSpeech/ASR/transformer/hparams/transformer.yaml"
    with open(path) as f:
        y = load_hyperpyyaml(f, {"data_folder": str(tmp_path),
                                 "output_folder": str(tmp_path)})
    hp = recipe.HPARAMS_TRANSFORMER
    shared = [k for k in hp if k in y and not hasattr(y[k], "__call__")]
    assert len(shared) >= 30
    for key in shared:
        want = hp[key]
        assert y[key] == (list(want) if isinstance(want, tuple) else want), key
    t = y["transformer"]
    assert (t.encoder_module, t.attention_type, t.d_model, t.nhead,
            t.num_encoder_layers, t.num_decoder_layers, t.d_ffn, t.dropout,
            t.activation, t.normalize_before, t.input_size, t.tgt_vocab) == (
        hp["encoder_module"], hp["attention_type"], hp["d_model"],
        hp["nhead"], hp["num_encoder_layers"], hp["num_decoder_layers"],
        hp["d_ffn"], hp["transformer_dropout"], hp["activation"],
        hp["normalize_before"], hp["input_size"], hp["vocab_size"])
    lm = y["lm_model"]
    want = hp["lm_model"]
    assert (lm.vocab, lm.d_model, lm.nhead, lm.num_encoder_layers, lm.d_ffn,
            lm.activation, lm.normalize_before) == (
        hp["vocab_size"], want["d_model"], want["nhead"],
        want["num_encoder_layers"], want["d_ffn"], want["activation"],
        want["normalize_before"])
    assert_augmentation(y["augmentation"], hp["augmentation"])
    # everything but the encoder's configuration and the widths is
    # conformer_small.yaml's
    differ = {"d_model", "nhead", "num_decoder_layers", "d_ffn",
              "encoder_module", "attention_type", "lm_model"}
    assert {k for k in hp if hp[k] != recipe.HPARAMS[k]} == differ


# the recipe's training step against the JAX recipe's
CFG = dict(
    CONFORMER_SMALL, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=2, num_decoder_layers=1,
    d_ffn=64, kernel_size=7, vocab_size=32, transformer_dropout=0.0,
    lr_adam=1e-3, n_warmup_steps=4, augmentation=None,
    encoder_module="transformer",
)


def _brains(attention_type):
    cfg = dict(CFG, attention_type=attention_type)
    modules = {
        "frontend": JFrontEnd(num_blocks=2, out_channels=cfg["frontend_channels"]),
        "transformer": JTransformerASR(
            tgt_vocab=cfg["vocab_size"], input_size=cfg["input_size"],
            d_model=cfg["d_model"], nhead=cfg["nhead"],
            num_encoder_layers=cfg["num_encoder_layers"],
            num_decoder_layers=cfg["num_decoder_layers"], d_ffn=cfg["d_ffn"],
            dropout=0.0, activation="relu", normalize_before=True,
            encoder_module="transformer", attention_type=attention_type),
        "ctc_lin": JLinear(n_neurons=cfg["vocab_size"]),
        "seq_lin": JLinear(n_neurons=cfg["vocab_size"]),
    }
    jb = _JaxRecipeBrain(
        modules=modules, opt_class=lambda lr: optax.sgd(lr),
        hparams={"lr": 1e-3, "normalize": JInputNorm(norm_type="global",
                                                     update_until_epoch=4)},
        run_opts={"seed": 0, "loss_sync_interval": 1})
    jb._ensure_initialized(jb.prepare_batch(_batch(0)))
    params = _randomize(jax.device_get(jb.train_state)["params"],
                        np.random.default_rng(5))
    jb.train_state = {**jb.train_state, "params": params}
    pb = ConformerASRBrain(cfg, opt_class=lambda p: torch.optim.SGD(p, lr=1e-3),
                           device="cpu", run_opts={"loss_sync_interval": 1},
                           hparams={"lr": 1e-3})
    pb.modules.load_state_dict(_state(jb))
    return jb, pb


def _pieces(jb):
    state = jax.device_get(jb.train_state)
    p = state["params"]
    return {"frontend": {"params": p["frontend"], "batch_stats":
                         state["model_state"]["frontend"]["batch_stats"]},
            "transformer": p["transformer"], "ctc_lin": p["ctc_lin"],
            "seq_lin": p["seq_lin"], "norm": state["extra"]["norm"]}


def _state(jb):
    p = _pieces(jb)
    return bridge.conformer_asr_state_dict(
        p["frontend"], p["transformer"], p["ctc_lin"], p["seq_lin"], p["norm"])


@pytest.mark.parametrize("attention_type", ATTENTION)
def test_recipe_step_matches_jax(attention_type):
    """One SGD step of ``ConformerASRBrain`` on the transformer encoder
    against the JAX recipe's step; the post-step state compared in the
    port's layout and, through ``bridge.to_jax_conformer_asr``, in JAX's."""
    jb, pb = _brains(attention_type)
    batch = _batch(1)
    jb.step = pb.step = 1
    _loss_close(pb.fit_batch(batch), jb.fit_batch(batch))
    port_sd = {k: v.numpy() for k, v in pb.modules.state_dict().items()}
    jax_sd = {k: v.numpy() for k, v in _state(jb).items()}
    assert port_sd.keys() == jax_sd.keys()
    pairs = [(port_sd, jax_sd),
             (_flat(bridge.to_jax_conformer_asr(pb.modules.state_dict())),
              _flat(_pieces(jb)))]
    for got, ref in pairs:
        assert got.keys() == ref.keys()
        for k in ref:
            dev = float(np.max(np.abs(got[k] - ref[k]))) if ref[k].size else 0
            assert dev <= 1e-5, f"{k}: {dev}"


RECIPE_TOY = dict(
    train_splits=["train-clean-100"], test_splits=["test-clean"],
    vocab_size=40, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
    d_ffn=64, transformer_dropout=0.0, augmentation=None,
    n_warmup_steps=4, number_of_epochs=2, max_batch_length=4.8,
    num_buckets=2, num_workers=0, valid_beam_size=2, test_beam_size=2,
    precision="fp32",
)
RUN_OPTS = {"device": "cpu", "loss_sync_interval": 1, "noprogressbar": True}


def _tree(root):
    data = root / "LibriSpeech"
    recipe.write_synthetic_librispeech(
        str(data), {"train-clean-100": 6, "dev-clean": 2, "test-clean": 2},
        seconds=(1.0, 1.3), n_words=(2, 3), lexicon_size=12, seed=3)
    return str(data)


def test_run_resumes_bit_for_bit(tmp_path):
    """``run(..., hparams=HPARAMS_TRANSFORMER)`` at toy widths trains,
    validates, checkpoints and tests; 1 epoch then a resumed epoch in a
    fresh Brain equals the uninterrupted 2 epochs, bit for bit."""
    data = _tree(tmp_path)

    def build(name, epochs):
        return recipe.build(data, str(tmp_path / name),
                            dict(RECIPE_TOY, **RESUME,
                                 number_of_epochs=epochs),
                            RUN_OPTS, hparams=recipe.HPARAMS_TRANSFORMER)

    assert_resume_matches(build)
    brain = recipe.run(data, str(tmp_path / "full"), RECIPE_TOY, RUN_OPTS,
                       hparams=recipe.HPARAMS_TRANSFORMER)
    assert brain.model.transformer.encoder_module == "transformer"
    assert set(brain.stage_stats) == {"TEST"}
    assert np.isfinite(brain.stage_stats["TEST"]["loss"])


# ------------------------------------------------------------------
# helpers of the recipe tests of this slice (test_torch_kspon.py,
# test_torch_aishell.py, test_torch_switchboard.py)

LOSS_RTOL, GRAD_SHARE = 1e-5, 1e-4
# the conv front end's first kernel: its gradient is a sum of the
# features times the backpropagated error, and the frameworks' Fbank
# features differ by up to 2e-3 dB (tests/test_torch_modules.py)
FEATURE_GRAD_SHARE = 5e-4
# the CRDNN's DNN biases and the conv front end's biases feed a
# training-mode BatchNorm, which removes them: their gradient is 0
# analytically and rounding noise numerically
BATCHNORM_BIAS_FLOOR = 1e-5
CONFORMER_TOY = dict(
    vocab_size=40, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
    d_ffn=64, kernel_size=7, transformer_dropout=0.0, augmentation=None,
    n_warmup_steps=4, number_of_epochs=2, max_batch_length=4.8,
    num_buckets=2, num_workers=0, valid_beam_size=2, test_beam_size=2,
    precision="fp32",
    lm_model=dict(d_model=16, nhead=2, num_encoder_layers=1, d_ffn=32,
                  activation="gelu", normalize_before=False))


def conformer_yaml_toy(encoder_module="conformer",
                       attention_type="RelPosMHAXL", vocab=40):
    """The overrides that bring a transformer recipe's yaml to
    ``CONFORMER_TOY``'s widths (the yamls fix the front end's channels and
    the encoder's input size, so both modules are restated)."""
    return f"""
vocab_size: {vocab}
n_mels: 40
precision: fp32
d_model: 32
nhead: 2
num_encoder_layers: 1
num_decoder_layers: 1
d_ffn: 64
kernel_size: 7
transformer_dropout: 0.0
n_warmup_steps: 4
frontend: !new:speechbrain_tpu.lobes.models.convolution.ConvolutionFrontEnd
    num_blocks: 2
    num_layers_per_block: 1
    out_channels: !tuple [8, 8]
    kernel_sizes: !tuple [[3, 3], [3, 3]]
    strides: !tuple [2, 2]
transformer: !new:speechbrain_tpu.lobes.models.transformer.TransformerASR.TransformerASR
    input_size: 80
    tgt_vocab: !ref <output_neurons>
    d_model: !ref <d_model>
    nhead: !ref <nhead>
    num_encoder_layers: !ref <num_encoder_layers>
    num_decoder_layers: !ref <num_decoder_layers>
    d_ffn: !ref <d_ffn>
    dropout: !ref <transformer_dropout>
    encoder_module: {encoder_module}
    attention_type: {attention_type}
    normalize_before: True
    kernel_size: !ref <kernel_size>
"""


def load_path(name, path):
    """A JAX recipe script (or prepare script) imported by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_yaml(path, overrides, tmp_path):
    """A recipe's yaml through JAX's ``load_hyperpyyaml``, with
    ``overrides`` (yaml text) and the folders in ``tmp_path``."""
    with open(path) as f:
        return load_hyperpyyaml(f, overrides + f"data_folder: {tmp_path}\n"
                                f"output_folder: {tmp_path / 'jax'}\n")


def jax_recipe_brain(script, hp):
    """The JAX script's ``ASR`` Brain on the yaml's modules, without the
    augmentation (the JAX recipes check ``hasattr``)."""
    hp.pop("augmentation", None)
    return script.ASR(modules=hp["modules"],
                      opt_class=lambda lr: hp["opt_class"](learning_rate=lr),
                      hparams=hp, run_opts={"noprogressbar": True})


def _jax_batch(host):
    jbatch = {k: jnp.asarray(v) for k, v in host.items()
              if np.asarray(v).dtype != object}
    if "batch_mask" not in jbatch:
        rows = host["sig"] if "sig" in host else host["tokens"]
        jbatch["batch_mask"] = jnp.ones(rows.shape[0], jnp.float32)
    return jbatch


def assert_step_matches(pb, jb, batch, params, model_state, extra,
                        to_jax_grads, grad_share=GRAD_SHARE):
    """One training-mode loss and its gradients: the port's Brain ``pb``
    on ``batch`` (a ``PaddedBatch`` of its loader) against the JAX
    recipe's ``_loss_fn`` at the same weights (``params``,
    ``model_state``, ``extra`` in JAX's layout); ``to_jax_grads`` maps the
    port's gradient state_dict to JAX's params layout.  Loss within
    ``LOSS_RTOL``; each gradient within ``grad_share`` of its tensor's
    largest (the conv front end's first kernel: ``FEATURE_GRAD_SHARE``)
    plus 1e-6 of the largest overall (the biases that feed a
    training-mode BatchNorm: ``BATCHNORM_BIAS_FLOOR``)."""
    from speechbrain_tpu.core import Stage as JStage
    from speechbrain_tpu_torch.core import Stage

    from .test_torch_kernels import jax_value_and_grad

    host = batch.numeric_dict()
    jbatch = _jax_batch(host)
    rngs = jb._make_step_rngs(jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(jnp.asarray, (params, model_state, extra))

    def loss_fn(p):
        loss, (_, _, new_extra) = jb._loss_fn(p, state[1], state[2], jbatch,
                                              rngs, JStage.TRAIN)
        return loss, new_extra

    (jloss, _), jgrads = jax_value_and_grad(loss_fn)(state[0])
    saved = {k: v.clone() for k, v in pb.modules.state_dict().items()}
    pb.modules.train()
    pb.modules.zero_grad(set_to_none=True)
    tb = pb.prepare_batch(batch)
    loss = pb.compute_objectives(pb.compute_forward(tb, Stage.TRAIN), tb,
                                 Stage.TRAIN)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(
        float(jloss))
    grads = dict(pb.modules.state_dict())
    grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in pb.modules.named_parameters()})
    got = to_jax_grads(grads)
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    paths_g = jax.tree_util.tree_leaves_with_path(got)
    paths_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in paths_g] == [k for k, _ in paths_w]
    top = max(float(np.abs(w).max()) for _, w in paths_w)
    for (path, g), (_, w) in zip(paths_g, paths_w):
        key = jax.tree_util.keystr(path)
        share = max(FEATURE_GRAD_SHARE if "Conv2d_0" in key else 0,
                    grad_share)
        before_bn = "bias" in key and ("dnn_" in key or "Conv2d_" in key)
        floor = BATCHNORM_BIAS_FLOOR if before_bn else 1e-6
        np.testing.assert_allclose(
            g, w, rtol=0, atol=share * float(np.abs(w).max()) + floor * top,
            err_msg=key)
    pb.modules.load_state_dict(saved)
    return float(loss.detach())


def conformer_jax_state(pb):
    """The port's conformer Brain's weights as the JAX recipe's
    ``(params, model_state, extra)``, and the map of its gradients."""
    p = bridge.to_jax_conformer_asr(pb.modules.state_dict())

    def grads(sd):
        g = bridge.to_jax_conformer_asr(sd)
        return {"frontend": g["frontend"]["params"],
                "transformer": g["transformer"], "ctc_lin": g["ctc_lin"],
                "seq_lin": g["seq_lin"]}

    params = grads(pb.modules.state_dict())
    return (params, {"frontend": {"batch_stats":
                                  p["frontend"]["batch_stats"]}},
            {"norm": p["norm"]}, grads)


def crdnn_jax_state(pb):
    """The same for the CRDNN seq2seq Brains."""
    def pieces(sd):
        return bridge.to_jax_crdnn_seq2seq(sd)

    p = pieces(pb.modules.state_dict())

    def grads(sd):
        g = pieces(sd)
        return {"enc": g["enc"]["params"],
                **{k: g[k] for k in ("emb", "dec", "ctc_lin", "seq_lin")}}

    return (grads(pb.modules.state_dict()),
            {"enc": {"batch_stats": p["enc"]["batch_stats"]}},
            {"norm": p["norm"]}, grads)


def assert_yaml_values(y, hp, min_shared, skip=()):
    """The plain values (numbers, strings, lists) that a loaded yaml ``y``
    and the port's dict ``hp`` share are equal; at least ``min_shared``
    are compared."""
    shared = [k for k in hp if k in y and k not in skip
              and isinstance(y[k], (int, float, str, list, tuple, bool))]
    assert len(shared) >= min_shared, shared
    for key in shared:
        want = hp[key]
        got = tuple(y[key]) if isinstance(y[key], list) else y[key]
        assert got == (tuple(want) if isinstance(want, list) else want), key


def assert_transformer_yaml(y, hp):
    """The yaml's ``transformer``, front end, ``lm_model`` (when it has
    one) and ``augmentation`` (or its absence) against ``hp``."""
    t = y["transformer"]
    assert (t.encoder_module, t.attention_type, t.d_model, t.nhead,
            t.num_encoder_layers, t.num_decoder_layers, t.d_ffn, t.dropout,
            t.activation, t.normalize_before, t.input_size, t.tgt_vocab,
            t.kernel_size) == (
        hp["encoder_module"], hp["attention_type"], hp["d_model"],
        hp["nhead"], hp["num_encoder_layers"], hp["num_decoder_layers"],
        hp["d_ffn"], hp["transformer_dropout"], hp["activation"],
        hp["normalize_before"], hp["input_size"], hp["vocab_size"],
        hp["kernel_size"])
    fe = y["frontend"]
    assert (fe.num_blocks, tuple(fe.out_channels), tuple(fe.strides)) == (
        hp["frontend_blocks"], hp["frontend_channels"],
        hp["frontend_strides"])
    assert y["normalize"].update_until_epoch == hp["update_until_epoch"]
    assert (y["noam_annealing"].lr_initial,
            y["noam_annealing"].n_warmup_steps) == (hp["lr_adam"],
                                                    hp["n_warmup_steps"])
    if "lm_model" in y:
        lm, want = y["lm_model"], hp["lm_model"]
        assert (lm.vocab, lm.d_model, lm.nhead, lm.num_encoder_layers,
                lm.d_ffn, lm.activation, lm.normalize_before) == (
            hp["vocab_size"], want["d_model"], want["nhead"],
            want["num_encoder_layers"], want["d_ffn"], want["activation"],
            want["normalize_before"])
    if hp["augmentation"] is None:
        assert "augmentation" not in y
    else:
        assert_augmentation(y["augmentation"], hp["augmentation"])


def assert_same_files(a, b):
    """The files of folders ``a`` and ``b``: the same names, byte for
    byte."""
    names = sorted(p.name for p in Path(a).iterdir() if p.is_file())
    assert names == sorted(p.name for p in Path(b).iterdir() if p.is_file())
    for name in names:
        assert (Path(a) / name).read_bytes() == (Path(b) / name).read_bytes(), name


# see assert_resume_matches
RESUME = {"grad_accumulation_factor": 1}


def fit(parts):
    """``fit`` a recipe ``build``'s Brain on its loaders; returns it."""
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    return brain


def state_of(brain):
    """Copies of a Brain's module and optimizer state and its rate."""
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        return x

    return (clone(brain.modules.state_dict()),
            clone(brain.optimizer.state_dict()["state"]), brain.lr)


def assert_same_state(a, b):
    """Two ``state_of``s, bit for bit."""
    (ma, oa, lra), (mb, ob, lrb) = a, b
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert oa.keys() == ob.keys()
    for i in oa:
        for k, v in oa[i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob[i][k]))
    assert lra == lrb


def assert_resume_matches(build):
    """``build(folder_name, epochs)`` gives a recipe's ``build`` dict: 2
    uninterrupted epochs, and 1 epoch then a resumed one in a fresh Brain
    on another folder, end in the same state after ``fit``, bit for bit
    (compared before any test stage, which loads the best checkpoint: on
    a tie of the metric, either).  The recipes that accumulate gradients
    run here with ``grad_accumulation_factor`` 1 (``RESUME``): a window
    still open at an epoch's end is not part of a checkpoint, so a
    resumed epoch starts a new one.  Returns the uninterrupted dict."""
    full = build("full", 2)
    want = state_of(fit(full))
    fit(build("half", 1))
    assert_same_state(want, state_of(fit(build("half", 2))))
    return full
