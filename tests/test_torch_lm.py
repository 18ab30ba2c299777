"""The port's transformer LM and its pieces against the JAX package on
the CPU: ``PositionalwiseFeedForward`` with each activation,
``TransformerEncoderLayer``/``TransformerEncoder`` (pre- and post-norm,
with and without a causal mask and key padding), ``TransformerLM``
logits, and the weight bridge's round trip.

Toy size: vocab 50, d_model 32, 4 heads, 2 layers, d_ffn 64.  Parameters
are seeded random values of the JAX modules' shapes (biases and
LayerNorm scales included, so they matter) and reach the port through
``bridge.py``; inputs are numpy arrays from seed 0.  Outputs are
f32 on both sides and must agree within 1e-5 (max abs error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models.transformer.Transformer import (
    TransformerEncoder as JEncoder,
    TransformerEncoderLayer as JEncoderLayer,
    get_key_padding_mask as j_kpm,
    get_lookahead_mask as j_lookahead,
)
from speechbrain_tpu.lobes.models.transformer.TransformerLM import (
    TransformerLM as JTransformerLM,
)
from speechbrain_tpu.nnet.attention import (
    PositionalwiseFeedForward as JFFN,
    RelPosEncXL as JRelPosEnc,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoder,
    TransformerEncoderLayer,
    get_key_padding_mask,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.nnet.attention import (
    PositionalwiseFeedForward,
    RelPosEncXL,
)

from .test_torch_kernels import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
VOCAB, D, H, LAYERS, D_FFN = 50, 32, 4, 2, 64
TOL = 1e-5


def _random_params(module, rng, *args, **kwargs):
    """Seeded random parameters of ``module.init``'s shapes (traced, not
    run): kernels and embeddings normal / sqrt(fan_in), LayerNorm scales
    1 + 0.1 normal, other leaves (biases, positional biases) 0.1 normal."""
    shapes = jax.eval_shape(
        lambda: module.init(KEY, *args, train=False, **kwargs))

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(a.shape)
        if "kernel" in name or "embedding" in name:
            x = x / np.sqrt(a.shape[-2] if "kernel" in name else a.shape[-1])
        elif "scale" in name:
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)["params"]


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("activation", ["relu", "gelu", "swish", "leaky_relu"])
def test_ffn_activations_match_jax(activation):
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((2, 7, D))).astype(np.float32)
    jm = JFFN(d_ffn=D_FFN, activation=activation)
    params = _random_params(jm, rng, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x), train=False)
    ffn = PositionalwiseFeedForward(D_FFN, D, activation)
    ffn.load_state_dict(bridge.ffn(params))
    _close(ffn(torch.from_numpy(x)), ref)


def test_ffn_rejects_unknown_activation():
    with pytest.raises(ValueError, match="Unknown activation"):
        PositionalwiseFeedForward(D_FFN, D, "tanh")


def _masks(with_mask, with_padding, T):
    lens = np.array([1.0, 0.6], np.float32)
    jm = j_lookahead(T) if with_mask else None
    tm = get_lookahead_mask(T) if with_mask else None
    jp = j_kpm(jnp.asarray(lens), T) if with_padding else None
    tp = get_key_padding_mask(torch.from_numpy(lens), T) if with_padding else None
    return jm, jp, tm, tp


@pytest.mark.parametrize("with_padding", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches_jax(normalize_before, with_mask, with_padding):
    """The two-layer stack with its final norm (applied in post-norm too)."""
    rng = np.random.default_rng(0)
    T = 9
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    jm, jp, tm, tp = _masks(with_mask, with_padding, T)
    je = JEncoder(num_layers=LAYERS, nhead=H, d_ffn=D_FFN, d_model=D,
                  activation="gelu", normalize_before=normalize_before)
    params = _random_params(je, rng, jnp.asarray(x))
    ref, _ = je.apply({"params": params}, jnp.asarray(x), src_mask=jm,
                      src_key_padding_mask=jp, train=False)
    enc = TransformerEncoder(LAYERS, H, D_FFN, D, activation="gelu",
                             normalize_before=normalize_before)
    sd = {f"layers.{i}.{k}": v
          for i in range(LAYERS)
          for k, v in bridge.encoder_layer(params[f"layer_{i}"]).items()}
    sd.update({f"norm_out.{k}": v
               for k, v in bridge.layer_norm(params["norm_out"]).items()})
    enc.load_state_dict(sd)
    out, attns = enc(torch.from_numpy(x), src_mask=tm, src_key_padding_mask=tp)
    assert len(attns) == LAYERS
    _close(out, ref)


@pytest.mark.parametrize("attention_type", ["regularMHA", "RelPosMHAXL"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_jax(normalize_before, attention_type):
    """One layer with a causal mask and key padding, and its attention
    weights (regularMHA: averaged over heads, as in JAX)."""
    rng = np.random.default_rng(1)
    T = 8
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    jm, jp, tm, tp = _masks(True, True, T)
    jpe = tpe = None
    if attention_type == "RelPosMHAXL":
        jpe = JRelPosEnc(emb_dim=D)(jnp.asarray(x))
        tpe = RelPosEncXL(D)(torch.from_numpy(x))
    jl = JEncoderLayer(d_ffn=D_FFN, nhead=H, d_model=D, activation="relu",
                       normalize_before=normalize_before,
                       attention_type=attention_type)
    params = _random_params(jl, rng, jnp.asarray(x), jm, jp, jpe)
    ref, ref_w = jl.apply({"params": params}, jnp.asarray(x), jm, jp, jpe,
                          train=False)
    layer = TransformerEncoderLayer(D_FFN, H, D, activation="relu",
                                    normalize_before=normalize_before,
                                    attention_type=attention_type)
    layer.load_state_dict(bridge.encoder_layer(params))
    out, w = layer(torch.from_numpy(x), src_mask=tm, src_key_padding_mask=tp,
                   pos_embs=tpe)
    _close(out, ref)
    _close(w, ref_w)


LM_CASES = {
    "gelu": {"activation": "gelu"},
    "relu": {"activation": "relu"},
    "gelu_prenorm_d_embedding": {"activation": "gelu",
                                 "normalize_before": True, "d_embedding": 16},
}


def _jax_lm(case, rng):
    kw = LM_CASES[case]
    jlm = JTransformerLM(vocab=VOCAB, d_model=D, nhead=H,
                         num_encoder_layers=LAYERS, d_ffn=D_FFN, **kw)
    tokens = rng.integers(0, VOCAB, (3, 11))
    return jlm, _random_params(jlm, rng, jnp.asarray(tokens)), tokens, kw


@pytest.mark.parametrize("case", list(LM_CASES))
def test_transformer_lm_logits_match_jax(case):
    rng = np.random.default_rng(0)
    jlm, params, tokens, kw = _jax_lm(case, rng)
    ref = jlm.apply({"params": params}, jnp.asarray(tokens), train=False)
    lm = TransformerLM(VOCAB, D, H, LAYERS, D_FFN, **kw).eval()
    lm.load_state_dict(bridge.transformer_lm_state_dict(params))
    got = lm(torch.from_numpy(tokens))
    assert got.shape == (3, 11, VOCAB) and got.dtype == torch.float32
    _close(got, ref)


def test_transformer_lm_bfloat16_runs():
    """In bf16 the LM's logits stay within a few bf16 ulps of JAX's f32
    ones (|logit| < 8: ulp 0.03125)."""
    rng = np.random.default_rng(0)
    jlm, params, tokens, kw = _jax_lm("gelu", rng)
    ref = np.asarray(jlm.apply({"params": params}, jnp.asarray(tokens),
                               train=False))
    lm = TransformerLM(VOCAB, D, H, LAYERS, D_FFN, **kw).eval()
    lm.load_state_dict(bridge.transformer_lm_state_dict(params))
    got = lm(torch.from_numpy(tokens), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.abs(ref).max() < 8
    np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=0.125,
                               rtol=0)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_transformer_lm_bridge_round_trip(case):
    """JAX params -> state_dict -> JAX params, and state_dict -> JAX ->
    state_dict, are the identity (every key both ways)."""
    rng = np.random.default_rng(0)
    _, params, _, kw = _jax_lm(case, rng)
    sd = bridge.transformer_lm_state_dict(params)
    back = bridge.to_jax_transformer_lm(sd)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        assert np.array_equal(np.asarray(leaf), flat_back[path]), path
    lm = TransformerLM(VOCAB, D, H, LAYERS, D_FFN, **kw)
    assert set(sd) == set(lm.state_dict())
    sd2 = bridge.transformer_lm_state_dict(
        bridge.to_jax_transformer_lm(lm.state_dict()))
    assert set(sd2) == set(sd)
    for k, v in lm.state_dict().items():
        assert torch.equal(sd2[k], v), k
