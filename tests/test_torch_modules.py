"""The port's modules against their JAX counterparts on the CPU.

Parameters come from the JAX modules' ``init`` (with the zero-initialised
positional biases and batch statistics replaced by random values so they
matter) and reach the port through ``speechbrain_tpu_torch.bridge``;
inputs are numpy arrays from a seed, fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders.ctc import CTCPrefixScorer as JCTC
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.Conformer import (
    ConformerEncoderLayer as JConformerLayer,
)
from speechbrain_tpu.lobes.models.transformer.Transformer import (
    TransformerDecoder as JDecoder,
    get_key_padding_mask as j_kpm,
    get_lookahead_mask as j_lookahead,
)
from speechbrain_tpu.nnet.attention import (
    RelPosEncXL as JRelPosEnc,
    RelPosMHAXL as JRelPosMHA,
)
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.decoders.ctc import CTCPrefixScorer
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerEncoderLayer,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerDecoder,
    get_key_padding_mask,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL, RelPosMHAXL
from speechbrain_tpu_torch.processing.features import InputNormalization

KEY = jax.random.PRNGKey(0)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _randomize(tree, names, rng, scale=0.1):
    """Replace leaves called ``names`` (zeros at init) by random values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(dict(v), names, rng, scale)
        elif k in names:
            out[k] = jnp.asarray(
                scale * rng.standard_normal(np.shape(v)), jnp.float32
            )
        else:
            out[k] = v
    return out


def test_fbank_with_normalization_matches_jax():
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((2, 12000))).astype(np.float32)
    lens = np.array([1.0, 0.75], np.float32)
    state = {
        "count": np.float32(3.0),
        "mean": (rng.standard_normal(40) - 40.0).astype(np.float32),
        "std": (5.0 + rng.random(40)).astype(np.float32),
    }
    jfeats = JFbank(n_mels=40)(jnp.asarray(wav))
    jy, _ = JInputNorm(norm_type="global")(
        jfeats, jnp.asarray(lens),
        state={k: jnp.asarray(v) for k, v in state.items()}, training=False,
    )
    norm = InputNormalization(40)
    norm.load_state_dict(bridge.input_norm_state_dict(state))
    feats = Fbank(n_mels=40)(_t(wav))
    y = norm(feats, _t(lens))
    # dB of f32 power spectra summed in another order: ~1e-5 dB, / std
    np.testing.assert_allclose(feats.numpy(), _np(jfeats), atol=2e-3, rtol=0)
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=5e-4, rtol=0)


def test_frontend_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 50, 40)).astype(np.float32)
    jfe = JFrontEnd(num_blocks=2, out_channels=(8, 4))
    variables = jfe.init(KEY, jnp.asarray(x), train=False)
    variables = {
        "params": _randomize(dict(variables["params"]), {"bias"}, rng),
        "batch_stats": jax.tree_util.tree_map(
            lambda a: jnp.asarray(0.5 + rng.random(a.shape), jnp.float32),
            dict(variables["batch_stats"]),
        ),
    }
    ref = jfe.apply(variables, jnp.asarray(x), train=False)
    fe = ConvolutionFrontEnd(num_blocks=2, out_channels=(8, 4))
    fe.load_state_dict(bridge.frontend_state_dict(variables))
    fe.eval()
    got = fe(_t(x))
    assert got.shape == ref.shape == (2, 13, 40)
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), atol=1e-5,
                               rtol=1e-5)


def _relpos_inputs(B=2, T=12, d=32, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    lens = np.array([1.0, 0.7], np.float32)
    return x, lens, rng


@pytest.mark.parametrize("mask_pos_future", [False, True])
@pytest.mark.parametrize("with_padding", [False, True])
def test_relpos_mha_matches_jax(mask_pos_future, with_padding):
    x, lens, rng = _relpos_inputs()
    jx = jnp.asarray(x)
    pe = JRelPosEnc(emb_dim=32)(jx)
    kpm = j_kpm(jnp.asarray(lens), x.shape[1]) if with_padding else None
    jm = JRelPosMHA(embed_dim=32, num_heads=2, mask_pos_future=mask_pos_future)
    params = jm.init(KEY, jx, jx, jx, pe)["params"]
    params = _randomize(dict(params), {"pos_bias_u", "pos_bias_v", "bias"}, rng)
    ref, ref_w = jm.apply({"params": params}, jx, jx, jx, pe,
                          key_padding_mask=kpm, train=False)
    m = RelPosMHAXL(32, 2, mask_pos_future=mask_pos_future)
    m.load_state_dict(bridge.relpos_mha(params))
    tx = _t(x)
    tpe = RelPosEncXL(32)(tx)
    np.testing.assert_allclose(tpe.numpy(), _np(pe), atol=1e-6)
    tkpm = get_key_padding_mask(_t(lens), x.shape[1]) if with_padding else None
    if with_padding:
        assert np.array_equal(tkpm.numpy(), np.asarray(kpm))
    with torch.no_grad():
        got, w = m(tx, tx, tx, tpe, key_padding_mask=tkpm)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), _np(ref_w), atol=1e-6)


def test_conformer_encoder_layer_matches_jax():
    x, lens, rng = _relpos_inputs(seed=3)
    jx = jnp.asarray(x)
    pe = JRelPosEnc(emb_dim=32)(jx)
    kpm = j_kpm(jnp.asarray(lens), x.shape[1])
    jl = JConformerLayer(d_model=32, d_ffn=64, nhead=2, kernel_size=7)
    params = jl.init(KEY, jx, None, kpm, pe, False)["params"]
    params = _randomize(
        dict(params),
        {"pos_bias_u", "pos_bias_v", "bias", "depthwise_bias"}, rng,
    )
    ref, _ = jl.apply({"params": params}, jx, None, kpm, pe, False)
    layer = ConformerEncoderLayer(32, 64, 2, kernel_size=7)
    layer.load_state_dict(bridge.conformer_layer(params))
    with torch.no_grad():
        got, _ = layer(_t(x), src_key_padding_mask=torch.from_numpy(
            np.array(kpm)), pos_embs=RelPosEncXL(32)(_t(x)))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_rows", [True, False])
@pytest.mark.parametrize("normalize_before", [True, False])
def test_decoder_full_and_step_match_jax(normalize_before, with_rows):
    rng = np.random.default_rng(4)
    B, L, S, d = 2, 6, 9, 32
    tgt = rng.standard_normal((B, L, d)).astype(np.float32)
    mem = rng.standard_normal((B, S, d)).astype(np.float32)
    mem_lens = np.array([1.0, 0.6], np.float32)
    jd = JDecoder(num_layers=2, nhead=2, d_ffn=64, d_model=d,
                  normalize_before=normalize_before)
    jt, jmem = jnp.asarray(tgt), jnp.asarray(mem)
    jmask = j_kpm(jnp.asarray(mem_lens), S)
    params = jd.init(KEY, jt, jmem, train=False)["params"]
    params = _randomize(dict(params), {"bias"}, rng)
    ref, _, _ = jd.apply({"params": params}, jt, jmem,
                         tgt_mask=j_lookahead(L),
                         memory_key_padding_mask=jmask, train=False)
    dec = TransformerDecoder(2, 2, 64, d, normalize_before=normalize_before)
    sd = {
        f"layers.{i}.{k}": v
        for i in range(2)
        for k, v in bridge.decoder_layer(params[f"layer_{i}"]).items()
    }
    sd.update({f"norm_out.{k}": v
               for k, v in bridge.layer_norm(params["norm_out"]).items()})
    dec.load_state_dict(sd)
    tmask = get_key_padding_mask(_t(mem_lens), S)
    with torch.no_grad():
        full, _, _ = dec(_t(tgt), _t(mem), tgt_mask=get_lookahead_mask(L),
                         memory_key_padding_mask=tmask)
        np.testing.assert_allclose(full.numpy(), _np(ref), atol=1e-5,
                                   rtol=1e-5)
        # step mode, one position at a time, through the fused cache step
        # (identity predecessors, two swapped buffers per layer) or through
        # append_attend (no rows): equals the full output at each position
        cache = dec(None, _t(mem), mode="init_cache", max_steps=L)
        rows = None
        if with_rows:
            for c in cache:
                c["alt"] = torch.zeros_like(c["skv"])
            rows = torch.arange(B)
        for pos in range(L):
            out, cache = dec(_t(tgt[:, pos : pos + 1]), None,
                             memory_key_padding_mask=tmask, mode="step",
                             cache=cache, pos=pos, rows=rows)
            np.testing.assert_allclose(out[:, 0].numpy(), full[:, pos].numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["partial", "full"])
def test_ctc_prefix_scorer_matches_jax(mode):
    rng = np.random.default_rng(5)
    B, beam, T, V = 2, 3, 15, 9
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    x = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = np.array([1.0, 0.7], np.float32)
    n = B * beam
    js = JCTC(jnp.asarray(x), jnp.asarray(lens), B, beam, 0, 2)
    ts = CTCPrefixScorer(_t(x), _t(lens), B, beam, 0, 2)
    jst, tst = js.init_state(), ts.init_state()
    tokens = np.full(n, 1, np.int64)
    for _ in range(4):
        cands = None
        if mode == "partial":
            cands = np.stack([rng.permutation(V)[:5] for _ in range(n)])
        jsc, jst = js.forward_step(
            jnp.asarray(tokens), jst,
            None if cands is None else jnp.asarray(cands, jnp.int32),
        )
        tsc, tst = ts.forward_step(
            torch.from_numpy(tokens), tst,
            None if cands is None else torch.from_numpy(cands),
        )
        jsc, tsc = _np(jsc), tsc.numpy()
        live = jsc > -1e19
        assert np.array_equal(live, tsc > -1e19)
        np.testing.assert_allclose(tsc[live], jsc[live], atol=1e-4, rtol=1e-5)
        # commit a many-to-one choice of candidates
        width = tsc.shape[1]
        pick = rng.integers(0, width, n)
        pred = rng.integers(0, beam, n)
        cand_ids = (np.broadcast_to(np.arange(V), (n, V)) if cands is None
                    else cands)
        rows = np.repeat(np.arange(B), beam) * beam + pred
        tok = cand_ids[rows, pick]
        index = pred * V + tok
        jst = js.permute_mem(jst, jnp.asarray(index))
        tst = ts.permute_mem(tst, torch.from_numpy(index))
        tokens = tok.astype(np.int64)
    np.testing.assert_allclose(tst["psi_prev"].numpy(), _np(jst["psi_prev"]),
                               atol=1e-4, rtol=1e-5)
