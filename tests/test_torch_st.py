"""The speech translation modules against the JAX package: ``TransformerST``
in its six call modes (and ``decode_cache_init``/``decode_step``), with
the transformer encoder (regularMHA) and the conformer encoder
(RelPosMHAXL), its branches built under the JAX conditions;
``ConformerDecoder`` with either attention; ``corpus_bleu`` and
``BLEUStats``; and the bridge's maps both ways.

Parameters come from the JAX modules' ``init`` with the zero-initialised
biases and positional biases replaced by random values, and reach the
port through ``bridge.py``; inputs are numpy arrays from a seed.
Tolerances (float32 on the CPU; sums in other orders):

- every call mode's output: 2e-5 absolute and relative;
- gradients of a weighted sum of the outputs: 2e-4 of each tensor's
  largest gradient, and 1e-5 absolute where the gradient is 0
  analytically and rounding noise numerically (the attention key biases,
  which the softmax removes), as ``test_torch_transformer_encoder_asr.py``
  holds ``TransformerASR``;
- ``ConformerDecoder``'s gradients in float64 (JAX under ``jax.enable_x64``):
  1e-6 of each tensor's largest gradient.  Not tighter: both frameworks
  accumulate the depthwise convolution in float32 (JAX's backward sums
  the taps' gradient over float32 frames; the port's plain version casts
  to float32), so the two float64 runs share float32 rounding there;
- BLEU: 1e-12 absolute (the same float64 arithmetic, in the same order);
- the bridge's round trips: exact.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models.transformer.Conformer import (
    ConformerDecoder as JConformerDecoder,
)
from speechbrain_tpu.lobes.models.transformer.TransformerST import (
    TransformerST as JTransformerST,
)
from speechbrain_tpu.nnet.attention import RelPosEncXL as JRelPosEncXL
from speechbrain_tpu.utils.bleu import BLEUStats as JBLEUStats
from speechbrain_tpu.utils.bleu import corpus_bleu as jcorpus_bleu
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerDecoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerST import (
    TransformerST,
)
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL
from speechbrain_tpu_torch.utils.bleu import BLEUStats, corpus_bleu

from .test_torch_brain import _flat, _randomize
from .test_torch_kernels import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
DIMS = dict(tgt_vocab=24, input_size=20, d_model=32, nhead=2,
            num_encoder_layers=2, num_decoder_layers=2, d_ffn=48)
ENCODERS = {
    "transformer": dict(encoder_module="transformer",
                        attention_type="regularMHA", normalize_before=True),
    "conformer": dict(encoder_module="conformer",
                      attention_type="RelPosMHAXL", normalize_before=True,
                      kernel_size=5),
}
BRANCHES = dict(ctc_weight=0.3, asr_weight=0.3, mt_weight=0.2,
                asr_tgt_vocab=19, mt_src_vocab=17)
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(seed=0, B=2, T=11, L=5, S=6):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, T, DIMS["input_size"])).astype(np.float32)
    tgt = rng.integers(3, DIMS["tgt_vocab"], (B, L)).astype(np.int64)
    tgt[1, -2:] = 0  # padded targets (pad_idx 0)
    asr = rng.integers(3, BRANCHES["asr_tgt_vocab"], (B, L + 1))
    asr[0, -1:] = 0
    mt_src = rng.integers(3, BRANCHES["mt_src_vocab"], (B, S))
    mt_src[1, -3:] = 0
    lens = np.array([1.0, 0.7], np.float32)
    return src, tgt, asr.astype(np.int64), mt_src.astype(np.int64), lens, rng


def _pair(encoder, branches=BRANCHES, seed=0):
    """The JAX module with randomized biases and the port's copy."""
    src, tgt, _, _, lens, rng = _inputs(seed)
    kw = dict(DIMS, **ENCODERS[encoder], **branches)
    jm = JTransformerST(**kw, dropout=0.0)
    params = jm.init(KEY, jnp.asarray(src), jnp.asarray(tgt),
                     jnp.asarray(lens), train=False)["params"]
    params = _randomize(dict(params), rng)
    m = TransformerST(**kw, dropout=0.0).eval()
    m.load_state_dict(bridge.transformer_st_state_dict(params))
    return jm, params, m


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_every_call_mode_matches_jax(encoder):
    """``forward``, ``encode``, ``decode``, ``forward_asr`` (over
    ``forward``'s encoder states, as the Fisher recipe calls it),
    ``forward_mt`` and ``forward_mt_decoder_only`` on padded inputs."""
    jm, params, m = _pair(encoder)
    src, tgt, asr, mt_src, lens, rng = _inputs()
    v = {"params": params}
    j = {}
    j["enc"], j["dec"] = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.asarray(lens), train=False)
    j["raw"] = jm.apply(v, jnp.asarray(src), jnp.asarray(lens),
                        method="encode")
    j["decode"], j["attn"] = jm.apply(v, jnp.asarray(tgt), j["raw"],
                                      jnp.asarray(lens), method="decode")
    j["asr"] = jm.apply(v, j["enc"], jnp.asarray(asr), jnp.asarray(lens), 0,
                        train=False, method="forward_asr")
    j["mt_enc"], j["mt_dec"] = jm.apply(v, jnp.asarray(mt_src),
                                        jnp.asarray(tgt), 0, train=False,
                                        method="forward_mt")
    feats = rng.standard_normal((2, 7, DIMS["d_model"])).astype(np.float32)
    j["only"] = jm.apply(v, jnp.asarray(feats), jnp.asarray(tgt), 0,
                         train=False, method="forward_mt_decoder_only")
    with torch.no_grad():
        got = {}
        got["enc"], got["dec"] = m(_t(src), _t(tgt), _t(lens))
        got["raw"] = m.encode(_t(src), _t(lens))
        got["decode"], got["attn"] = m.decode(_t(tgt), got["raw"], _t(lens))
        got["asr"] = m.forward_asr(got["enc"], _t(asr), _t(lens), 0)
        got["mt_enc"], got["mt_dec"] = m.forward_mt(_t(mt_src), _t(tgt), 0)
        got["only"] = m.forward_mt_decoder_only(_t(feats), _t(tgt), 0)
    assert got.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(got[k].numpy(), _np(j[k]), err_msg=k,
                                   **TOL)
    # under RelPosMHAXL forward's states carry the decoder's PE (the
    # reference's quirk), and forward_asr reads them as they are given
    same = np.array_equal(got["enc"].numpy(), got["raw"].numpy())
    assert same == (encoder == "transformer")


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_cached_steps_match_jax(encoder):
    """``decode_cache_init`` + ``decode_step`` one position at a time
    (the beam's predecessor rows fused into the cache update), against
    JAX's steps and the port's own ``decode`` over the full prefix."""
    jm, params, m = _pair(encoder, seed=1)
    src, tgt, _, _, lens, _ = _inputs(1)
    v = {"params": params}
    j_raw = jm.apply(v, jnp.asarray(src), jnp.asarray(lens), method="encode")
    B, L = tgt.shape
    j_cache = jm.apply(v, j_raw, L, method=lambda mod, e, n: mod.st.
                       decode_cache_init(e, n))
    with torch.no_grad():
        raw = m.encode(_t(src), _t(lens))
        dec, _ = m.decode(_t(tgt), raw, _t(lens))
        cache = m.decode_cache_init(raw, L)
        for c in cache:
            c["alt"] = torch.zeros_like(c["skv"])
        for pos in range(L):
            j_out, j_cache = jm.apply(
                v, jnp.asarray(tgt[:, pos]), j_cache, pos, jnp.asarray(lens),
                method=lambda mod, *a: mod.st.decode_step(*a))
            out, cache = m.decode_step(_t(tgt[:, pos]), cache, pos, _t(lens),
                                       rows=torch.arange(B))
            np.testing.assert_allclose(out.numpy(), _np(j_out), **TOL)
            np.testing.assert_allclose(out.numpy(), dec[:, pos].numpy(),
                                       **TOL)


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_gradients_match_jax(encoder):
    """The gradients of ``sum(w1 enc) + sum(w2 dec) + sum(w3 asr) +
    sum(w4 mt)`` with respect to every parameter (the ST, ASR and MT
    paths at once), held in the port's layout."""
    jm, params, m = _pair(encoder, seed=2)
    src, tgt, asr, mt_src, lens, rng = _inputs(2)
    shapes = [(2, src.shape[1]), (2, tgt.shape[1]), (2, asr.shape[1]),
              (2, tgt.shape[1])]
    w = [rng.standard_normal(s + (DIMS["d_model"],)).astype(np.float32)
         for s in shapes]

    def j_loss(p):
        v = {"params": p}
        enc, dec = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(lens), train=False)
        a = jm.apply(v, enc, jnp.asarray(asr), jnp.asarray(lens), 0,
                     train=False, method="forward_asr")
        _, mt = jm.apply(v, jnp.asarray(mt_src), jnp.asarray(tgt), 0,
                         train=False, method="forward_mt")
        return sum(jnp.sum(x * wi) for x, wi in zip((enc, dec, a, mt), w))

    j_grads = bridge.transformer_st_state_dict(
        jax.jit(jax.grad(j_loss))(params))
    enc, dec = m(_t(src), _t(tgt), _t(lens))
    a = m.forward_asr(enc, _t(asr), _t(lens), 0)
    _, mt = m.forward_mt(_t(mt_src), _t(tgt), 0)
    sum(torch.sum(x * _t(wi)) for x, wi in zip((enc, dec, a, mt), w)
        ).backward()
    got = {k: p.grad for k, p in m.named_parameters()}
    assert got.keys() == j_grads.keys()
    for k, ref in j_grads.items():
        ref = ref.numpy()
        bound = max(2e-4 * float(np.abs(ref).max()), 1e-5)
        dev = float(np.abs(got[k].numpy() - ref).max())
        assert dev <= bound, f"{k}: {dev} > {bound}"


@pytest.mark.parametrize("branches,built", [
    (dict(), set()),  # Taigi: attention-only
    (dict(ctc_weight=0.3, asr_weight=0.3, asr_tgt_vocab=19), {"asr"}),
    (dict(ctc_weight=1.0, asr_weight=0.3, asr_tgt_vocab=19), set()),
    (dict(mt_weight=0.5, mt_src_vocab=17), {"mt"}),
    (BRANCHES, {"asr", "mt"}),
])
def test_branches_follow_the_jax_conditions(branches, built):
    """The ASR branch exists when ``ctc_weight < 1 and asr_weight > 0``,
    the MT branch when ``mt_weight > 0``: the port's parameters are JAX's,
    name for name through the bridge, and round-trip exactly."""
    jm, params, m = _pair("transformer", branches, seed=3)
    names = {"asr": {"asr_decoder", "custom_asr_tgt_module"},
             "mt": {"mt_encoder", "custom_mt_src_module"}}
    want = {"st"}.union(*(names[b] for b in built))
    assert set(params) == want
    assert {k.split(".")[0] for k in m.state_dict()} == want
    back = bridge.to_jax_transformer_st(m.state_dict())
    j_flat, b_flat = _flat(params), _flat(back)
    assert j_flat.keys() == b_flat.keys()
    for k in j_flat:
        np.testing.assert_array_equal(b_flat[k], j_flat[k], err_msg=k)


def test_bridge_round_trips_the_conformer_st():
    """JAX -> port -> JAX on the conformer ST with both branches,
    exactly."""
    _, params, m = _pair("conformer", seed=4)
    back = bridge.to_jax_transformer_st(m.state_dict())
    j_flat, b_flat = _flat(params), _flat(back)
    assert j_flat.keys() == b_flat.keys()
    for k in j_flat:
        np.testing.assert_array_equal(b_flat[k], j_flat[k], err_msg=k)


# ---------------------------------------------------------- ConformerDecoder

DEC = dict(num_layers=2, d_model=16, d_ffn=32, nhead=2, kernel_size=5)


def _dec_pair(attention_type, causal=True, seed=0):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((2, 7, DEC["d_model"])).astype(np.float32)
    T = 7 if attention_type == "RelPosMHAXL" else 9
    mem = rng.standard_normal((2, T, DEC["d_model"])).astype(np.float32)
    mask = np.zeros((2, T), bool)
    mask[1, -2:] = True
    jm = JConformerDecoder(**DEC, causal=causal, dropout=0.0,
                           attention_type=attention_type)
    pos = None
    if attention_type == "RelPosMHAXL":
        pos = np.asarray(JRelPosEncXL(emb_dim=DEC["d_model"]).apply(
            {}, jnp.asarray(mem)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX layer warns non-causal
        params = jm.init(KEY, jnp.asarray(tgt), jnp.asarray(mem),
                         memory_key_padding_mask=jnp.asarray(mask),
                         pos_embs_src=pos, train=False)["params"]
    params = _randomize(dict(params), rng)
    m = ConformerDecoder(**DEC, causal=causal,
                         attention_type=attention_type).eval()
    m.load_state_dict(bridge.conformer_decoder_state_dict(params))
    return jm, params, m, (tgt, mem, mask, pos), rng


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("attention_type", ["regularMHA", "RelPosMHAXL"])
def test_conformer_decoder_matches_jax(attention_type, causal):
    """The output and the attention weights of each layer, with a padded
    memory; with ``causal`` the convolution pads on the left (and
    RelPosMHAXL masks the future positions); the port's positional
    encodings equal JAX's."""
    jm, params, m, (tgt, mem, mask, pos), _ = _dec_pair(attention_type,
                                                        causal)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_out, _, j_attns = jm.apply(
            {"params": params}, jnp.asarray(tgt), jnp.asarray(mem),
            memory_key_padding_mask=jnp.asarray(mask), pos_embs_src=pos,
            train=False)
        with torch.no_grad():
            t_pos = None
            if pos is not None:
                t_pos = RelPosEncXL(DEC["d_model"])(_t(mem))
                np.testing.assert_allclose(t_pos.numpy(), pos, atol=1e-6)
            out, _, attns = m(_t(tgt), _t(mem),
                              memory_key_padding_mask=_t(mask),
                              pos_embs_src=t_pos)
    np.testing.assert_allclose(out.numpy(), _np(j_out), **TOL)
    for a, ja in zip(attns, j_attns):
        np.testing.assert_allclose(a.numpy(), _np(ja), atol=2e-5)
    back = bridge.to_jax_conformer_decoder(m.state_dict())
    j_flat, b_flat = _flat(params), _flat(back)
    assert j_flat.keys() == b_flat.keys()
    for k in j_flat:
        np.testing.assert_array_equal(b_flat[k], j_flat[k], err_msg=k)


@pytest.mark.parametrize("attention_type", ["regularMHA", "RelPosMHAXL"])
def test_conformer_decoder_gradients_float64(attention_type, monkeypatch):
    """The gradients of a weighted sum of the causal decoder's output with
    respect to every parameter and both inputs, float64 on both sides."""
    jm, params, m, (tgt, mem, mask, pos), rng = _dec_pair(attention_type,
                                                          seed=1)
    w = rng.standard_normal(tgt.shape)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     params)
        pos64 = None if pos is None else jnp.asarray(pos, jnp.float64)

        def j_loss(p, x, y):
            out, _, _ = jm.apply({"params": p}, x, y,
                                 memory_key_padding_mask=jnp.asarray(mask),
                                 pos_embs_src=pos64, train=False)
            return jnp.sum(out * w)

        jg, jgx, jgy = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
            p64, jnp.asarray(tgt, jnp.float64),
            jnp.asarray(mem, jnp.float64))
        jg = jax.tree_util.tree_map(np.asarray, jg)
    # the bridge's layout changes (transposes, renames) in float64
    monkeypatch.setattr(bridge, "_t", lambda a: torch.from_numpy(
        np.array(a, dtype=np.float64)))
    want = {k: v.numpy() for k, v in
            bridge.conformer_decoder_state_dict(jg).items()}
    want["tgt"], want["memory"] = np.asarray(jgx), np.asarray(jgy)
    m = m.double()
    x = _t(tgt).double().requires_grad_()
    y = _t(mem).double().requires_grad_()
    t_pos = None if pos is None else RelPosEncXL(DEC["d_model"])(y)
    out, _, _ = m(x, y, memory_key_padding_mask=_t(mask), pos_embs_src=t_pos)
    torch.sum(out * torch.from_numpy(w)).backward()
    got = {k: p.grad.numpy() for k, p in m.named_parameters()}
    got["tgt"], got["memory"] = x.grad.numpy(), y.grad.numpy()
    assert got.keys() == want.keys()
    for k, ref in want.items():
        assert got[k].dtype == ref.dtype == np.float64, k
        bound = 1e-6 * float(np.abs(ref).max()) + 1e-12
        dev = float(np.abs(got[k] - ref).max())
        assert dev <= bound, f"{k}: {dev} > {bound}"


# -------------------------------------------------------------------- BLEU


def _random_corpus(rng, n, vocab=6):
    def seg():
        return [f"w{int(i)}" for i in rng.integers(0, vocab,
                                                  rng.integers(0, 9))]
    hyps = [seg() for _ in range(n)]
    refs = [[seg() for _ in range(rng.integers(1, 4))] for _ in range(n)]
    for r in refs:  # at least one non-empty reference a segment
        r[0] = r[0] or ["w0"]
    return hyps, refs


@pytest.mark.parametrize("seed", range(6))
def test_corpus_bleu_matches_jax(seed):
    """Seeded corpora of 1-12 segments over a 6-token vocabulary: empty
    hypotheses, segments shorter than 4, 1-3 references a segment; the
    BLEU, precisions, brevity penalty and lengths equal JAX's."""
    rng = np.random.default_rng(seed)
    hyps, refs = _random_corpus(rng, int(rng.integers(1, 13)))
    got, want = corpus_bleu(hyps, refs), jcorpus_bleu(hyps, refs)
    assert got.keys() == want.keys()
    for k in ("BLEU", "BP"):
        assert abs(got[k] - want[k]) <= 1e-12, k
    np.testing.assert_allclose(got["precisions"], want["precisions"],
                               rtol=0, atol=1e-12)
    assert (got["hyp_len"], got["ref_len"]) == (want["hyp_len"],
                                                want["ref_len"])


def test_corpus_bleu_edge_cases():
    """Short segments use the orders they have; an empty hypothesis has
    no n-grams; the closest reference length decides the brevity penalty,
    the shorter one on a tie; a perfect match is 100."""
    short = [["a", "b"]], [[["a", "b"]]]
    assert corpus_bleu(*short)["BLEU"] == pytest.approx(100.0)
    assert corpus_bleu(*short)["precisions"][2:] == [0.0, 0.0]
    empty = [[]], [[["a", "b", "c"]]]
    assert corpus_bleu(*empty)["BLEU"] == 0.0 == jcorpus_bleu(*empty)["BLEU"]
    tie = corpus_bleu([["a", "b", "c"]], [[["a", "b"], ["a", "b", "c", "d"]]])
    assert tie["ref_len"] == 2 and tie["BP"] == 1.0
    for case in (short, empty):
        assert corpus_bleu(*case) == jcorpus_bleu(*case)


def test_bleu_stats_match_jax(tmp_path):
    """``BLEUStats`` appended batch by batch (a list of references a
    segment) summarizes and writes what JAX's does."""
    rng = np.random.default_rng(9)
    hyps, refs = _random_corpus(rng, 10)
    port, jax_stats = BLEUStats(), JBLEUStats()
    for lo in range(0, 10, 4):
        ids = [str(i) for i in range(lo, min(lo + 4, 10))]
        for s in (port, jax_stats):
            s.append(ids, hyps[lo:lo + 4], refs[lo:lo + 4])
    assert port.summarize("BLEU") == jax_stats.summarize("BLEU")
    assert port.summarize() == jax_stats.summarize()
    for s, name in ((port, "port"), (jax_stats, "jax")):
        with open(tmp_path / name, "w") as f:
            s.write_stats(f)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()
    assert (tmp_path / "port").read_text().startswith("BLEU: ")
