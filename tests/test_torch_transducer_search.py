"""The conformer-transducer's decoding and the recipes' test metric,
against the JAX package.

A toy conformer-transducer (one layer, vocab 12, the blank bias raised
so that blank stays in the top-k as in a trained model) is built from
JAX modules and loaded into ``asr.ConformerTransducer`` through
``bridge.conformer_transducer_state_dict``.  On the same encoder states
(numpy), JAX's ``TransducerBeamSearcher`` (its model calls jitted) and
the port's give the same hypotheses: greedy (scores within 1e-5), the
host lockstep beam with and without a toy LM written in both frameworks
(1e-4), the device beam against JAX's jitted one (the same tokens and
lengths, scores within 1e-4), and the starved case with the same
``forced_advance_count``.  Then the port's own invariants (device beam
= host beam, the ``max_symbols`` cap, ties in the top-k, rows that are
done stay as they are), ``transcribe`` end to end, the Brains' test
stage and ``ErrorRateStats``/``edit_distance`` against JAX's.  The JAX
side is computed once per module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders.transducer import (
    TransducerBeamSearcher as JSearcher,
)
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JTransformerASR,
)
from speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu.nnet.RNN import GRU as JGRU
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu.utils import edit_distance as j_edit_distance
from speechbrain_tpu.utils.metric_stats import ErrorRateStats as JErrorRateStats
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import (
    CONFORMER_SMALL,
    CONFORMER_TRANSDUCER,
    ConformerASRBrain,
    ConformerTransducer,
    ConformerTransducerBrain,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.decoders import transducer as pt
from speechbrain_tpu_torch.decoders.transducer import TransducerBeamSearcher
from speechbrain_tpu_torch.utils import edit_distance
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

from .test_torch_kernels import one_torch_thread  # noqa: F401

CFG = dict(
    CONFORMER_TRANSDUCER, n_mels=40, frontend_channels=(4, 4), input_size=40,
    d_model=16, nhead=2, num_encoder_layers=1, d_ffn=32, kernel_size=5,
    vocab_size=12, dec_emb_dim=8, dec_neurons=16, joint_dim=12,
    transformer_dropout=0.0, augmentation=None,
)
V, H_LM = CFG["vocab_size"], 8
BLANK_BIAS = 3.5
ENC_GAIN, PRED_GAIN = 2.0, 0.3


def _jit_pred_net(emb, gru, dec_lin, params):
    """The recipe's ``pred_step`` over JAX modules, each shape jitted."""
    p_emb, p_dec, p_lin = params

    @jax.jit
    def step(tokens, state):
        out, hx = gru.apply({"params": p_dec},
                            emb.apply({"params": p_emb}, tokens[:, None]),
                            hx=jnp.swapaxes(state, 0, 1), train=False)
        return dec_lin.apply({"params": p_lin}, out[:, 0]), jnp.swapaxes(hx, 0, 1)

    @jax.jit
    def start(blank_tok):
        out, hx = gru.apply({"params": p_dec},
                            emb.apply({"params": p_emb}, blank_tok), train=False)
        return dec_lin.apply({"params": p_lin}, out[:, 0]), jnp.swapaxes(hx, 0, 1)

    def pred_step(tokens, state, n):
        if tokens is None:
            return start(jnp.zeros((n, 1), jnp.int32))
        return step(jnp.asarray(tokens, jnp.int32), state)

    return pred_step


def _lm_weights(rng):
    return {"E": (0.8 * rng.standard_normal((V, H_LM))).astype(np.float32),
            "U": (0.4 * rng.standard_normal((H_LM, H_LM))).astype(np.float32),
            "W": (0.8 * rng.standard_normal((H_LM, V))).astype(np.float32)}


def _jax_lm(w):
    """A toy recurrent LM: h = tanh(h U + E[tok]), log_softmax(h W)."""
    E, U, W = (jnp.asarray(w[k]) for k in ("E", "U", "W"))

    @jax.jit
    def step(tokens, h):
        h = jnp.tanh(h @ U + E[tokens])
        return jax.nn.log_softmax(h @ W, axis=-1), h

    def lm_fn(tokens, state):
        tokens = jnp.asarray(tokens, jnp.int32)
        h = jnp.zeros((tokens.shape[0], H_LM)) if state is None else state
        return step(tokens, h)

    return lm_fn


def _port_lm(w):
    E, U, W = (torch.from_numpy(w[k]) for k in ("E", "U", "W"))

    def lm_fn(tokens, state):
        h = torch.zeros(tokens.shape[0], H_LM) if state is None else state
        h = torch.tanh(h @ U + E[tokens])
        return torch.log_softmax(h @ W, -1), h

    return lm_fn


@pytest.fixture(scope="module")
def toy():
    """JAX modules and weights, the port model through the bridge, the
    inputs, and both encoders' outputs."""
    rng = np.random.default_rng(0)
    B = 3
    # noise under an envelope of 0.25 s syllables, so that frames differ
    envelope = 0.02 + np.abs(np.sin(np.pi * np.arange(16000) / 4000.0))
    sig = (0.1 * envelope * rng.standard_normal((B, 16000))).astype(np.float32)
    sig_lens = np.array([1.0, 0.8, 0.55], np.float32)
    norm_state = {
        "count": np.float32(5.0),
        "mean": (rng.standard_normal(40) - 30.0).astype(np.float32),
        "std": (4.0 + 4.0 * rng.random(40)).astype(np.float32),
    }
    fbank, norm = JFbank(n_mels=40), JInputNorm(norm_type="global")
    frontend = JFrontEnd(num_blocks=2, out_channels=CFG["frontend_channels"])
    model = JTransformerASR(
        tgt_vocab=V, input_size=CFG["input_size"], d_model=CFG["d_model"],
        nhead=CFG["nhead"], num_encoder_layers=CFG["num_encoder_layers"],
        num_decoder_layers=0, d_ffn=CFG["d_ffn"], dropout=0.0,
        kernel_size=CFG["kernel_size"], encoder_module="conformer",
        attention_type="RelPosMHAXL")
    enc_lin, dec_lin = (JLinear(n_neurons=CFG["joint_dim"]) for _ in range(2))
    out_lin = JLinear(n_neurons=V)
    emb = JEmbedding(num_embeddings=V, embedding_dim=CFG["dec_emb_dim"])
    gru = JGRU(hidden_size=CFG["dec_neurons"], num_layers=1)

    @jax.jit
    def init(key):
        """Every module's initial variables, in one compiled program."""
        keys = jax.random.split(key, 7)
        feats0 = fbank(jnp.zeros(sig.shape))
        fe_vars = frontend.init(keys[0], feats0, train=False)
        src0 = frontend.apply(fe_vars, feats0, train=False)
        return (fe_vars,
                model.init(keys[1], src0, jnp.zeros((B, 3), jnp.int32),
                           train=False)["params"],
                enc_lin.init(keys[2], jnp.zeros((1, CFG["d_model"]))),
                emb.init(keys[3], jnp.zeros((1, 1), jnp.int32)),
                gru.init(keys[4], jnp.zeros((1, 1, CFG["dec_emb_dim"]))),
                dec_lin.init(keys[5], jnp.zeros((1, CFG["dec_neurons"]))),
                out_lin.init(keys[6], jnp.zeros((1, CFG["joint_dim"]))))

    def rand(tree, scale=0.3):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a + scale * rng.standard_normal(a.shape),
                                 np.float32), jax.device_get(tree))

    fe_vars, tparams, *rest = init(jax.random.PRNGKey(0))
    fe_vars = {"params": fe_vars["params"],
               "batch_stats": jax.tree_util.tree_map(
                   lambda a: np.asarray(0.5 + rng.random(a.shape), np.float32),
                   jax.device_get(fe_vars["batch_stats"]))}
    tparams = rand(tparams, 0.05)
    p_enc_lin, p_emb, p_dec, p_dec_lin, p_out = (
        v["params"] if k == 1 else rand(v["params"])
        for k, v in enumerate(rest))
    # the encoder side leads the joint, as in a trained model
    p_enc_lin = jax.tree_util.tree_map(lambda a: ENC_GAIN * a, p_enc_lin)
    p_dec_lin = jax.tree_util.tree_map(lambda a: PRED_GAIN * a, p_dec_lin)
    p_out["Dense_0"]["bias"][0] += BLANK_BIAS

    @jax.jit
    def encode(sig, sig_lens):
        feats, _ = norm(fbank(sig), sig_lens,
                        state={k: jnp.asarray(v) for k, v in norm_state.items()},
                        training=False)
        src = frontend.apply(fe_vars, feats, train=False)
        enc = model.apply({"params": tparams}, src, sig_lens, method="encode")
        return enc_lin.apply({"params": p_enc_lin}, enc)

    @jax.jit
    def joint(enc, pred):
        return out_lin.apply({"params": p_out}, jnp.tanh(enc + pred))

    pred_step = _jit_pred_net(emb, gru, dec_lin, (p_emb, p_dec, p_dec_lin))
    port = ConformerTransducer(CFG, device="cpu")
    port.load_state_dict(bridge.conformer_transducer_state_dict(
        fe_vars, tparams, p_enc_lin, p_emb, p_dec, p_dec_lin, p_out,
        norm_state))
    j_enc = np.asarray(encode(jnp.asarray(sig), jnp.asarray(sig_lens)))
    p_enc = port.encode(torch.from_numpy(sig), torch.from_numpy(sig_lens))
    return {"sig": sig, "sig_lens": sig_lens, "j_enc": j_enc, "p_enc": p_enc,
            "pred_step": pred_step, "joint": joint, "port": port,
            "lm": _lm_weights(rng)}


def _searchers(toy, **kw):
    port = toy["port"]
    return (JSearcher(toy["pred_step"], toy["joint"], blank_id=0, **kw),
            TransducerBeamSearcher(port.pred_step, port.joint_step, blank_id=0,
                                   **kw))


def _enc(toy):
    return toy["j_enc"], torch.from_numpy(toy["j_enc"])


def test_encoder_matches_jax(toy):
    """The joint's encoder side (``enc_lin`` of the encoder states) and
    the first prediction-network step, f32."""
    np.testing.assert_allclose(toy["p_enc"].numpy(), toy["j_enc"], atol=1e-5,
                               rtol=0)
    j_out, j_state = toy["pred_step"](None, None, 2)
    p_out, p_state = toy["port"].pred_step(None, None, 2)
    assert p_state.shape == j_state.shape == (2, 1, CFG["dec_neurons"])
    np.testing.assert_allclose(p_out.detach().numpy(), j_out, atol=1e-6)
    j_out, _ = toy["pred_step"](np.array([3, 5]), j_state, 2)
    p_out, _ = toy["port"].pred_step(torch.tensor([3, 5]), p_state, 2)
    np.testing.assert_allclose(p_out.detach().numpy(), j_out, atol=1e-6)


def test_greedy_matches_jax(toy):
    """Greedy on the device: the same tokens a frame, scores within 1e-5."""
    j_search, p_search = _searchers(toy, beam_size=1)
    j_enc, p_enc = _enc(toy)
    j_tok, j_scores = j_search.transducer_greedy_decode_device(
        j_enc, toy["sig_lens"])
    p_tok, p_scores = p_search.transducer_greedy_decode_device(
        p_enc, torch.from_numpy(toy["sig_lens"]))
    assert p_tok.tolist() == np.asarray(j_tok).tolist()
    np.testing.assert_allclose(p_scores.numpy(), j_scores, atol=1e-5, rtol=0)
    j_hyps, _ = j_search(j_enc, toy["sig_lens"])
    p_hyps, _ = p_search(p_enc, torch.from_numpy(toy["sig_lens"]))
    assert p_hyps == j_hyps and sum(map(len, p_hyps)) > 0


@pytest.mark.parametrize("beam,with_lm", [(3, False), (4, False), (4, True)])
def test_host_beam_matches_jax(toy, beam, with_lm):
    """The recipe's host lockstep beam (state_beam and expand_beam 2.3),
    with and without a toy LM fused at 0.5: the same hypotheses, scores
    within 1e-4."""
    kw = {"beam_size": beam}
    j_kw, p_kw = dict(kw), dict(kw)
    if with_lm:
        j_kw.update(lm_fn=_jax_lm(toy["lm"]), lm_weight=0.5)
        p_kw.update(lm_fn=_port_lm(toy["lm"]), lm_weight=0.5)
    port = toy["port"]
    j_search = JSearcher(toy["pred_step"], toy["joint"], blank_id=0, **j_kw)
    p_search = TransducerBeamSearcher(port.pred_step, port.joint_step,
                                      blank_id=0, **p_kw)
    j_enc, p_enc = _enc(toy)
    j_hyps, j_scores = j_search(j_enc, toy["sig_lens"])
    p_hyps, p_scores = p_search(p_enc, torch.from_numpy(toy["sig_lens"]))
    assert p_hyps == j_hyps
    assert sum(map(len, p_hyps)) > 0
    np.testing.assert_allclose(p_scores, j_scores, atol=1e-4, rtol=0)
    assert p_search.forced_advance_count == j_search.forced_advance_count == 0


@pytest.fixture(scope="module")
def device_beam(toy):
    """JAX's device beam, jitted on the CPU, and the port's (beam 4, 64
    symbols) on the same encoder states."""
    j_search, p_search = _searchers(toy, beam_size=4)
    j_enc, p_enc = _enc(toy)
    lens = toy["sig_lens"]
    j_out = jax.jit(lambda e, l: j_search.transducer_beam_search_device(
        e, l, max_symbols=64))(j_enc, lens)
    p_out = p_search.transducer_beam_search_device(
        p_enc, torch.from_numpy(lens), max_symbols=64)
    host = p_search.transducer_beam_search_decode(p_enc, torch.from_numpy(lens))
    return [np.asarray(x) for x in j_out], [x.numpy() for x in p_out], host


def test_device_beam_matches_jax(device_beam):
    (j_tok, j_len, j_sc), (p_tok, p_len, p_sc), _ = device_beam
    assert (p_tok == j_tok).all() and (p_len == j_len).all()
    np.testing.assert_allclose(p_sc, j_sc, atol=1e-4, rtol=0)


def test_device_beam_equals_host_beam(device_beam):
    _, (p_tok, p_len, p_sc), (hyps, scores) = device_beam
    assert [p_tok[b, :p_len[b]].tolist() for b in range(len(hyps))] == hyps
    np.testing.assert_allclose(p_sc, scores, atol=1e-4, rtol=0)


def _numpy_net(seed, blank_shift, stateful=False):
    """The JAX unit tests' small nets (embedding, optional recurrence,
    linear joint) in both frameworks."""
    rng = np.random.default_rng(seed)
    Vn, H = 5, 3
    E = (0.5 * rng.standard_normal((Vn, H))).astype(np.float32)
    Uw = (0.3 * rng.standard_normal((H, H))).astype(np.float32)
    W = (0.5 * rng.standard_normal((H, Vn))).astype(np.float32)
    bias = rng.standard_normal((Vn,)).astype(np.float32)
    bias[0] += blank_shift
    enc = (0.7 * rng.standard_normal((2, 4, H))).astype(np.float32)

    def j_pred(tokens, state, n):
        if tokens is None:
            return jnp.asarray(E[0])[None].repeat(n, 0), (
                jnp.zeros((n, H)) if stateful else None)
        if stateful:
            h = jnp.tanh(state @ Uw + jnp.asarray(E)[tokens])
            return h, h
        return jnp.asarray(E)[tokens], None

    tE, tU, tW, tb = map(torch.from_numpy, (E, Uw, W, bias))

    def p_pred(tokens, state, n):
        if tokens is None:
            return tE[0][None].repeat(n, 1), (torch.zeros(n, H) if stateful
                                              else None)
        if stateful:
            h = torch.tanh(state @ tU + tE[tokens])
            return h, h
        return tE[tokens], None

    return (enc, (j_pred, lambda e, p: (e + p) @ jnp.asarray(W) + jnp.asarray(bias)),
            (p_pred, lambda e, p: (e + p) @ tW + tb))


def test_starved_case_matches_jax():
    """``tests/unittests/test_decoders.py``'s blank-starved case (blank
    never in the top-k, valve at 6 expansions a frame): the same
    hypotheses, scores and ``forced_advance_count`` on the host, one
    ``RuntimeWarning`` a searcher, and the device beam's valve gives the
    host's result."""
    enc, (j_pred, j_joint), (p_pred, p_joint) = _numpy_net(5, -8.0)
    kw = {"blank_id": 0, "beam_size": 2, "max_expand_per_frame": 6}
    j_search = JSearcher(j_pred, j_joint, **kw)
    p_search = TransducerBeamSearcher(p_pred, p_joint, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j_hyps, j_scores = j_search.transducer_beam_search_decode(enc)
    with pytest.warns(RuntimeWarning, match="force-advanced"):
        p_hyps, p_scores = p_search.transducer_beam_search_decode(
            torch.from_numpy(enc))
    assert p_hyps == j_hyps
    np.testing.assert_allclose(p_scores, j_scores, atol=1e-5, rtol=0)
    assert p_search.forced_advance_count == j_search.forced_advance_count > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # warned once only
        p_search.transducer_beam_search_decode(torch.from_numpy(enc))
    # the device valve promotes as the host's does
    toks, lens, scores = p_search.transducer_beam_search_device(
        torch.from_numpy(enc), max_symbols=64)
    assert [toks[b, :lens[b]].tolist() for b in range(2)] == p_hyps
    np.testing.assert_allclose(scores.numpy(), p_scores, atol=1e-5, rtol=0)


def test_max_symbols_cap_matches_jax():
    """A token buffer shorter than the hypotheses: lengths stop at the
    cap, later tokens are dropped, and the normalised score divides by
    the capped length, as in JAX."""
    enc, (j_pred, j_joint), (p_pred, p_joint) = _numpy_net(7, 0.5, True)
    j_search = JSearcher(j_pred, j_joint, blank_id=0, beam_size=3)
    p_search = TransducerBeamSearcher(p_pred, p_joint, blank_id=0, beam_size=3)
    hyps, _ = p_search.transducer_beam_search_decode(torch.from_numpy(enc))
    assert max(map(len, hyps)) > 2
    j_out = jax.jit(lambda e: j_search.transducer_beam_search_device(
        e, max_symbols=2))(enc)
    p_out = p_search.transducer_beam_search_device(torch.from_numpy(enc),
                                                   max_symbols=2)
    assert p_out[1].max() == 2
    for p, j in zip(p_out[:2], j_out[:2]):
        assert p.tolist() == np.asarray(j).tolist()
    np.testing.assert_allclose(p_out[2].numpy(), j_out[2], atol=1e-5, rtol=0)


def test_top_k_ties_take_the_lower_index_first():
    """``_top_k`` orders equal values as ``jax.lax.top_k`` does, masked
    -1e30 entries included."""
    x = np.array([[0.5, 2.0, 2.0, -1e30, 2.0, -1e30, -1e30, 0.5],
                  [-1e30] * 8, [1.0, 1.0, 1.0, 1.0, 3.0, 3.0, 0.0, 0.0]],
                 np.float32)
    for k in (1, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = pt._top_k(torch.from_numpy(x), k)
        assert pi.tolist() == np.asarray(ji).tolist()
        assert pv.tolist() == np.asarray(jv).tolist()


def test_tied_scores_match_jax():
    """A joint whose logits tie (tokens 1-3 equal at every frame, and
    their expansions equal in score): the device beam, whose top-k and
    promotion break ties by ``_top_k`` (held to ``jax.lax.top_k`` above),
    gives the host beam's result, which is JAX's."""
    E = np.zeros((5, 4), np.float32)
    E[:, 0] = np.arange(5)
    enc = np.zeros((2, 5, 5), np.float32)
    enc[..., 0] = 1.0      # blank in the top-k
    enc[..., 1:4] = 0.5    # three tied tokens
    enc[1, 2, 4] = 2.0     # and a clear winner at one frame

    def j_pred(tokens, state, n):
        tok = jnp.zeros((n,), jnp.int32) if tokens is None else tokens
        return jnp.asarray(E)[tok], None

    def p_pred(tokens, state, n):
        tok = torch.zeros(n, dtype=torch.long) if tokens is None else tokens
        return torch.from_numpy(E)[tok], None

    j_search = JSearcher(j_pred, lambda e, p: e + 0 * p[..., :1], blank_id=0,
                         beam_size=3)
    p_search = TransducerBeamSearcher(p_pred, lambda e, p: e + 0 * p[..., :1],
                                      blank_id=0, beam_size=3)
    p_out = p_search.transducer_beam_search_device(torch.from_numpy(enc),
                                                   max_symbols=8)
    hyps, scores = p_search.transducer_beam_search_decode(torch.from_numpy(enc))
    j_hyps, j_scores = j_search.transducer_beam_search_decode(enc)
    assert [p_out[0][b, :p_out[1][b]].tolist() for b in range(2)] == hyps
    assert hyps == j_hyps and min(map(len, hyps)) > 0
    np.testing.assert_allclose(p_out[2].numpy(), j_scores, atol=1e-6, rtol=0)
    np.testing.assert_allclose(scores, j_scores, atol=1e-6, rtol=0)


def test_done_rows_stay_unchanged():
    """Rows whose loop condition is false (a zero-length row from the
    start, a row past its frames, a row at its iteration cap) are left
    exactly as they are by later iterations, as the vmapped
    ``while_loop`` leaves them; the live row moves."""
    enc, _, (p_pred, p_joint) = _numpy_net(7, 0.5, True)
    enc = np.concatenate([enc, enc], 0)
    search = TransducerBeamSearcher(p_pred, p_joint, blank_id=0, beam_size=3)
    lens = torch.tensor([0.0, 0.25, 1.0, 1.0])
    c, cap = search._beam_device_init(torch.from_numpy(enc), lens, 8)
    for _ in range(6):
        c = search._beam_device_step(c, torch.from_numpy(enc), cap)
    c["iter"][3] = cap  # row 3 at its cap
    active = search._active(c, cap)
    assert active.tolist() == [False, False, True, False]
    keys = ("t", "done", "nexp", "iter", "beam", "beam_mask", "proc",
            "proc_mask")
    before = {k: pt._tree_map(lambda x: x.clone(), c[k]) for k in keys}
    for _ in range(5):
        c = search._beam_device_step(c, torch.from_numpy(enc), cap)
    for row in (0, 1, 3):
        for key in keys:
            pt._tree_map(lambda a, b: torch.testing.assert_close(
                a[row], b[row], rtol=0, atol=0), c[key], before[key])
    assert int(c["iter"][2]) == int(before["iter"][2]) + 5


def test_device_beam_refuses_an_lm(toy):
    _, p_search = _searchers(toy, beam_size=2)
    p_search.lm_fn, p_search.lm_weight = _port_lm(toy["lm"]), 0.5
    with pytest.raises(NotImplementedError):
        p_search.transducer_beam_search_device(toy["p_enc"])


def test_transcribe_matches_jax(toy):
    """``ConformerTransducer.transcribe`` (encode + the recipe's beam 4)
    against JAX's search on JAX's encoder states: the slice end to end."""
    j_search, _ = _searchers(toy, beam_size=4)
    j_hyps, j_scores = j_search(toy["j_enc"], toy["sig_lens"])
    hyps, scores = toy["port"].transcribe(torch.from_numpy(toy["sig"]),
                                          torch.from_numpy(toy["sig_lens"]))
    assert hyps == j_hyps
    np.testing.assert_allclose(scores, j_scores, atol=1e-4, rtol=0)
    greedy, _ = toy["port"].transcribe(torch.from_numpy(toy["sig"]),
                                       torch.from_numpy(toy["sig_lens"]),
                                       beam_size=1)
    assert greedy == j_search.transducer_greedy_decode(toy["j_enc"],
                                                        toy["sig_lens"])[0]


def _test_batch(B=3, U=5):
    rng = np.random.default_rng(4)
    n_tok = np.array([U, U - 1, U - 2][:B])
    tokens = np.zeros((B, U), np.int64)
    for b, n in enumerate(n_tok):
        tokens[b, :n] = rng.integers(3, V, n)
    return {
        "sig": (0.1 * rng.standard_normal((B, 16000))).astype(np.float32),
        "sig_lens": np.array([1.0, 0.8, 0.6][:B], np.float32), "tokens": tokens,
        "tokens_lens": (n_tok / U).astype(np.float32),
        "tokens_blank": np.concatenate([np.zeros((B, 1), np.int64), tokens], 1),
        "tokens_bos": np.concatenate([np.ones((B, 1), np.int64), tokens], 1),
        "tokens_eos": np.concatenate([tokens, np.full((B, 1), 2)], 1),
        "tokens_eos_lens": ((n_tok + 1) / (U + 1)).astype(np.float32),
    }


def test_transducer_brain_test_stage_scores_the_search(toy):
    """``evaluate_batch(..., Stage.TEST)`` after ``on_stage_start`` runs
    the recipe's search on the batch's encoder side and appends its
    hypotheses against the unpadded targets; VALID does not search."""
    brain = ConformerTransducerBrain(CFG, device="cpu")
    brain.model.load_state_dict(toy["port"].state_dict())
    batch = _test_batch()
    brain.on_stage_start(Stage.VALID)
    brain.evaluate_batch(batch, Stage.VALID)
    assert not hasattr(brain, "wer_metric")
    brain.on_stage_start(Stage.TEST)
    assert brain.searcher.beam_size == 4 and brain.searcher.state_beam == 2.3
    loss = brain.evaluate_batch(batch, Stage.TEST)
    assert np.isfinite(loss)
    hyps, _ = brain.model.transcribe(torch.from_numpy(batch["sig"]),
                                     torch.from_numpy(batch["sig_lens"]))
    ref = JErrorRateStats()
    targets = [list(t[:n]) for t, n in zip(batch["tokens"].tolist(), (5, 4, 3))]
    ref.append(["0", "1", "2"], hyps, targets)
    assert brain.wer_metric.summarize() == ref.summarize()
    assert [d["hyp_tokens"] for d in brain.wer_metric.scores] == hyps


def test_asr_brain_valid_and_test_stages_score_the_search():
    """The conformer recipe searches in validation and test (beam
    ``valid_beam_size``, CTC weight ``ctc_weight_decode``)."""
    cfg = dict(CONFORMER_SMALL, frontend_channels=(4, 4), input_size=40,
               d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
               d_ffn=32, kernel_size=5, vocab_size=V, n_mels=40,
               valid_beam_size=2, augmentation=None)
    brain = ConformerASRBrain(cfg, device="cpu")
    batch = _test_batch(2)
    hyps, _ = brain.model.transcribe(torch.from_numpy(batch["sig"]),
                                     torch.from_numpy(batch["sig_lens"]),
                                     beam_size=2, ctc_weight=0.4)
    for stage in (Stage.VALID, Stage.TEST):
        brain.on_stage_start(stage)
        assert np.isfinite(brain.evaluate_batch(batch, stage))
        assert [d["hyp_tokens"] for d in brain.wer_metric.scores] == hyps
    brain.on_stage_start(Stage.TRAIN)
    assert len(brain.wer_metric.scores) == 2  # TRAIN makes none


SEQS = [
    (["a", "b", "c"], ["a", "x", "c", "d"]),
    ([1, 2, 3, 4], [1, 3, 4]),
    ([], [5]),
    ([7, 7], []),
    ([3, 1, 4, 1, 5], [3, 1, 4, 1, 5]),
]


def test_edit_distance_and_error_rate_stats_match_jax():
    """The copies give JAX's numbers: op tables, alignments, per-utterance
    details, the summary, and ``ErrorRateStats`` with ``merge_tokens``,
    ``split_tokens`` and padded input."""
    for ref, hyp in SEQS:
        assert edit_distance.op_table(ref, hyp) == j_edit_distance.op_table(ref, hyp)
        table = edit_distance.op_table(ref, hyp)
        assert edit_distance.alignment(table) == j_edit_distance.alignment(table)
    ids = [str(i) for i in range(len(SEQS))]
    refs, hyps = [r for r, _ in SEQS], [h for _, h in SEQS]
    got = edit_distance.wer_details_for_batch(ids, refs, hyps, True)
    want = j_edit_distance.wer_details_for_batch(ids, refs, hyps, True)
    assert got == want
    assert edit_distance.wer_summary(got) == j_edit_distance.wer_summary(want)
    for kw in ({}, {"merge_tokens": True}, {"split_tokens": True}):
        ours, theirs = ErrorRateStats(**kw), JErrorRateStats(**kw)
        for stats in (ours, theirs):
            stats.append(ids[:2], [["ab", "_c"], ["d"]], [["ab", "c"], ["d_e"]])
        assert ours.summarize() == theirs.summarize()
    padded = np.array([[1, 2, 3, 0], [4, 5, 0, 0]])
    lens = np.array([0.75, 0.5], np.float32)
    ours, theirs = ErrorRateStats(), JErrorRateStats()
    for stats in (ours, theirs):
        stats.append(["u", "v"], padded, padded[::-1].copy(), lens, lens[::-1])
    assert ours.summarize() == theirs.summarize()
    assert ours.summarize("error_rate") > 0
