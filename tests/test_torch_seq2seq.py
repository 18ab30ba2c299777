"""The attentional RNN seq2seq family on the port, against the JAX package
on the CPU: the single-step cells, the three RNN attentions, the 3 x 3
``AttentionalRNNDecoder`` grid, the ``RNNLM`` and the RNN searchers with
the options that act on attention weights.

Seeded random JAX parameters (``_random_params``) reach the port through
``bridge.py``; inputs come from numpy.  Tolerances: float32 forwards
within 1e-5 (absolute, the values are O(1)); float32 gradients within
1e-4 of each tensor's largest magnitude plus 1e-6 of the largest over
all tensors (the decoder's loop sums over steps in another order than
``nn.scan``'s; the floor holds gradients that are zero but for
rounding); searches: JAX's stored
hypotheses and lengths exactly, scores within 1e-4.  The beam searches
are held to JAX's device loop (``lax.while_loop``), but the LM-fused one,
whose recipe step grows its prefix: JAX's device loop refuses it
(``test_jax_device_loop_refuses_the_growing_lm_prefix``), so it is held
to JAX's host loop, which runs the same step.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders.seq2seq import (
    S2SRNNBeamSearcher as JBeam,
    S2SRNNBeamSearchLM as JBeamLM,
    S2SRNNGreedySearcher as JGreedy,
)
from speechbrain_tpu.lobes.models.RNNLM import RNNLM as JRNNLM
from speechbrain_tpu.nnet import RNN as JRNN
from speechbrain_tpu.nnet import attention as JAtt
from speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.decoders.seq2seq import (
    S2SRNNBeamSearcher,
    S2SRNNBeamSearchLM,
    S2SRNNGreedySearcher,
)
from speechbrain_tpu_torch.lobes.models.RNNLM import RNNLM
from speechbrain_tpu_torch.nnet import RNN, attention
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.tokenizers.SentencePiece import BPEModel

from .test_torch_kernels import jax_value_and_grad, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
B, T, D_ENC, E, H, A, V = 3, 20, 12, 8, 16, 10, 24
LENS = np.array([1.0, 0.8, 0.55], np.float32)
FWD_TOL, GRAD_SHARE, SCORE_TOL = 1e-5, 1e-4, 1e-4


def _random_params(module, rng, *args, **kwargs):
    """Seeded random parameters of ``module.init``'s shapes (traced, not
    run): kernels and embeddings normal / sqrt(fan_in), LayerNorm scales
    1 + 0.1 normal, other leaves 0.1 normal."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(a.shape)
        if "kernel" in name or "embedding" in name or "_u'" in name:
            x = x / np.sqrt(a.shape[0] if "kernel" in name or "_u'" in name
                            else a.shape[-1])
        elif "scale" in name:
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)["params"]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def _grads_close(got, want):
    """Each leaf within ``GRAD_SHARE`` of its largest magnitude, plus 1e-6
    of the largest over all leaves: a gradient that is zero but for
    roundoff (``KeyValueAttention``'s key bias, which adds a constant to
    each row's scores) has no scale of its own."""
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
    top = max(float(np.abs(w).max()) for _, w in flat_w)
    for (path, g), (_, w) in zip(flat_g, flat_w):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=GRAD_SHARE * scale + 1e-6 * top,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def _torch_grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


# ------------------------------------------------------------ cells

CELLS = {"gru": (JRNN.GRUCell, RNN.GRUCell),
         "lstm": (JRNN.LSTMCell, RNN.LSTMCell),
         "rnn": (JRNN.RNNCell, RNN.RNNCell)}


@pytest.mark.parametrize("kind", list(CELLS))
def test_cells_match_jax(kind):
    """Two layers, three steps from zeros, the state carried: outputs and
    states within 1e-5."""
    jcls, tcls = CELLS[kind]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, B, E)).astype(np.float32)
    jcell = jcls(hidden_size=H, num_layers=2)
    params = _random_params(jcell, rng, jnp.asarray(x[0]), train=False)
    cell = tcls(E, H, num_layers=2).eval()
    cell.load_state_dict(bridge.rnn_cell(params))
    jhx = hx = None
    for step in x:
        jout, jhx = jcell.apply({"params": params}, jnp.asarray(step), jhx,
                                train=False)
        with torch.no_grad():
            out, hx = cell(_t(step), hx)
        _close(out, jout)
        for a, b in zip(jax.tree_util.tree_leaves(hx),
                        jax.tree_util.tree_leaves(jhx)):
            _close(a, b)
    back = bridge.to_jax_rnn_cell(cell.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, np.asarray(b)), back, params))


# ------------------------------------------------------------ attention

ATTENTIONS = {
    "content": (lambda: JAtt.ContentBasedAttention(attn_dim=A, output_dim=H),
                lambda: attention.ContentBasedAttention(D_ENC, H, A, H)),
    "location": (lambda: JAtt.LocationAwareAttention(
                     attn_dim=A, output_dim=H, conv_channels=4, kernel_size=3,
                     scaling=1.5),
                 lambda: attention.LocationAwareAttention(
                     D_ENC, H, A, H, conv_channels=4, kernel_size=3,
                     scaling=1.5)),
    "keyvalue": (lambda: JAtt.KeyValueAttention(attn_dim=A, output_dim=H),
                 lambda: attention.KeyValueAttention(D_ENC, H, A, H)),
}


@pytest.mark.parametrize("kind", list(ATTENTIONS))
def test_rnn_attention_matches_jax(kind):
    """Ragged lengths (1.0, 0.8, 0.55 of 20 frames: 20, 16, 11 valid), two
    steps with the state carried: context, weights (zero past each length)
    and state within 1e-5; then 2 decoder rows an item against JAX on the
    encoder states tiled, as a beam search calls it."""
    jfac, tfac = ATTENTIONS[kind]
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((B, T, D_ENC)).astype(np.float32)
    dec = rng.standard_normal((2, 2 * B, H)).astype(np.float32)
    jatt = jfac()
    params = _random_params(jatt, rng, jnp.asarray(enc), jnp.asarray(LENS),
                            jnp.asarray(dec[0, :B]))
    att = tfac()
    att.load_state_dict(bridge.rnn_attention(params))
    back = bridge.to_jax_rnn_attention(att.state_dict())
    assert back.keys() == params.keys()

    def run_jax(enc_j, lens_j, rows):
        state = jatt.apply({"params": params}, jnp.asarray(enc_j),
                           method="init_state")
        out = []
        for step in dec:
            c, w, state = jatt.apply({"params": params}, jnp.asarray(enc_j),
                                     jnp.asarray(lens_j),
                                     jnp.asarray(step[:rows]), state)
            out.append((c, w, state))
        return out

    for rows in (B, 2 * B):
        g = rows // B
        ref = run_jax(np.repeat(enc, g, 0), np.repeat(LENS, g), rows)
        with torch.no_grad():
            state = att.init_state(_t(enc))
            for step, (jc, jw, jstate) in zip(dec, ref):
                c, w, state = att(_t(enc), _t(LENS), _t(step[:rows]), state)
                _close(c, jc)
                _close(w, jw)
                assert w.dtype == torch.float32
                if kind == "location":
                    _close(state["prev_attn"], jstate["prev_attn"])
    valid = np.arange(T)[None, :] < np.repeat(LENS, 2)[:, None] * T
    assert float(w.numpy()[~valid].max()) == 0.0


def test_length_mask_is_not_rounded():
    """Relative lengths become ``t < lens * T`` unrounded, as in JAX: 0.51
    of 10 frames keeps 6 (5.1), round() would keep 5."""
    lens = np.array([0.51, 0.49, 1.0], np.float32)
    got = attention._length_mask(_t(lens), 10).numpy()
    np.testing.assert_array_equal(got, _np(JAtt._length_mask(
        jnp.asarray(lens), 10)))
    assert got.sum(1).tolist() == [6, 5, 10]


# ------------------------------------------------------------ decoder

GRID = [(r, a) for r in ("gru", "lstm", "rnn")
        for a in ("content", "location", "keyvalue")]


def _decoders(rnn_type, attn_type, rng, inp, enc, num_layers=1):
    jdec = JRNN.AttentionalRNNDecoder(
        rnn_type=rnn_type, attn_type=attn_type, hidden_size=H, attn_dim=A,
        num_layers=num_layers, channels=4, kernel_size=3)
    params = _random_params(jdec, rng, jnp.asarray(inp), jnp.asarray(enc),
                            jnp.asarray(LENS), train=False)
    dec = RNN.AttentionalRNNDecoder(rnn_type, attn_type, H, A, D_ENC, E,
                                    num_layers=num_layers, channels=4,
                                    kernel_size=3).eval()
    dec.load_state_dict(bridge.attentional_rnn_decoder(params))
    return jdec, params, dec


@pytest.mark.parametrize("rnn_type,attn_type", GRID)
def test_decoder_teacher_forced_matches_jax(rnn_type, attn_type):
    """Teacher-forced over U 6: outputs and attention within 1e-5; the
    gradients of a random projection of both (parameters, inputs and
    encoder states) within 1e-4 of each tensor's scale; stepping
    ``forward_step`` from ``attn_init`` and zero states gives the
    teacher-forced outputs."""
    rng = np.random.default_rng(2)
    U = 6
    inp = rng.standard_normal((B, U, E)).astype(np.float32)
    enc = rng.standard_normal((B, T, D_ENC)).astype(np.float32)
    r_out = rng.standard_normal((B, U, H)).astype(np.float32)
    r_att = rng.standard_normal((B, U, T)).astype(np.float32)
    jdec, params, dec = _decoders(rnn_type, attn_type, rng, inp, enc)

    def loss(args):
        p, x, e = args
        out, w = jdec.apply({"params": p}, x, e, jnp.asarray(LENS),
                            train=False)
        return (out * r_out).sum() + (w * r_att).sum(), (out, w)

    (_, (jout, jw)), jgrads = jax_value_and_grad(loss)(
        (params, jnp.asarray(inp), jnp.asarray(enc)))
    x, e = _t(inp).requires_grad_(), _t(enc).requires_grad_()
    out, w = dec(x, e, _t(LENS))
    _close(out.detach(), jout)
    _close(w.detach(), jw)
    ((out * _t(r_out)).sum() + (w * _t(r_att)).sum()).backward()
    got = bridge.to_jax_attentional_rnn_decoder(_torch_grads(dec))
    _grads_close(got, jax.tree_util.tree_map(_np, jgrads[0]))
    _grads_close({"x": x.grad.numpy(), "e": e.grad.numpy()},
                 {"x": _np(jgrads[1]), "e": _np(jgrads[2])})

    with torch.no_grad():
        hs = dec.rnn.init_state(B)
        c = torch.zeros(B, H)
        state = dec.attn_init(_t(enc))
        for u in range(U):
            o, hs, c, wu, state = dec.forward_step(_t(inp[:, u]), hs, c,
                                                   _t(enc), _t(LENS), state)
            torch.testing.assert_close(o, out[:, u].detach(), atol=0, rtol=0)
            torch.testing.assert_close(wu, w[:, u].detach(), atol=0, rtol=0)


def test_decoder_dropout_never_acts_with_one_layer():
    """JAX has no dropout on the cell's input: with the recipe's one layer
    its ``dropout`` never acts (the port copies it), so training mode
    gives the eval outputs; with two layers it acts between them."""
    rng = np.random.default_rng(3)
    inp = _t(rng.standard_normal((B, 4, E)).astype(np.float32))
    enc = _t(rng.standard_normal((B, T, D_ENC)).astype(np.float32))
    for layers, same in ((1, True), (2, False)):
        dec = RNN.AttentionalRNNDecoder("gru", "location", H, A, D_ENC, E,
                                        num_layers=layers, kernel_size=3,
                                        dropout=0.5)
        dec.rnn.drop.generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            train_out = dec.train()(inp, enc, _t(LENS))[0]
            eval_out = dec.eval()(inp, enc, _t(LENS))[0]
        assert torch.equal(train_out, eval_out) == same


# ------------------------------------------------------------ RNNLM

LM_DIMS = dict(output_neurons=V, embedding_dim=E, rnn_layers=2, rnn_neurons=H,
               dnn_blocks=2, dnn_neurons=12)


@pytest.fixture(scope="module")
def lms():
    rng = np.random.default_rng(4)
    jlm = JRNNLM(**LM_DIMS, dropout=0.0)
    params = _random_params(jlm, rng, jnp.zeros((2, 5), jnp.int32),
                            train=False)
    lm = RNNLM(**LM_DIMS, dropout=0.0).eval()
    lm.load_state_dict(bridge.rnnlm_state_dict(params))
    return jlm, params, lm


def test_rnnlm_forward_and_gradients_match_jax(lms):
    """Logits within 1e-5 over (B 3, L 9) tokens, the gradients of a
    random projection within 1e-4 of each tensor's scale; the bridge
    round-trips."""
    jlm, params, lm = lms
    rng = np.random.default_rng(5)
    x = rng.integers(0, V, (B, 9))
    r = rng.standard_normal((B, 9, V)).astype(np.float32)

    def loss(p):
        logits = jlm.apply({"params": p}, jnp.asarray(x), train=False)
        return (logits * r).sum(), logits

    (_, jlogits), jgrads = jax_value_and_grad(loss)(params)
    logits = lm(_t(x))
    _close(logits.detach(), jlogits)
    (logits * _t(r)).sum().backward()
    _grads_close(bridge.to_jax_rnnlm(_torch_grads(lm)),
                 jax.tree_util.tree_map(_np, jgrads))
    back = bridge.to_jax_rnnlm(lm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(_np, params))
    lm.zero_grad()


def test_rnnlm_carried_step_matches_jax_whole_prefix(lms):
    """The port's ``step`` carries (h, c) one token at a time; the JAX
    recipe's ``lm_step_fn`` reruns the whole prefix.  Over 10 tokens (bos
    first), with the rows reordered between steps as a beam search
    reorders them, the log-probs agree at every step within 1e-5.  (JAX
    runs each step's prefixes once, padded to 10 tokens: the LSTM is
    causal, so the padding does not reach the prefix's last position.)"""
    jlm, params, lm = lms
    rng = np.random.default_rng(6)
    n, steps = 5, 10
    prefix = np.zeros((n, 0), np.int64)
    state = {"h": torch.zeros(n, 2, H), "c": torch.zeros(n, 2, H)}
    tokens = np.zeros(n, np.int64)
    padded, got = [], []
    for _ in range(steps):
        prefix = np.concatenate([prefix, tokens[:, None]], 1)
        padded.append(np.pad(prefix, ((0, 0), (0, steps - prefix.shape[1]))))
        with torch.no_grad():
            logits, state = lm.step(_t(tokens), state)
        got.append(torch.log_softmax(logits, -1).numpy())
        rows = rng.integers(0, n, n)
        prefix = prefix[rows]
        state = {k: v[_t(rows)] for k, v in state.items()}
        tokens = rng.integers(0, V, n)
    logits = jlm.apply({"params": params}, jnp.asarray(np.concatenate(padded)),
                       train=False)
    want = jax.nn.log_softmax(logits, -1).reshape(steps, n, steps, V)
    for k in range(steps):
        _close(got[k], want[k, :, k])


def test_rnnlm_honours_hx(lms):
    """``forward(x, hx)`` continues from a state (JAX drops ``hx``): the
    logits of x[:, 4:] from the state after x[:, :4] are those of x."""
    _, _, lm = lms
    x = _t(np.random.default_rng(7).integers(0, V, (2, 9)))
    lm.return_hidden = True
    try:
        with torch.no_grad():
            whole, _ = lm(x)
            _, hidden = lm(x[:, :4])
            rest, _ = lm(x[:, 4:], hidden)
    finally:
        lm.return_hidden = False
    torch.testing.assert_close(rest, whole[:, 4:], atol=1e-6, rtol=0)


# ------------------------------------------------------------ searchers

BEAM = 4
# the recipe's decode options at toy scale (max_attn_shift 240 of 1001
# frames there; 4 of 20 here, so that it acts)
RECIPE_OPTS = dict(eos_threshold=1.5, using_max_attn_shift=True,
                   max_attn_shift=4, coverage_penalty=1.5, temperature=1.25)
CASES = {
    "recipe": dict(RECIPE_OPTS, bos_index=0, eos_index=0, blank_index=0),
    "plain": dict(bos_index=0, eos_index=0, blank_index=0,
                  using_eos_threshold=False),
    "ctc_window": dict(RECIPE_OPTS, bos_index=1, eos_index=2, blank_index=0,
                       ctc_weight=0.4, ctc_window_size=3),
}


@pytest.fixture(scope="module")
def s2s():
    """A toy CRDNN seq2seq head: embedding, GRU + location decoder, the
    two Linear heads (eos biased, so that beams end) in both packages."""
    rng = np.random.default_rng(8)
    enc = rng.standard_normal((B, T, D_ENC)).astype(np.float32)
    inp = rng.standard_normal((B, 2, E)).astype(np.float32)
    jdec, dparams, dec = _decoders("gru", "location", rng, inp, enc)
    jemb = JEmbedding(num_embeddings=V, embedding_dim=E)
    eparams = _random_params(jemb, rng, jnp.zeros((2,), jnp.int32))
    jseq, jctc = JLinear(n_neurons=V), JLinear(n_neurons=V)
    sparams = _random_params(jseq, rng, jnp.zeros((2, H)))
    sparams = {"Dense_0": dict(sparams["Dense_0"])}
    bias = sparams["Dense_0"]["bias"]
    sparams["Dense_0"]["bias"] = bias.at[0].add(1.5).at[2].add(1.5)
    cparams = _random_params(jctc, rng, jnp.zeros((2, D_ENC)))
    emb = Embedding(V, E)
    emb.load_state_dict(bridge.embedding(eparams))
    seq_lin, ctc_lin = Linear(H, V), Linear(D_ENC, V)
    seq_lin.load_state_dict(bridge.dense(sparams["Dense_0"]))
    ctc_lin.load_state_dict(bridge.dense(cparams["Dense_0"]))
    jit_step = jax.jit(lambda e, hs, c, es, el, ast: jdec.apply(
        {"params": dparams}, e, hs, c, es, el, ast, method="forward_step"))
    # every model call jitted: JAX's host loop calls them once a step
    jfns = dict(
        embedding_fn=jax.jit(lambda t: jemb.apply({"params": eparams}, t)),
        decoder_step_fn=jit_step,
        linear_fn=jax.jit(lambda d: jseq.apply({"params": sparams},
                                               d[:, None])[:, 0]),
        dec_hidden_size=H,
        attn_init_fn=jax.jit(lambda es: jdec.apply({"params": dparams}, es,
                                                   method="attn_init")),
        rnn_init_fn=lambda n, dtype: jnp.zeros((1, n, H), dtype),
        ctc_linear_fn=jax.jit(lambda e: jctc.apply({"params": cparams}, e)),
    )
    tfns = dict(embedding_fn=emb, decoder_step_fn=dec.forward_step,
                linear_fn=seq_lin, dec_hidden_size=H,
                attn_init_fn=dec.attn_init, rnn_init_fn=dec.rnn.init_state,
                ctc_linear_fn=ctc_lin)
    return {"enc": enc, "jfns": jfns, "tfns": tfns}


def _store(searcher, enc, torch_side):
    if torch_side:
        return [a.numpy() for a in searcher.search_device(_t(enc), _t(LENS))]
    return [np.asarray(a) for a in searcher.search_device(
        jnp.asarray(enc), jnp.asarray(LENS))]


def _assert_same_store(got, ref):
    seqs, lens, scores = got
    j_seqs, j_lens, j_scores = ref
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_array_equal(seqs, j_seqs)
    live = j_scores > -1e19
    np.testing.assert_array_equal(live, scores > -1e19)
    np.testing.assert_allclose(scores[live], j_scores[live], atol=SCORE_TOL,
                               rtol=0)


def _kwargs(case):
    return dict(CASES[case], min_decode_ratio=0.0, max_decode_ratio=1.0,
                beam_size=BEAM)


@pytest.fixture(scope="module")
def jax_stores(s2s):
    return {case: _store(JBeam(**s2s["jfns"], **_kwargs(case)), s2s["enc"],
                         False) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_rnn_beam_search_matches_jax_device_loop(s2s, jax_stores, case):
    """Coverage, attention shift, temperature and eos threshold (the
    recipe's options), none of them, and the CTC window with CTC weight
    0.4: JAX's device-loop store, token for token."""
    got = _store(S2SRNNBeamSearcher(**s2s["tfns"], **_kwargs(case)),
                 s2s["enc"], True)
    _assert_same_store(got, jax_stores[case])
    assert (got[1] > 0).any()


def test_beam_options_change_the_search(s2s, jax_stores):
    """Each of the recipe's attention options moves JAX's result, so that
    the cases above hold them to something; and the CTC window moves the
    CTC case's."""
    base = jax_stores["recipe"]
    for off in ({"coverage_penalty": 0.0}, {"using_max_attn_shift": False},
                {"temperature": 1.0}):
        kw = dict(_kwargs("recipe"), **off)
        ref = _store(JBeam(**s2s["jfns"], **kw), s2s["enc"], False)
        assert not all(np.array_equal(a, b) for a, b in zip(ref, base)), off
    kw = dict(_kwargs("ctc_window"), ctc_window_size=0)
    ref = _store(JBeam(**s2s["jfns"], **kw), s2s["enc"], False)
    assert not all(np.array_equal(a, b)
                   for a, b in zip(ref, jax_stores["ctc_window"]))


def test_rnn_greedy_search_matches_jax(s2s):
    """Greedy over log-probs (``linear_fn`` gives them, as JAX's greedy
    expects): hypotheses equal, scores within 1e-4."""
    def jlin(d):
        return jax.nn.log_softmax(s2s["jfns"]["linear_fn"](d), -1)

    jf = {k: v for k, v in s2s["jfns"].items() if k != "ctc_linear_fn"}
    tf = {k: v for k, v in s2s["tfns"].items() if k != "ctc_linear_fn"}
    kw = dict(bos_index=1, eos_index=2, min_decode_ratio=0.0,
              max_decode_ratio=1.0)
    jhyps, jscores = JGreedy(**dict(jf, linear_fn=jlin), **kw)(
        jnp.asarray(s2s["enc"]), jnp.asarray(LENS))
    seq_lin = tf["linear_fn"]
    hyps, scores = S2SRNNGreedySearcher(
        **dict(tf, linear_fn=lambda d: torch.log_softmax(seq_lin(d), -1)),
        **kw)(_t(s2s["enc"]), _t(LENS))
    assert hyps == jhyps and any(len(h) for h in hyps)
    _close(scores, jscores, SCORE_TOL)


def _jax_lm_fns(lms, bos_prefix=True):
    """The JAX recipe's LM step (``train.py:149-166``): the token is
    concatenated onto the prefix and the whole prefix rerun.  The recipe's
    prefix starts as [bos] (``bos_prefix``), and the search's first step
    feeds bos again, so the LM's first prediction reads [bos, bos]; the
    port feeds bos once (reference SpeechBrain's ``hx=None`` start), which
    an empty first prefix gives here."""
    jlm, params, _ = lms
    apply = jax.jit(lambda p: jlm.apply({"params": params}, p, train=False))

    def lm_step_fn(tokens, lm_mem):
        prefix = jnp.concatenate([lm_mem, tokens[:, None]], axis=1)
        logits = apply(prefix)
        return jax.nn.log_softmax(logits[:, -1], axis=-1), prefix

    return dict(lm_step_fn=lm_step_fn,
                lm_init_fn=lambda n: jnp.full((n, int(bos_prefix)), 0,
                                              jnp.int32))


def test_rnn_beam_search_lm_matches_jax_host_loop(s2s, lms):
    """LM fusion at the recipe's weight 0.5: the port's carried RNNLM state
    against JAX's host loop over the growing prefix, token for token."""
    jsearch = JBeamLM(**_jax_lm_fns(lms, bos_prefix=False), lm_weight=0.5,
                      **s2s["jfns"], **_kwargs("recipe"))
    jsearch.device_loop = False
    ref = _store(jsearch, s2s["enc"], False)
    lm = lms[2]

    def lm_init_fn(n):
        return {"h": torch.zeros(n, 2, H), "c": torch.zeros(n, 2, H)}

    def lm_step_fn(tokens, mem):
        logits, mem = lm.step(tokens, mem)
        return torch.log_softmax(logits.float(), -1), mem

    got = _store(S2SRNNBeamSearchLM(lm_step_fn=lm_step_fn,
                                    lm_init_fn=lm_init_fn, lm_weight=0.5,
                                    **s2s["tfns"], **_kwargs("recipe")),
                 s2s["enc"], True)
    _assert_same_store(got, ref)
    no_lm = _store(S2SRNNBeamSearcher(**s2s["tfns"], **_kwargs("recipe")),
                   s2s["enc"], True)
    assert not all(np.array_equal(a, b) for a, b in zip(got, no_lm))


def test_jax_device_loop_refuses_the_growing_lm_prefix(s2s, lms):
    """A JAX fault, not copied: ``S2SRNNBeamSearchLM`` inherits
    ``device_loop = True`` and ``static_memory = True``, and the recipe's
    LM step grows its prefix, so ``lax.while_loop`` refuses the carry.
    JAX's recipe can decode with its LM only with ``device_loop = False``."""
    jsearch = JBeamLM(**_jax_lm_fns(lms), lm_weight=0.5, **s2s["jfns"],
                      **_kwargs("recipe"))
    assert jsearch.device_loop and jsearch.static_memory
    with pytest.raises(TypeError, match="lm_memory"):
        jsearch.search_device(jnp.asarray(s2s["enc"]), jnp.asarray(LENS))


def test_jax_recipe_feeds_its_lm_bos_twice(lms):
    """A JAX fault, not copied: the recipe's LM memory starts as [bos]
    and the search's first step feeds bos again, so the fused LM's first
    prediction reads [bos, bos] where the LM was trained on [bos] + tokens
    (``train.py:149-166``).  The port's first LM step reads bos once: the
    LM's log-probs after [bos], not after [bos, bos]."""
    _, _, lm = lms
    fns = _jax_lm_fns(lms)
    lp, prefix = fns["lm_step_fn"](jnp.zeros(2, jnp.int32),
                                   fns["lm_init_fn"](2))
    np.testing.assert_array_equal(_np(prefix), [[0, 0], [0, 0]])
    with torch.no_grad():
        once = torch.log_softmax(lm.step(torch.zeros(2, dtype=torch.long))[0],
                                 -1)
        twice = torch.log_softmax(
            lm(torch.zeros(2, 2, dtype=torch.long))[:, -1], -1)
    _close(twice, lp)
    assert float((once - twice).abs().max()) > 1e-3


def test_lm_yaml_bos_eos_are_word_pieces(tmp_path):
    """A JAX fault, recorded and not copied: ``LM/hparams/RNNLM.yaml``
    trains the fusion LM with bos 1 and eos 2, which the recipes'
    tokenizer (unigram, unk 0, no bos/eos pieces) gives to word pieces,
    while the seq2seq yaml feeds the LM its own bos 0 at the first decode
    step and reads its eos 0 column.  The port's recipe fuses with the
    seq2seq yaml's indices: an LM for it is trained with bos = eos = 0."""
    def index(yaml, key):
        text = (REPO / yaml).read_text()
        return int(re.search(rf"^{key}:\s*(\d+)", text, re.M).group(1))

    lm_yaml, asr_yaml = ("recipes/LibriSpeech/LM/hparams/RNNLM.yaml",
                         "recipes/LibriSpeech/ASR/seq2seq/hparams/"
                         "train_BPE_1000.yaml")
    assert (index(lm_yaml, "bos_index"), index(lm_yaml, "eos_index")) == (1, 2)
    assert (index(asr_yaml, "bos_index"),
            index(asr_yaml, "eos_index")) == (0, 0)
    words = [f"w{i:03d}{'ab' * (i % 5)}" for i in range(300)]
    text = tmp_path / "text.txt"
    text.write_text("\n".join(" ".join(words[j:j + 12])
                              for j in range(0, 288, 6)))
    sp = BPEModel(vocab_size=60, model_type="unigram")
    sp.train(text.read_text().splitlines())
    pieces = [sp.id_to_piece(i) for i in (0, 1, 2)]
    assert pieces[0] == "<unk>"
    assert all(p not in ("<s>", "</s>", "<unk>") for p in pieces[1:]), pieces
