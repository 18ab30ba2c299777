"""The port's beam searcher with its options, and the decoding helpers,
against the JAX package on the CPU.

A toy joint CTC/attention transformer (d_model 32, 2 decoder layers,
vocab 50) and a toy ``TransformerLM`` (d_model 32, 4 heads, 2 layers,
d_ffn 64, gelu) get seeded random weights in the JAX layout (eos
favoured), which reach the port through ``bridge.py``.  Both searchers run on
the same random encoder states (B 3, T 20, relative lengths 1.0, 0.8,
0.55) with beam 4 and CTC weight 0.4.  The JAX searcher steps from the
host (``device_loop=False``, its model calls jitted), which runs the
same step as its ``lax.while_loop``.  Every case must give JAX's stored
hypotheses and lengths exactly and its scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders.ctc import (
    ctc_greedy_decode as j_ctc_greedy_decode,
    filter_ctc_output as j_filter_ctc_output,
)
from speechbrain_tpu.decoders.seq2seq import (
    S2STransformerBeamSearch as JSearch,
    batch_filter_seq2seq_output as j_batch_filter,
    filter_seq2seq_output as j_filter,
    inflate_tensor as j_inflate,
    mask_by_condition as j_mask_by_condition,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JTransformerASR,
)
from speechbrain_tpu.lobes.models.transformer.TransformerLM import (
    TransformerLM as JTransformerLM,
)
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR
from speechbrain_tpu_torch.decoders.ctc import (
    ctc_greedy_decode,
    filter_ctc_output,
)
from speechbrain_tpu_torch.decoders.seq2seq import (
    S2STransformerBeamSearch,
    batch_filter_seq2seq_output,
    filter_seq2seq_output,
    inflate_tensor,
    mask_by_condition,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)

from .test_torch_kernels import one_torch_thread  # noqa: F401

V, D, B, T = 50, 32, 3, 20
BEAM, CTC_WEIGHT = 4, 0.4
LENS = np.array([1.0, 0.8, 0.55], np.float32)
CFG = dict(
    CONFORMER_SMALL, n_mels=40, frontend_channels=(4, 4), input_size=40,
    d_model=D, nhead=2, num_encoder_layers=1, num_decoder_layers=2,
    d_ffn=64, kernel_size=5, vocab_size=V,
)
LM_DIMS = dict(vocab=V, d_model=D, nhead=4, num_encoder_layers=2, d_ffn=64)
RECIPE = dict(ctc_score_mode="full", using_eos_threshold=False,
              length_normalization=True)
# searcher options per case; the LM is fused at 0.6 unless lm_weight is 0
CASES = {
    "lm": {},
    "no_lm": {"lm_weight": 0.0},
    "eos_threshold": {"using_eos_threshold": True, "eos_threshold": 1.5},
    "length_rewarding": {"length_normalization": False,
                         "length_rewarding": 0.3},
    "temperatures": {"temperature": 1.5, "temperature_lm": 0.7},
}
TOL = 1e-4


def _random_params(module, rng, *args, **kwargs):
    """Seeded random parameters of ``module.init``'s shapes (traced, not
    run): kernels and embeddings normal / sqrt(fan_in), LayerNorm scales
    1 + 0.1 normal, other leaves 0.1 normal."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

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


@pytest.fixture(scope="module")
def models():
    """JAX weights and model functions, and the port with the same
    weights."""
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    model = JTransformerASR(
        tgt_vocab=V, input_size=CFG["input_size"], d_model=D,
        nhead=CFG["nhead"], num_encoder_layers=1, num_decoder_layers=2,
        d_ffn=64, dropout=0.0, activation="relu", normalize_before=True,
        kernel_size=5, encoder_module="conformer",
        attention_type="RelPosMHAXL",
    )
    tparams = _random_params(model, rng, jnp.zeros((B, 8, CFG["input_size"])),
                             jnp.zeros((B, 3), jnp.int32), train=False)
    ctc_lin, seq_lin = JLinear(n_neurons=V), JLinear(n_neurons=V)
    ctc_p = _random_params(ctc_lin, rng, jnp.asarray(enc))
    seq_p = _random_params(seq_lin, rng, jnp.asarray(enc))
    # a bias toward eos so that beams finish before max_steps
    seq_p = {"Dense_0": dict(seq_p["Dense_0"])}
    seq_p["Dense_0"]["bias"] = seq_p["Dense_0"]["bias"].at[2].add(2.0)
    jlm = JTransformerLM(**LM_DIMS)
    lm_p = _random_params(jlm, rng, jnp.zeros((2, 5), jnp.int32), train=False)

    j_step = jax.jit(lambda tok, cache, pos, el, rows: model.apply(
        {"params": tparams}, tok, cache, pos, el, rows=rows,
        method="decode_step"))
    j_fns = {
        "cache_init_fn": jax.jit(
            lambda e, max_steps: model.apply(
                {"params": tparams}, e, max_steps, method="decode_cache_init"),
            static_argnums=1),
        "step_fn": lambda tok, cache, pos, el, rows=None: j_step(
            tok, cache, pos, el, rows),
        "decode_fn": jax.jit(lambda prefix, e, el: model.apply(
            {"params": tparams}, prefix, e, el, method="decode")[0]),
        "linear_fn": jax.jit(
            lambda d: seq_lin.apply({"params": seq_p}, d[:, None])[:, 0]),
        "ctc_linear_fn": jax.jit(
            lambda e: ctc_lin.apply({"params": ctc_p}, e)),
        "lm_fn": jax.jit(
            lambda prefix: jlm.apply({"params": lm_p}, prefix, train=False)),
    }

    asr = ConformerASR(CFG, device="cpu")
    asr.transformer.load_state_dict(bridge.transformer_asr_state_dict(tparams))
    asr.ctc_lin.load_state_dict(bridge.dense(ctc_p["Dense_0"]))
    asr.seq_lin.load_state_dict(bridge.dense(seq_p["Dense_0"]))
    lm = TransformerLM(**LM_DIMS).eval()
    lm.load_state_dict(bridge.transformer_lm_state_dict(lm_p))
    return {"enc": enc, "j_fns": j_fns, "asr": asr, "lm": lm}


def _options(case):
    opts = dict(RECIPE, **CASES[case])
    opts.setdefault("lm_weight", 0.6)
    return opts


def _jax_searcher(models, opts, buffer=False):
    f = dict(models["j_fns"])
    if buffer:
        f["step_fn"] = f["cache_init_fn"] = None
    else:
        f["decode_fn"] = None
    if opts.get("lm_weight", 0.0) == 0:
        f["lm_fn"] = None
    s = JSearch(**f, bos_index=1, eos_index=2, blank_index=0,
                min_decode_ratio=0.0, max_decode_ratio=1.0,
                beam_size=BEAM, ctc_weight=CTC_WEIGHT, **opts)
    s.device_loop = False
    return s


def _jax_store(models, opts, buffer=False):
    s = _jax_searcher(models, opts, buffer)
    store = s.search_device(jnp.asarray(models["enc"]), jnp.asarray(LENS))
    return [np.asarray(a) for a in store]


def _port_store(models, opts):
    opts = dict(opts)
    lm = models["lm"] if opts.get("lm_weight", 0.0) > 0 else None
    searcher = models["asr"].make_searcher(BEAM, CTC_WEIGHT, lm=lm, **opts)
    store = searcher.search_device(torch.from_numpy(models["enc"]),
                                   torch.from_numpy(LENS))
    return [a.numpy() for a in store]


def _assert_same_store(got, ref):
    seqs, lens, scores = got
    j_seqs, j_lens, j_scores = ref
    assert np.array_equal(lens, j_lens)
    assert np.array_equal(seqs, j_seqs)
    live = j_scores > -1e19
    assert np.array_equal(live, scores > -1e19)
    np.testing.assert_allclose(scores[live], j_scores[live], atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def jax_stores(models):
    return {case: _jax_store(models, _options(case)) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_jax(models, jax_stores, case):
    _assert_same_store(_port_store(models, _options(case)), jax_stores[case])


def test_options_change_the_search(jax_stores):
    """Each option moves the JAX result away from the LM case's, so that
    the cases above hold it to something."""
    base = jax_stores["lm"]
    for case in CASES:
        if case == "lm":
            continue
        ref = jax_stores[case]
        same = all(np.array_equal(a, b) for a, b in zip(ref, base))
        assert not same, case
    # the LM moves the best hypotheses, not only the scores
    assert not np.array_equal(jax_stores["no_lm"][0], base[0])


def test_topk_finalize_matches_jax(models, jax_stores):
    """``topk`` 3: best hypotheses, the top 3 scores and hypotheses."""
    opts = _options("lm")
    j = _jax_searcher(models, dict(opts, topk=3))
    j_best, j_top, j_hyps = j.finalize(*jax_stores["lm"])
    searcher = models["asr"].make_searcher(BEAM, CTC_WEIGHT, lm=models["lm"],
                                           topk=3, **opts)
    best, top, hyps = searcher(torch.from_numpy(models["enc"]),
                               torch.from_numpy(LENS))
    assert best == j_best and hyps == j_hyps
    assert top.shape == (B, 3)
    np.testing.assert_allclose(top, np.asarray(j_top), atol=TOL, rtol=0)


def test_length_rewarding_with_normalization_raises(models):
    with pytest.raises(ValueError, match="length rewarding"):
        models["asr"].make_searcher(BEAM, CTC_WEIGHT, length_rewarding=0.3)


def _port_buffer_searcher(models, opts):
    asr = models["asr"]
    c = asr.config
    return S2STransformerBeamSearch(
        decode_fn=lambda tgt, e, el: asr.transformer.decode(tgt, e, el)[0],
        linear_fn=asr.seq_lin, ctc_linear_fn=asr.ctc_lin,
        lm_fn=models["lm"], bos_index=c["bos_index"],
        eos_index=c["eos_index"], blank_index=c["blank_index"],
        min_decode_ratio=0.0, max_decode_ratio=1.0, beam_size=BEAM,
        ctc_weight=CTC_WEIGHT, **opts)


def test_buffer_path_matches_jax_and_the_cached_path(models, jax_stores):
    """The prefix-buffer decoder (``decode_fn``) against JAX's buffer path
    and against the port's own KV-cached path."""
    opts = _options("lm")
    store = _port_buffer_searcher(models, opts).search_device(
        torch.from_numpy(models["enc"]), torch.from_numpy(LENS))
    store = [a.numpy() for a in store]
    _assert_same_store(store, _jax_store(models, opts, buffer=True))
    _assert_same_store(store, jax_stores["lm"])


def test_lm_step_on_written_prefix_matches_full_buffer(models):
    """The port's LM step runs on ``buf[:, :len]``; JAX's on the whole
    fixed-size buffer.  Over steps with appended tokens and permuted
    rows, its log-probs match JAX's step and the port's LM run over the
    whole buffer, within 1e-5."""
    rng = np.random.default_rng(3)
    n, max_steps = 6, 7
    opts = _options("lm")
    port = _port_buffer_searcher(models, opts)
    port._cur_max_steps, port._device = max_steps, torch.device("cpu")
    jsearch = _jax_searcher(models, opts)
    jsearch._cur_max_steps = max_steps
    mem, jmem = port.reset_lm_mem(n), jsearch.reset_lm_mem(n)
    inp = np.full(n, 1)
    for _ in range(max_steps):
        with torch.no_grad():
            logp, mem = port.lm_forward_step(torch.from_numpy(inp), mem)
        j_logp, jmem = jsearch.lm_forward_step(jnp.asarray(inp), jmem)
        assert mem["buf"].shape == (n, max_steps + 1)
        np.testing.assert_array_equal(mem["buf"].numpy(), np.asarray(jmem["buf"]))
        np.testing.assert_allclose(logp.numpy(), np.asarray(j_logp),
                                   atol=1e-5, rtol=0)
        with torch.no_grad():
            full = models["lm"](mem["buf"])[:, mem["len"] - 1]
        np.testing.assert_allclose(logp.numpy(),
                                   torch.log_softmax(full, -1).numpy(),
                                   atol=1e-5, rtol=0)
        rows = rng.integers(0, n, n)
        mem = {**mem, "buf": mem["buf"][torch.from_numpy(rows)]}
        jmem = {**jmem, "buf": jmem["buf"][jnp.asarray(rows)]}
        inp = rng.integers(3, V, n)


@pytest.mark.parametrize("blank_id", [0, -1, -3])
def test_ctc_greedy_decode_matches_jax(blank_id):
    """Relative lengths whose frame counts round half to even (2.5, 3.5,
    10 x 0.65 = 6.5)."""
    rng = np.random.default_rng(blank_id + 10)
    Tf, C = 10, 6
    logits = rng.standard_normal((4, Tf, C)).astype(np.float32)
    # long runs of one class, so that repeats are merged
    logits[:, 2:5, 1] += 4.0
    lens = np.array([1.0, 0.25, 0.35, 0.65], np.float32)
    ref = j_ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lens),
                              blank_id=blank_id)
    got = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens),
                            blank_id=blank_id)
    assert got == ref
    assert [len(g) for g in got] != [0] * 4


def test_filter_ctc_output_matches_jax():
    for seq, blank in (([0, 0, 1, 1, 0, 2, 2], 0), ([3, 3, 3], 3),
                       ([], 0), ([5, 4, 4, 5, 5, 1], 1), (["a", "a", "-"], "-")):
        assert filter_ctc_output(list(seq), blank) == j_filter_ctc_output(
            list(seq), blank)
    for fn in (filter_ctc_output, j_filter_ctc_output):
        with pytest.raises(ValueError):
            fn((1, 2), 0)


def test_seq2seq_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    for dim in (0, 1):
        np.testing.assert_array_equal(
            inflate_tensor(torch.from_numpy(x), 3, dim).numpy(),
            np.asarray(j_inflate(jnp.asarray(x), 3, dim)))
    cond = rng.random((3, 4)) > 0.5
    np.testing.assert_array_equal(
        mask_by_condition(torch.from_numpy(x), torch.from_numpy(cond),
                          -7.0).numpy(),
        np.asarray(j_mask_by_condition(jnp.asarray(x), jnp.asarray(cond),
                                       -7.0)))
    for seq, eos in (([1, 2, 3, -1, 4], -1), ([1, 2], -1), ([], 2),
                     ([2, 2, 5], 2), (["a", "eos", "b"], "eos")):
        assert filter_seq2seq_output(list(seq), eos) == j_filter(list(seq), eos)
    batch = [[1, 2, 3, 2, 5], [4, 2], [7, 8]]
    assert batch_filter_seq2seq_output(batch, 2) == j_batch_filter(batch, 2)
    for fn in (filter_seq2seq_output, j_filter):
        with pytest.raises(ValueError):
            fn((1, 2), 2)
