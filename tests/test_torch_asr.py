"""The port's serving path as a whole against the JAX package's.

JAX: Fbank -> InputNormalization (global, eval) -> ConvolutionFrontEnd
-> TransformerASR.encode -> S2STransformerBeamSearch.search_device ->
finalize, with the KV-cached ``decode_step`` (with ``rows``), in both
CTC scoring modes: "full" (the recipe's) and "partial" (``bench.py``'s
decode section).  Port: ``ConformerASR.transcribe(device="cpu")`` with
the same weights through ``bridge.py``.  Hypotheses must be identical,
scores and the encoder output within 1e-4.  The JAX side is computed
once per module: its compile dominates the file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders.seq2seq import S2STransformerBeamSearch
from speechbrain_tpu.lobes.features import Fbank as JFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JTransformerASR,
)
from speechbrain_tpu.nnet.linear import Linear as JLinear
from speechbrain_tpu.processing.features import (
    InputNormalization as JInputNorm,
)
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR

from .test_torch_kernels import one_torch_thread  # noqa: F401

CFG = dict(
    CONFORMER_SMALL, n_mels=40, frontend_channels=(8, 8), input_size=80,
    d_model=32, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
    d_ffn=64, kernel_size=7, vocab_size=32,
)
BEAM, CTC_WEIGHT = 4, 0.4
MODES = ("partial", "full")


def _randomize(tree, names, rng, scale):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(dict(v), names, rng, scale)
        elif k in names:
            out[k] = jnp.asarray(scale * rng.standard_normal(np.shape(v)),
                                 jnp.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Inputs, JAX weights and the JAX encoder output and search result."""
    rng = np.random.default_rng(0)
    B = 3
    sig = (0.1 * rng.standard_normal((B, 16000))).astype(np.float32)
    sig_lens = np.array([1.0, 0.8, 0.55], np.float32)
    norm_state = {
        "count": np.float32(5.0),
        "mean": (rng.standard_normal(40) - 30.0).astype(np.float32),
        "std": (4.0 + 4.0 * rng.random(40)).astype(np.float32),
    }
    fbank = JFbank(n_mels=40)
    norm = JInputNorm(norm_type="global")
    frontend = JFrontEnd(num_blocks=2, out_channels=CFG["frontend_channels"])
    model = JTransformerASR(
        tgt_vocab=CFG["vocab_size"], input_size=CFG["input_size"],
        d_model=CFG["d_model"], nhead=CFG["nhead"],
        num_encoder_layers=CFG["num_encoder_layers"],
        num_decoder_layers=CFG["num_decoder_layers"], d_ffn=CFG["d_ffn"],
        dropout=0.0, activation="relu", normalize_before=True,
        kernel_size=CFG["kernel_size"], encoder_module="conformer",
        attention_type="RelPosMHAXL",
    )
    ctc_lin = JLinear(n_neurons=CFG["vocab_size"])
    seq_lin = JLinear(n_neurons=CFG["vocab_size"])
    keys = jax.random.split(jax.random.PRNGKey(0), 4)

    feats0 = fbank(jnp.asarray(sig))
    fe_vars = frontend.init(keys[0], feats0, train=False)
    fe_vars = {
        "params": dict(fe_vars["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda a: jnp.asarray(0.5 + rng.random(a.shape), jnp.float32),
            dict(fe_vars["batch_stats"]),
        ),
    }
    src0 = frontend.apply(fe_vars, feats0, train=False)
    tparams = model.init(keys[1], src0, jnp.zeros((B, 3), jnp.int32),
                         train=False)["params"]
    tparams = _randomize(dict(tparams), {"pos_bias_u", "pos_bias_v"}, rng,
                         0.3)
    enc0 = jnp.zeros((B, 4, CFG["d_model"]))
    ctc_p = ctc_lin.init(keys[2], enc0)["params"]
    seq_p = seq_lin.init(keys[3], enc0)["params"]
    # a bias toward eos so that some beams finish before max_steps
    seq_p = {"Dense_0": dict(seq_p["Dense_0"])}
    seq_p["Dense_0"]["bias"] = seq_p["Dense_0"]["bias"].at[2].add(1.5)

    searchers = {mode: S2STransformerBeamSearch(
        decode_fn=None,
        cache_init_fn=lambda e, max_steps: model.apply(
            {"params": tparams}, e, max_steps, method="decode_cache_init"
        ),
        step_fn=lambda tok, cache, pos, el, rows=None: model.apply(
            {"params": tparams}, tok, cache, pos, el, rows=rows,
            method="decode_step",
        ),
        linear_fn=lambda d: seq_lin.apply({"params": seq_p}, d[:, None])[:, 0],
        ctc_linear_fn=lambda e: ctc_lin.apply({"params": ctc_p}, e),
        bos_index=1, eos_index=2, blank_index=0,
        min_decode_ratio=0.0, max_decode_ratio=1.0, beam_size=BEAM,
        ctc_weight=CTC_WEIGHT, ctc_score_mode=mode,
        using_eos_threshold=False, length_normalization=True,
    ) for mode in MODES}

    @jax.jit
    def run(sig, sig_lens):
        feats, _ = norm(
            fbank(sig), sig_lens,
            state={k: jnp.asarray(v) for k, v in norm_state.items()},
            training=False,
        )
        src = frontend.apply(fe_vars, feats, train=False)
        enc = model.apply({"params": tparams}, src, sig_lens, method="encode")
        return enc, {mode: s.search_device(enc, sig_lens, early_exit=True)
                     for mode, s in searchers.items()}

    enc, stores = run(jnp.asarray(sig), jnp.asarray(sig_lens))
    search = {}
    for mode, store in stores.items():
        hyps, scores = searchers[mode].finalize(*store)
        search[mode] = {"hyps": hyps, "scores": np.array(scores),
                        "store": [np.array(a) for a in store]}
    tgt = rng.integers(3, CFG["vocab_size"], (B, 5)).astype(np.int64)
    dec, _ = model.apply({"params": tparams}, jnp.asarray(tgt), enc,
                         jnp.asarray(sig_lens), method="decode")
    state_dict = bridge.conformer_asr_state_dict(
        fe_vars, tparams, ctc_p, seq_p, norm_state
    )
    return {
        "sig": sig, "sig_lens": sig_lens, "state_dict": state_dict,
        "enc": np.array(enc), "search": search, "tgt": tgt, "dec": np.array(dec),
    }


@pytest.fixture(scope="module")
def port(jax_run):
    """The port with the JAX weights, on the CPU."""
    asr = ConformerASR(CFG, device="cpu")
    asr.load_state_dict(jax_run["state_dict"])
    return asr


def test_encoder_output_matches_jax(jax_run, port):
    enc = port.encode(torch.from_numpy(jax_run["sig"]),
                      torch.from_numpy(jax_run["sig_lens"]))
    assert enc.shape == jax_run["enc"].shape == (3, 26, CFG["d_model"])
    np.testing.assert_allclose(enc.numpy(), jax_run["enc"], atol=1e-4,
                               rtol=0)


def test_full_prefix_decode_matches_jax(jax_run, port):
    """``decode`` over a whole prefix, on the JAX encoder states (the
    abs-sine PE is added to them inside, as in the JAX model)."""
    with torch.no_grad():
        dec, attn = port.transformer.decode(
            torch.from_numpy(jax_run["tgt"]), torch.from_numpy(jax_run["enc"]),
            torch.from_numpy(jax_run["sig_lens"]),
        )
    assert attn.shape == (3, 5, 26)
    np.testing.assert_allclose(dec.numpy(), jax_run["dec"], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_transcribe_matches_jax(jax_run, port, mode):
    ref = jax_run["search"][mode]
    hyps, scores = port.transcribe(
        torch.from_numpy(jax_run["sig"]),
        torch.from_numpy(jax_run["sig_lens"]),
        beam_size=BEAM, ctc_weight=CTC_WEIGHT, ctc_score_mode=mode,
    )
    assert hyps == ref["hyps"]
    assert any(len(h) > 0 for h in hyps)
    np.testing.assert_allclose(scores, ref["scores"], atol=1e-4, rtol=0)


def test_score_modes_differ(jax_run):
    """The two modes give different best hypotheses on this input, so
    the full-mode cases above do not pass by scoring partially."""
    s = jax_run["search"]
    assert s["full"]["hyps"] != s["partial"]["hyps"]


@pytest.mark.parametrize("mode", MODES)
def test_search_store_matches_jax(jax_run, port, mode):
    """Every stored hypothesis (not only the best) and its length."""
    sig_lens = torch.from_numpy(jax_run["sig_lens"])
    enc = port.encode(torch.from_numpy(jax_run["sig"]), sig_lens)
    seqs, lens, scores = port.make_searcher(
        BEAM, CTC_WEIGHT, ctc_score_mode=mode).search_device(enc, sig_lens)
    j_seqs, j_lens, j_scores = jax_run["search"][mode]["store"]
    assert np.array_equal(lens.numpy(), j_lens)
    assert np.array_equal(seqs.numpy(), j_seqs)
    live = j_scores > -1e19
    np.testing.assert_allclose(scores.numpy()[live], j_scores[live],
                               atol=1e-4, rtol=0)


def test_kernel_toggle_gives_same_result_on_cpu(jax_run, port):
    """With the kernels routed to their plain versions explicitly the
    CPU result is unchanged (on the CPU both routes are the plain ones);
    the default decode settings are the recipe's (full CTC scoring)."""
    sig = torch.from_numpy(jax_run["sig"])
    sig_lens = torch.from_numpy(jax_run["sig_lens"])
    try:
        port.set_kernels(False)
        hyps, scores = port.transcribe(sig, sig_lens, beam_size=BEAM,
                                       ctc_weight=CTC_WEIGHT)
    finally:
        port.set_kernels(True)
    ref = jax_run["search"]["full"]
    assert hyps == ref["hyps"]
    np.testing.assert_allclose(scores, ref["scores"], atol=1e-4, rtol=0)


def test_bfloat16_route_runs(jax_run):
    """The bfloat16 network (features, softmaxes and scores stay f32)
    runs the whole path; its encoder stays within four bf16 ulps
    (|x| < 4) of the JAX f32 one (2 layers; measured 0.026)."""
    asr = ConformerASR(CFG, device="cpu", dtype=torch.bfloat16)
    asr.load_state_dict(jax_run["state_dict"])
    sig = torch.from_numpy(jax_run["sig"])
    sig_lens = torch.from_numpy(jax_run["sig_lens"])
    enc = asr.encode(sig, sig_lens)
    assert enc.dtype == torch.bfloat16
    np.testing.assert_allclose(enc.float().numpy(), jax_run["enc"],
                               atol=6.25e-2, rtol=0)
    hyps, scores = asr.transcribe(sig, sig_lens, beam_size=BEAM,
                                  ctc_weight=CTC_WEIGHT)
    assert len(hyps) == 3 and np.isfinite(scores).all()


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConformerASR(CFG)
