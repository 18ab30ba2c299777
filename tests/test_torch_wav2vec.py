"""The native wav2vec 2.0 modules on the port against the JAX package, on
the same numpy inputs and weights (through ``bridge.py``):
``VanillaNN``, ``GumbelVectorQuantizer`` and ``W2VTargetQuantiser`` (eval
mode, and training mode with the same uniform draw), ``W2VLatentExtractor``,
``EncoderWrapper`` (with and without ``mask_emb``, with and without
``wav_lens``), ``ContrastiveLoss``, ``compute_mask`` and
``w2v_mask_collate_fn`` bit for bit, the negatives' gather given the same
offsets, and the bridge's round trip.

Sizes: 2 convolutions of 32 channels, 0.25 s clips (T 398), a 2-layer
encoder at d 32, 8 codewords in each of 2 groups.

Tolerances:

- outputs in float32: 2e-6 of each output's scale (sums over at most a
  few hundred products);
- gradients in float64 on both sides (``jax.enable_x64``; the modules
  reach no CUDA kernel), compared after the bridge's rounding to float32:
  2e-6 of each tensor's largest gradient;
- the mask, the collate function, the gathers and the round trip: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.models import wav2vec as JW
from speechbrain_tpu.lobes.models.VanillaNN import VanillaNN as JVanillaNN
from speechbrain_tpu.nnet.losses import ContrastiveLoss as JContrastiveLoss
from speechbrain_tpu.nnet.quantisers import GumbelVectorQuantizer as JGumbel
from speechbrain_tpu_torch import bridge
from speechbrain_tpu_torch.lobes.models import wav2vec as PW
from speechbrain_tpu_torch.lobes.models.VanillaNN import VanillaNN
from speechbrain_tpu_torch.nnet.losses import ContrastiveLoss
from speechbrain_tpu_torch.nnet.quantisers import GumbelVectorQuantizer

from .test_torch_kernels import one_torch_thread  # noqa: F401

OUT_TOL, GRAD_TOL = 2e-6, 2e-6
CHANNELS, SAMPLES, D = (32, 32), 4000, 32
G, V, VQ = 2, 8, 16


def _randomize(tree, rng, scale=0.3):
    """Normal noise of each leaf's shape (from ``jax.eval_shape``)."""
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        tree)


def _params(module, rng, *args, rngs=None, **kwargs):
    keys = rngs or jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *a: module.init(keys, *a, **kwargs), *args)
    return _randomize(shapes["params"], rng)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    dev = float(np.abs(got - want).max())
    assert dev <= tol * scale, f"{what}: {dev} > {tol} x {scale}"


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_grads(fn, params, *args):
    """``jax.grad`` of ``fn(params, *args)`` (a scalar) in float64."""
    with jax.enable_x64(True):
        return jax.device_get(jax.jit(jax.grad(fn))(_f64(params),
                                                    *map(_f64, args)))


def _port_grads(module, fn):
    """The float64 gradients of ``fn(module)`` by parameter name."""
    module.double().zero_grad(set_to_none=True)
    fn(module).backward()
    return {k: p.grad for k, p in module.named_parameters()}


def _assert_grads(got, want_sd, what=""):
    """Each gradient within ``GRAD_TOL`` of its largest entry, plus 1e-12
    of the largest entry overall: the attention's key biases, which the
    softmax removes, have gradients that are 0 analytically and float64
    rounding noise numerically."""
    assert got.keys() == want_sd.keys(), what
    top = max(float(ref.abs().max()) for ref in want_sd.values())
    for k, ref in want_sd.items():
        ref = ref.numpy()
        dev = float(np.abs(got[k].float().numpy() - ref).max())
        bound = GRAD_TOL * float(np.abs(ref).max()) + 1e-12 * top
        assert dev <= bound, f"{what} {k}: {dev} > {bound}"


def _wave(seed=0, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, SAMPLES)).astype(np.float32)


def test_vanilla_nn_matches_jax():
    """Two Dense + leaky relu (slope 0.01) blocks."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    jm = JVanillaNN(dnn_blocks=2, dnn_neurons=16)
    params = _params(jm, rng, x)
    pm = VanillaNN(12, dnn_blocks=2, dnn_neurons=16)
    pm.load_state_dict(bridge.vanilla_nn_state_dict(params))
    out = pm(torch.from_numpy(x))
    _close(out.detach().numpy(), jm.apply({"params": params}, x), OUT_TOL)
    assert float((out < 0).float().mean()) > 0.2  # the leaky side is used
    W = rng.standard_normal(out.shape)

    def jf(p, x):
        return (jm.apply({"params": p}, x) * W).sum()

    want = bridge.vanilla_nn_state_dict(_jax_grads(jf, params, x))
    got = _port_grads(pm, lambda m: (m(torch.from_numpy(x).double())
                                     * torch.from_numpy(W)).sum())
    _assert_grads(got, want, "VanillaNN")


def test_extractor_matches_jax():
    """Two VALID convolutions (kernels 11, 3; strides 5, 2: the JAX zip of
    the tuples), LayerNorm over the channels at eps 1e-6 and the tanh
    GELU: the output, and the wave's and every parameter's gradient."""
    rng = np.random.default_rng(2)
    x = _wave(2)
    jm = JW.W2VLatentExtractor(out_channels=CHANNELS)
    params = _params(jm, rng, x)
    pm = PW.W2VLatentExtractor(out_channels=CHANNELS)
    pm.load_state_dict(bridge.w2v_extractor_state_dict(params))
    out = pm(torch.from_numpy(x))
    want = jm.apply({"params": params}, x)
    assert out.shape == want.shape == (2, pm.get_output_lengths(SAMPLES), 32)
    _close(out.detach().numpy(), want, OUT_TOL)
    assert pm.norms[0].eps == 1e-6
    W = rng.standard_normal(out.shape)

    def jf(p, x):
        return (jm.apply({"params": p}, x) * W).sum()

    want_g = bridge.w2v_extractor_state_dict(_jax_grads(jf, params, x))
    xt = torch.from_numpy(x).double().requires_grad_()
    got = _port_grads(pm, lambda m: (m(xt) * torch.from_numpy(W)).sum())
    _assert_grads(got, want_g, "extractor")
    with jax.enable_x64(True):
        jgx = jax.grad(lambda x: jf(_f64(params), x))(_f64(x))
    _close(xt.grad.numpy(), jgx, GRAD_TOL, "wave")


def _latents(seed=3, B=2, T=40):
    return np.random.default_rng(seed).standard_normal(
        (B, T, CHANNELS[-1])).astype(np.float32)


def _uniform(seed, n):
    return np.random.default_rng(seed).uniform(size=(n, V))


def _patched_uniform(monkeypatch, u):
    """JAX's Gumbel draw replaced by ``u`` (the port takes it as an
    argument)."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(u).reshape(
                            shape))


@pytest.mark.parametrize("train", [False, True])
def test_gumbel_quantiser_matches_jax(train, monkeypatch):
    """``GumbelVectorQuantizer``: the codewords and the perplexity (the
    noiseless softmax's), in eval mode (the argmax) and in training mode
    with the same uniform draw (the straight-through Gumbel softmax at the
    first temperature, 2.0); the gradients of a weighted sum of both."""
    rng = np.random.default_rng(4)
    x = _latents(4)
    B, T, _ = x.shape
    u = _uniform(5, B * T * G)
    _patched_uniform(monkeypatch, u)
    jm = JGumbel(dim=32, num_vars=V, groups=G, vq_dim=VQ)
    keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    params = _params(jm, rng, x, rngs=keys, train=train)
    pm = GumbelVectorQuantizer(32, num_vars=V, groups=G, vq_dim=VQ)
    pm.load_state_dict({"codebook": torch.from_numpy(np.asarray(
        params["codebook"])), **{f"weight_proj.{k}": v for k, v in
                                 bridge.dense(params["Dense_0"]).items()}})
    pm.train(train)
    j_out = jm.apply({"params": params}, x, train=train,
                     rngs={"gumbel": jax.random.PRNGKey(2)})
    out = pm(torch.from_numpy(x), uniform=torch.from_numpy(u).float())
    _close(out["x"].detach().numpy(), j_out["x"], OUT_TOL, "codewords")
    _close(float(out["prob_perplexity"].detach()), j_out["prob_perplexity"],
           OUT_TOL)
    assert out["temp"] == j_out["temp"] == 2.0
    assert out["num_vars"] == j_out["num_vars"] == G * V
    W = rng.standard_normal(out["x"].shape)

    def jf(p, x):
        o = jm.apply({"params": p}, x, train=train,
                     rngs={"gumbel": jax.random.PRNGKey(2)})
        return (o["x"] * W).sum() + 3.0 * o["prob_perplexity"]

    want = _jax_grads(jf, params, x)

    def pf(m):
        o = m(torch.from_numpy(x).double(), uniform=torch.from_numpy(u))
        return (o["x"] * torch.from_numpy(W)).sum() + 3.0 * o[
            "prob_perplexity"]

    got = _port_grads(pm, pf)
    _close(got["codebook"].numpy(), want["codebook"], GRAD_TOL, "codebook")
    for k, ref in bridge.dense(want["Dense_0"]).items():
        _close(got[f"weight_proj.{k}"].float().numpy(), ref.numpy(),
               GRAD_TOL, k)


def test_target_quantiser_matches_jax(monkeypatch):
    """``W2VTargetQuantiser`` in training mode with the same draw: the
    targets, the diversity loss ``(num_vars - perplexity) / num_vars`` and
    the gradients of a weighted sum of both."""
    rng = np.random.default_rng(6)
    x = _latents(6)
    B, T, _ = x.shape
    u = _uniform(7, B * T * G)
    _patched_uniform(monkeypatch, u)
    jm = JW.W2VTargetQuantiser(in_dim=32, out_dim=VQ, quantiser_vars=V,
                               quantiser_groups=G)
    keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    params = _params(jm, rng, x, rngs=keys, train=True)
    pm = PW.W2VTargetQuantiser(32, VQ, V, G)
    pm.load_state_dict(bridge.w2v_quantiser_state_dict(params))
    rngs = {"gumbel": jax.random.PRNGKey(3)}
    j_t, j_meta = jm.apply({"params": params}, x, train=True, rngs=rngs)
    t, meta = pm(torch.from_numpy(x), uniform=torch.from_numpy(u).float())
    _close(t.detach().numpy(), j_t, OUT_TOL, "targets")
    _close(float(meta["diversity_loss"].detach()), j_meta["diversity_loss"],
           OUT_TOL)
    W = rng.standard_normal(t.shape)

    def jf(p, x):
        t, meta = jm.apply({"params": p}, x, train=True, rngs=rngs)
        return (t * W).sum() + 5.0 * meta["diversity_loss"]

    want = bridge.w2v_quantiser_state_dict(_jax_grads(jf, params, x))

    def pf(m):
        t, meta = m(torch.from_numpy(x).double(), uniform=torch.from_numpy(u))
        return (t * torch.from_numpy(W)).sum() + 5.0 * meta["diversity_loss"]

    _assert_grads(_port_grads(pm, pf), want, "quantiser")


ENC = dict(embedding_dim=D, num_layers=2, nhead=4, d_ffn=64)


def _encoder_pair(with_mask, rng, x, mask):
    jm = JW.EncoderWrapper(in_dim=32, dropout=0.0, **ENC)
    params = _params(jm, rng, x, mask=mask if with_mask else None,
                     train=False)
    pm = PW.EncoderWrapper(32, D, ENC["num_layers"], ENC["nhead"],
                           ENC["d_ffn"], 0.0, mask_emb=with_mask).eval()
    pm.load_state_dict(bridge.w2v_encoder_state_dict(params))
    return jm, params, pm


@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_encoder_matches_jax(with_mask, with_lens):
    """``EncoderWrapper``: ``mask_emb`` exists exactly when the init call
    passes a mask (in both packages), then the masked frames, the PE, the
    pre-norm transformer and the key padding ``arange(T) >= wav_lens * T``
    (no rounding); outputs and the gradients of every parameter."""
    rng = np.random.default_rng(8)
    x = _latents(8)
    B, T, _ = x.shape
    mask = JW.compute_mask((B, T), [T] * B, mask_prob=0.4, mask_length=3,
                           seed=1)
    assert mask.any() and not mask.all()
    jm, params, pm = _encoder_pair(with_mask, rng, x, mask)
    assert ("mask_emb" in params) == with_mask == hasattr(pm, "mask_emb")
    kw = {"wav_lens": np.array([1.0, 0.63], np.float32)} if with_lens else {}
    if with_mask:
        kw["mask"] = mask
    j_out = jm.apply({"params": params}, x, train=False, **kw)["embeddings"]
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    out = pm(torch.from_numpy(x), **tkw)["embeddings"]
    _close(out.detach().numpy(), j_out, OUT_TOL)
    W = rng.standard_normal(out.shape)

    def jf(p, x):
        return (jm.apply({"params": p}, x, train=False, **kw)["embeddings"]
                * W).sum()

    want = bridge.w2v_encoder_state_dict(_jax_grads(jf, params, x))
    got = _port_grads(pm, lambda m: (m(torch.from_numpy(x).double(), **tkw)[
        "embeddings"] * torch.from_numpy(W)).sum())
    _assert_grads(got, want, "encoder")


def test_encoder_without_mask_emb_refuses_a_mask():
    pm = PW.EncoderWrapper(32, D, 1, 4, 64, 0.0).eval()
    with pytest.raises(ValueError, match="mask_emb"):
        pm(torch.zeros(1, 5, 32), mask=torch.ones(1, 5, dtype=torch.bool))


@pytest.mark.parametrize("case", [
    ((2, 40), [40, 40], 0.4, 3, 0),
    ((3, 498), [498, 300, 9], 0.065, 10, 7),
    ((4, 57), None, 0.65, 10, 123),
    ((2, 30), [30, 12], 0.9, 2, 2 ** 40 + 5),
])
def test_compute_mask_is_jax_bit_for_bit(case):
    """The same seed gives the same mask bit for bit, short rows
    (``limit <= mask_length``) left unmasked."""
    shape, lens, prob, length, seed = case
    got = PW.compute_mask(shape, lens, prob, length, seed)
    np.testing.assert_array_equal(
        got, JW.compute_mask(shape, lens, prob, length, seed))
    assert got.dtype == bool and got.shape == shape


def test_negatives_gather_matches_jax():
    """JAX's ``sample_negatives`` draws offsets 1..T-1 from its key; given
    the same offsets, ``gather_negatives`` picks the same frames, bit for
    bit, and ``negative_offsets`` never picks the frame itself."""
    rng = np.random.default_rng(9)
    y = rng.standard_normal((3, 17, 5)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    N = 6
    offsets = np.asarray(jax.random.randint(key, (N, 3, 17), 1, 17))
    want = np.asarray(JW.sample_negatives(jnp.asarray(y), N, key))
    got = PW.gather_negatives(torch.from_numpy(y), torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), want)
    off = PW.negative_offsets(50, 3, 17, torch.Generator().manual_seed(0))
    assert int(off.min()) == 1 and int(off.max()) == 16
    neg = PW.sample_negatives(torch.from_numpy(y), 50,
                              torch.Generator().manual_seed(0))
    frames = torch.from_numpy(y)[None].expand_as(neg)
    assert not bool((neg == frames).all(-1).any())


def test_contrastive_loss_matches_jax():
    """The cosine over the norms' product + 1e-8, over ``logit_temp``, the
    log-softmax over [positive; negatives] and the mean over every frame:
    the value in float32 and the three inputs' gradients in float64."""
    rng = np.random.default_rng(10)
    e, q = (rng.standard_normal((2, 9, 6)).astype(np.float32)
            for _ in range(2))
    n = rng.standard_normal((4, 2, 9, 6)).astype(np.float32)
    j_loss = JContrastiveLoss(0.1)(e, q, n)
    loss = ContrastiveLoss(0.1)(*map(torch.from_numpy, (e, q, n)))
    _close(float(loss.detach()), j_loss, OUT_TOL)
    with jax.enable_x64(True):
        jg = jax.grad(lambda *a: JContrastiveLoss(0.1)(*a), (0, 1, 2))(
            *map(_f64, (e, q, n)))
    ts = [torch.from_numpy(a).double().requires_grad_() for a in (e, q, n)]
    ContrastiveLoss(0.1)(*ts).backward()
    for t, g in zip(ts, jg):
        _close(t.grad.numpy(), g, GRAD_TOL)


def test_collate_fn_matches_jax():
    rng = np.random.default_rng(11)
    samples = [{"sig": rng.standard_normal(n).astype(np.float32)}
               for n in (3200, 4800, 1600)]
    args = dict(get_out_len_fn=lambda n: n // 320, mask_prob=0.5,
                mask_length=2, seed=3)
    (w, lens, mask), dummy = PW.w2v_mask_collate_fn(samples, **args)
    (jw, jlens, jmask), jdummy = JW.w2v_mask_collate_fn(samples, **args)
    for a, b in ((w, jw), (lens, jlens), (mask, jmask)):
        np.testing.assert_array_equal(a, b)
    assert dummy == jdummy == ()


@pytest.mark.parametrize("recipe", ["pretrain", "ctc"])
def test_bridge_round_trips_bit_for_bit(recipe):
    """The recipes' modules (the pretraining's with ``mask_emb``, the
    CTC's without) -> JAX params -> the port's state_dict, bit for bit,
    with Flax's names (``conv_{i}``, ``LayerNorm_{i}``,
    ``GumbelVectorQuantizer_0``, ``TransformerEncoder_0``, ``Dense_{i}``)."""
    from speechbrain_tpu_torch.recipes import wav2vec_ctc, wav2vec_pretrain

    toy = dict(latent_channels=CHANNELS, embedding_dim=D, encoder_layers=2,
               nhead=4, d_ffn=64, quantiser_vars=V, target_dim=VQ,
               dnn_neurons=24, output_neurons=11)
    build = (wav2vec_pretrain.build_modules if recipe == "pretrain"
             else wav2vec_ctc.build_modules)
    modules = torch.nn.ModuleDict(build(toy, seed=3))
    sd = modules.state_dict()
    params = bridge.to_jax_wav2vec(sd)
    assert ("mask_emb" in params["encoder"]) == (recipe == "pretrain")
    assert sorted(params["extractor"]) == ["LayerNorm_0", "LayerNorm_1",
                                           "conv_0", "conv_1"]
    assert params["extractor"]["conv_0"]["kernel"].shape == (11, 1, 32)
    if recipe == "pretrain":
        assert sorted(params["quantiser"]) == ["Dense_0",
                                               "GumbelVectorQuantizer_0"]
    else:
        assert sorted(params["enc_dnn"]) == ["Dense_0", "Dense_1"]
    back = bridge.wav2vec_state_dict(params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
