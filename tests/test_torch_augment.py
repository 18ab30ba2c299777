"""The port's SpecAugment (``lobes/augment.py``) and where the Brains
apply it.

JAX draws with its own PRNG, so the bits of the draws cannot match.
With the draws fixed (recomputed here from JAX's key by the same
``jax.random`` calls as ``speechbrain_tpu/lobes/augment.py:69-110``),
the port's output equals JAX's ``SpecAugment`` on the same features, in
both fill modes, with and without the time warp, and at T <= 2W.  The
port's own draws are held by their ranges and rough uniformity, and run
with no host sync.  The Brains apply it in ``Stage.TRAIN`` only, after
the normalization and before the cast to the activation dtype, with
draws from the brain's generator.
"""

import jax
import numpy as np
import pytest
import torch

from speechbrain_tpu.lobes.augment import SpecAugment as JSpecAugment
from speechbrain_tpu_torch.asr import (
    CONFORMER_SMALL,
    CONFORMER_TRANSDUCER,
    ConformerASRBrain,
    ConformerTransducerBrain,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.lobes.augment import SpecAugment

from .test_torch_kernels import one_torch_thread  # noqa: F401

SMALL = CONFORMER_SMALL["augmentation"]      # warp, mean fill
TRANSDUCER = CONFORMER_TRANSDUCER["augmentation"]  # no warp, zero fill


def _jax_draws(aug, key, shape):
    """The values JAX's ``SpecAugment.__call__`` draws from ``key``."""
    B, T, F = shape
    k_warp, k_freq, k_time = jax.random.split(key, 3)
    W = aug.time_warp_window
    warp = None
    if T > 2 * W:
        k_c, k_w = jax.random.split(k_warp)
        c = jax.random.randint(k_c, (), W, T - W)
        w = c + jax.random.randint(k_w, (), -W, W + 1)
        warp = (torch.tensor(int(c)), torch.tensor(int(w)))

    def band(k, n, width, D):
        k_len, k_pos = jax.random.split(k)
        lens = jax.random.randint(k_len, (B, n), width[0],
                                  max(width[1], width[0] + 1))
        pos = jax.random.randint(k_pos, (B, n), 0, max(1, D - width[1]))
        return torch.from_numpy(np.array(lens)), torch.from_numpy(np.array(pos))

    return {"warp": warp,
            "freq": band(k_freq, aug.n_freq_mask, aug.freq_mask_width, F),
            "time": band(k_time, aug.n_time_mask, aug.time_mask_width, T)}


@pytest.mark.parametrize("args,T", [
    (SMALL, 120), (TRANSDUCER, 120), (SMALL, 10),
    (dict(SMALL, replace_with_zero=True), 120),
    (dict(TRANSDUCER, time_warp=True, replace_with_zero=False), 120),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_draws_match_jax(args, T, seed):
    """JAX's arithmetic: the warp's remap and interpolation, the union of
    bands, the fill (0, or the mean of the current tensor, taken again
    before the time masks); T = 10 <= 2W leaves time unwarped.  Bit for
    bit but for the mean's summation order."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((3, T, 40)) + 1.0).astype(np.float32)
    jaug, aug = JSpecAugment(**args), SpecAugment(**args)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug(x, key))
    draws = _jax_draws(aug, key, x.shape)
    got = aug(torch.from_numpy(x), draws=draws).numpy()
    # the same float32 operations in the same order, so the same bits;
    # the mean fill is a float32 sum of B x T x F values in another
    # order (differences of ~1e-5 at these magnitudes)
    tol = 0.0 if aug.replace_with_zero else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if T <= 10:
        assert draws["warp"] is None
    # the masks acted (each band has width 0 at times; 3 rows x 6 bands)
    assert not np.array_equal(got, x)


def test_draws_ranges_and_uniformity():
    """Widths in [lo, hi), starts in [0, D - hi), the warp's centre in
    [W, T - W) and its shift in [-W, W], every value drawn at about its
    share over many draws from one generator."""
    aug = SpecAugment(**SMALL)
    g = torch.Generator().manual_seed(123)
    B, T, F, n = 4000, 200, 80, 2
    d = aug.draw((B, T, F), g)
    f_lens, f_pos = d["freq"]
    t_lens, t_pos = d["time"]
    for vals, lo, hi in ((f_lens, 0, 30), (f_pos, 0, F - 30), (t_lens, 0, 40),
                         (t_pos, 0, T - 40)):
        assert vals.shape == (B, n if vals is f_lens or vals is f_pos else 4)
        assert int(vals.min()) == lo and int(vals.max()) == hi - 1
        counts = torch.bincount(vals.reshape(-1) - lo, minlength=hi - lo)
        expect = vals.numel() / (hi - lo)
        # within 5 standard deviations of a uniform draw's count
        assert float((counts - expect).abs().max()) < 5 * expect ** 0.5
    W = aug.time_warp_window
    cs, shifts = [], []
    for _ in range(600):
        c, w = aug.draw((1, T, F), g)["warp"]
        cs.append(int(c))
        shifts.append(int(w - c))
    assert min(cs) >= W and max(cs) < T - W
    assert sorted(set(shifts)) == list(range(-W, W + 1))
    counts = np.bincount(np.array(shifts) + W)
    assert counts.min() > 0.5 * 600 / (2 * W + 1)
    assert aug.draw((1, 2 * W, F), g)["warp"] is None


def test_draws_and_masks_make_no_host_sync(monkeypatch):
    """A call draws and masks without reading a value back: every way a
    tensor reaches the host raises while it runs."""
    aug = SpecAugment(**SMALL)
    x = torch.randn(2, 100, 80, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)

    def sync(*args, **kwargs):
        raise AssertionError("host sync")

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    out = aug(x, g)
    monkeypatch.undo()
    assert out.shape == x.shape and not torch.equal(out, x)


def test_same_seed_same_draws():
    aug = SpecAugment(**SMALL)
    x = torch.randn(2, 100, 80, generator=torch.Generator().manual_seed(0))
    a = aug(x, torch.Generator().manual_seed(7))
    b = aug(x, torch.Generator().manual_seed(7))
    c = aug(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


TOY = dict(frontend_channels=(4, 4), input_size=40, d_model=16, nhead=2,
           num_encoder_layers=1, d_ffn=32, kernel_size=5, vocab_size=12,
           n_mels=40, transformer_dropout=0.0)


def _batch(B=2):
    rng = np.random.default_rng(0)
    tok = rng.integers(3, 12, (B, 3))
    ones = np.ones(B, np.float32)
    return {"sig": (0.1 * rng.standard_normal((B, 16000))).astype(np.float32),
            "sig_lens": ones, "tokens": tok, "tokens_lens": ones,
            "tokens_bos": np.concatenate([np.ones((B, 1), np.int64), tok], 1),
            "tokens_eos": np.concatenate([tok, np.full((B, 1), 2)], 1),
            "tokens_eos_lens": ones,
            "tokens_blank": np.concatenate([np.zeros((B, 1), np.int64), tok], 1)}


def _brain(which, augmentation):
    """A toy bf16 ``ConformerASRBrain`` (0) or ``ConformerTransducerBrain``
    (1) with ``augmentation``."""
    run_opts = {"precision": "bf16"}
    if which == 0:
        return ConformerASRBrain(
            dict(CONFORMER_SMALL, **TOY, num_decoder_layers=1,
                 augmentation=augmentation), device="cpu", run_opts=run_opts)
    return ConformerTransducerBrain(
        dict(CONFORMER_TRANSDUCER, **TOY, dec_emb_dim=8, dec_neurons=8,
             joint_dim=8, augmentation=augmentation),
        device="cpu", run_opts=run_opts)


def _frontend_input(brain, batch, stage):
    """The normalization's output and the front end's input of one
    ``compute_forward``, and the brain generator's state before it."""
    seen = {}
    hooks = [
        brain.modules.normalize.register_forward_hook(
            lambda m, args, out: seen.setdefault("norm", out.detach().clone())),
        brain.modules.frontend.register_forward_pre_hook(
            lambda m, args: seen.setdefault("front", args[0].detach().clone())),
    ]
    state = brain.generator.get_state()
    brain.modules.train(stage == Stage.TRAIN)
    with torch.no_grad():
        brain.compute_forward(brain.prepare_batch(batch), stage)
    for h in hooks:
        h.remove()
    return seen["norm"], seen["front"], state


@pytest.mark.parametrize("which", [0, 1])
def test_brains_augment_in_training_only_before_the_cast(which):
    """TRAIN: the front end sees SpecAugment (the recipe's settings, the
    brain's generator) of the normalized features, cast to bf16 after
    it; VALID and TEST: the normalized features, cast, and the generator
    untouched; with ``augmentation`` None, TRAIN is unchanged too."""
    batch = _batch()
    brain = _brain(which, (CONFORMER_SMALL, CONFORMER_TRANSDUCER)[which][
        "augmentation"])
    norm, front, state = _frontend_input(brain, batch, Stage.TRAIN)
    g = torch.Generator().set_state(state)
    want = brain.augment(norm, g).to(torch.bfloat16)
    assert front.dtype == torch.bfloat16 and torch.equal(front, want)
    assert not torch.equal(front, norm.to(torch.bfloat16))
    for stage in (Stage.VALID, Stage.TEST):
        norm, front, state = _frontend_input(brain, batch, stage)
        assert torch.equal(front, norm.to(torch.bfloat16))
        assert torch.equal(brain.generator.get_state(), state)
    off = _brain(which, None)
    assert off.augment is None
    norm, front, _ = _frontend_input(off, batch, Stage.TRAIN)
    assert torch.equal(front, norm.to(torch.bfloat16))
