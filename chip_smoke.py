#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``speechbrain_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line when it ends:

1. build   -- compile every CUDA kernel from ``speechbrain_tpu_torch/csrc``.
2. kernels -- each kernel against its plain PyTorch version on the card,
   at the shapes the serving path gives it, in float32 and bfloat16:
   max |error| against the stated tolerance, kernel / plain / library
   times (CUDA events) and the least time the card could take (bound).
3. serve   -- ``ConformerASR(CONFORMER_SMALL)`` (full width, random
   weights from a seed) transcribes 8 synthetic 10 s utterances with
   beam 10 and CTC weight 0.4, in float32 and then bfloat16.  The launch
   counters must rise by 12 per encode (depthwise conv) and 4 per beam
   step (beam cache); the float32 run is compared with the same search
   through the plain versions on the card.
4. long    -- an utterance long enough for T_enc = 512 is encoded; the
   rel-pos attention kernel must run once per encoder layer, and the
   result must match the plain path.

Then one ``{"kernels": [...]}`` line (launch counts from phases 3 and 4,
each counted from 0 just before its run), and last the device line.
float32 matmuls and convolutions run without TF32 throughout, and cuDNN
picks deterministic algorithms.  Any
failed check raises, so the exit code is non-zero and the device line
is not printed.  Exits non-zero when no CUDA card is present.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BLANK_BIAS, EOS_BIAS = 8.0, 5.0  # see phase_serve
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32; bf16 tensor cores


def emit(obj):
    """Print one JSON line and flush it."""
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_build():
    """Compile every kernel (one nvcc per source, in parallel)."""
    from speechbrain_tpu_torch.ops import _build

    seconds = _build.build()
    logs = {
        name: (_build.BUILD_DIR / f"{name}.log").read_text()
        if (_build.BUILD_DIR / f"{name}.log").exists() else ""
        for name in _build.KERNELS
    }
    # ptxas register/spill lines, for the record
    ptxas = {
        n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for n, log in logs.items()
    }
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "ptxas": ptxas})


def _check_depthwise(dtype_name):
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import depthwise_conv1d, depthwise_conv1d_plain

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, T, C, K = 8, 251, 144, 31
    x = torch.randn(B, T, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(K, C, device="cuda", generator=g) / K ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(C, device="cuda", generator=g)).to(dtype)
    got = depthwise_conv1d(x, w, bias)
    ref = depthwise_conv1d_plain(x, w, bias)
    torch.cuda.synchronize()
    err = _err(got, ref)
    # f32: same taps, same order, FMA contraction only; bf16: the kernel
    # rounds once after the bias, the plain version twice (<= 1 ulp of |out| < 8)
    tol = 1e-4 if dtype == torch.float32 else 6.25e-2
    assert err <= tol, f"depthwise_conv1d {dtype_name}: max|err| {err} > {tol}"
    xc = x.transpose(1, 2).contiguous()
    wc = w.t().contiguous()[:, None, :]
    pad = (K - 1) // 2
    item = x.element_size()
    valid = sum(min(T, t + K - pad) - max(0, t - pad) for t in range(T))
    bound, by = _bound_ms((2 * B * T * C + K * C + C) * item, 2 * B * C * valid, dtype_name)
    return {
        "name": "depthwise_conv1d", "dtype": dtype_name, "shape": [B, T, C, K],
        "max_abs_err": err, "tol": tol,
        "ms": _time_ms(lambda: depthwise_conv1d(x, w, bias)),
        "plain_ms": _time_ms(lambda: depthwise_conv1d_plain(x, w, bias)),
        "library_ms": _time_ms(lambda: F.conv1d(xc, wc, bias, padding=pad, groups=C)),
        "bound_ms": bound, "bound_by": by,
    }


def _check_relpos(dtype_name, T):
    import torch
    import torch.nn.functional as F

    from speechbrain_tpu_torch.ops import relpos_attention, relpos_attention_plain

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED + T)
    B, H, dh = 2, 4, 36
    mk = lambda *s: (0.5 * torch.randn(*s, device="cuda", generator=g)).to(dtype)  # noqa: E731
    q, k, v = mk(B, H, T, dh), mk(B, H, T, dh), mk(B, H, T, dh)
    p = mk(H, 2 * T - 1, dh)
    u = 0.1 * torch.randn(H, dh, device="cuda", generator=g)
    vb = 0.1 * torch.randn(H, dh, device="cuda", generator=g)
    madd = torch.zeros(B, T, device="cuda")
    madd[1, T - T // 5:] = -65000.0  # padded tail of the second utterance
    scale = 1.0 / (H * dh) ** 0.5
    got = relpos_attention(q, k, v, p, u, vb, madd, scale)
    ref = relpos_attention_plain(q, k, v, p, u, vb, madd, scale)
    torch.cuda.synchronize()
    err = _err(got, ref)
    # both compute in f32 from the same stored values; sums in other orders
    tol = 1e-4
    assert err <= tol, f"relpos_attention {dtype_name} T={T}: max|err| {err} > {tol}"
    # library yardstick: SDPA with the materialized position bias
    qu = (q.float() + u[None, :, None]).to(dtype)
    ar = torch.arange(T, device="cuda")
    idx = (T - 1 - ar[:, None] + ar[None, :]).clamp(0, 2 * T - 2)
    ps = torch.einsum("bhqd,hld->bhql", q.float() + vb[None, :, None], p.float())
    bias = (torch.gather(ps, -1, idx.expand(B, H, T, T)) * scale
            + madd[:, None, None, :]).to(dtype)
    item = q.element_size()
    nbytes = (3 * B * H * T * dh + H * (2 * T - 1) * dh) * item + 4 * (2 * H * dh + B * T + B * H * T * dh)
    bound, by = _bound_ms(nbytes, 6 * B * H * T * T * dh, dtype_name)
    return {
        "name": "relpos_attention", "dtype": dtype_name, "shape": [B, H, T, dh],
        "max_abs_err": err, "tol": tol,
        "ms": _time_ms(lambda: relpos_attention(q, k, v, p, u, vb, madd, scale)),
        "plain_ms": _time_ms(lambda: relpos_attention_plain(q, k, v, p, u, vb, madd, scale)),
        "library_ms": _time_ms(
            lambda: F.scaled_dot_product_attention(qu, k, v, attn_mask=bias, scale=scale)),
        "bound_ms": bound, "bound_by": by,
    }


def _check_beam_cache(dtype_name):
    import torch

    from speechbrain_tpu_torch.ops.beam_cache import _xla_ref, beam_attend_step

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n, H, Dh, L, pos = 80, 4, 36, 256, 200
    HD = H * Dh
    kv = torch.randn(n, HD, 2 * L, device="cuda", generator=g).to(dtype)
    rows = torch.randint(0, n // 2, (n,), device="cuda", generator=g, dtype=torch.int32)
    q, kn, vn = (torch.randn(n, HD, device="cuda", generator=g).to(dtype) / 6 for _ in range(3))
    dst = torch.empty_like(kv)
    ctx, new = beam_attend_step(kv, rows, q, kn, vn, pos, H, dst=dst)
    ctx_ref, new_ref = _xla_ref(kv, rows, pos, q, kn, vn, H)
    torch.cuda.synchronize()
    assert torch.equal(new, new_ref), f"beam_attend_step {dtype_name}: cache not bit-exact"
    err = _err(ctx, ctx_ref)
    tol = 1e-5  # f32 softmax and sums from the same stored values
    assert err <= tol, f"beam_attend_step {dtype_name}: ctx max|err| {err} > {tol}"
    item = kv.element_size()
    n_src = int(torch.unique(rows).numel())
    nbytes = (n_src + n) * HD * 2 * L * item + 3 * n * HD * item + 4 * n + 4 * n * HD
    bound, by = _bound_ms(nbytes, 4 * n * HD * (pos + 1), dtype_name)
    return {
        "name": "beam_attend_step", "dtype": dtype_name, "shape": [n, H, Dh, L],
        "pos": pos, "source_rows": n_src,
        "max_abs_err": err, "tol": tol, "cache_bit_exact": True,
        "ms": _time_ms(lambda: beam_attend_step(kv, rows, q, kn, vn, pos, H, dst=dst)),
        "plain_ms": _time_ms(lambda: _xla_ref(kv, rows, pos, q, kn, vn, H)),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by,
    }


KERNEL_INFO = {
    "depthwise_conv1d": (
        "speechbrain_tpu_torch/csrc/depthwise_conv.cu",
        "speechbrain_tpu/ops/pallas/depthwise_conv.py:57",
    ),
    "relpos_attention": (
        "speechbrain_tpu_torch/csrc/relpos_attention.cu",
        "speechbrain_tpu/ops/pallas/relpos_attention.py:295",
    ),
    "beam_attend_step": (
        "speechbrain_tpu_torch/csrc/beam_cache.cu",
        "speechbrain_tpu/ops/pallas/beam_cache.py:184",
    ),
}


def phase_kernels():
    """Each kernel against its plain version; returns the records."""
    records = []
    for dtype_name in ("float32", "bfloat16"):
        records.append(_check_depthwise(dtype_name))
        for T in (512, 1024):
            records.append(_check_relpos(dtype_name, T))
        records.append(_check_beam_cache(dtype_name))
    for r in records:
        emit({"phase": "kernels", **r})
    return records


def _synthetic(B, samples, seed):
    """B utterances of white noise, relative lengths 1.0 down to 0.825."""
    import torch

    rng = np.random.default_rng(seed)
    sig = (0.1 * rng.standard_normal((B, samples))).astype(np.float32)
    lens = (1.0 - 0.025 * np.arange(B)).astype(np.float32)
    return torch.from_numpy(sig).cuda(), torch.from_numpy(lens).cuda()


def _search(asr, enc, lens, beam, ctc_weight):
    """Run the beam search; returns (hyps, scores, steps, seconds)."""
    import torch

    searcher = asr.make_searcher(beam, ctc_weight)
    steps = [0]
    step = searcher.forward_step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    searcher.forward_step = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = searcher.search_device(enc, lens)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hyps, scores = searcher.finalize(*store)
    return hyps, scores, steps[0], seconds


def _profile_search(asr, enc, lens, beam, ctc_weight):
    """One more search under torch.profiler: how much of the wall time
    the card is busy, how many kernels a step launches, and the kernels
    that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, steps, seconds = _search(asr, enc, lens, beam, ctc_weight)
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:6]
    return {
        "profiled_steps": steps,
        "profiled_wall_ms": 1e3 * seconds,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / seconds if busy_us else "not measured",
        "device_kernels_per_step": launches / steps if busy_us else "not measured",
        "top_device_kernels_ms": [[e.key[:60], e.device_time_total / 1e3, e.count]
                                  for e in top],
    }


def phase_serve():
    """conformer_small transcribes 8 x 10 s at beam 10, f32 then bf16."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR

    B, beam, ctc_weight = 8, 10, 0.4
    n_dec = CONFORMER_SMALL["num_decoder_layers"]
    n_enc = CONFORMER_SMALL["num_encoder_layers"]
    sig, lens = _synthetic(B, 160000, SEED)
    runs = {}
    for dtype_name in ("float32", "bfloat16"):
        asr = ConformerASR(CONFORMER_SMALL, dtype=getattr(torch, dtype_name),
                           seed=SEED)
        # Untrained heads get a blank bias (CTC) and an eos bias (seq2seq),
        # as bench.py's decode section does, so the decode has a trained
        # model's shape: mostly-blank CTC posteriors and hypotheses that
        # end.  Without them every beam runs into the CTC's impossible
        # region (a prefix longer than the frames left), where all scores
        # tie at -1e20 and the pick among the ties is arbitrary.
        with torch.no_grad():
            asr.ctc_lin.bias[CONFORMER_SMALL["blank_index"]] += BLANK_BIAS
            asr.seq_lin.bias[CONFORMER_SMALL["eos_index"]] += EOS_BIAS
        # warm-up (untimed): library handles, kernel loads, first-call
        # allocations of every shape the search meets
        _search(asr, asr.encode(sig, lens), lens, beam, ctc_weight)
        ops.reset_launch_counters()
        t0 = time.perf_counter()
        enc = asr.encode(sig, lens)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        hyps, scores, steps, search_s = _search(asr, enc, lens, beam, ctc_weight)
        counts = ops.launch_counters()
        assert enc.shape == (B, 251, CONFORMER_SMALL["d_model"]), enc.shape
        assert bool(torch.isfinite(enc.float()).all()), "non-finite encoder output"
        assert np.isfinite(scores).all(), f"non-finite scores {scores}"
        assert len(hyps) == B
        assert counts["depthwise_conv1d"] == n_enc, counts
        assert counts["beam_attend_step"] == n_dec * steps, (counts, steps)
        assert counts["relpos_attention"] == 0, counts  # T_enc=251 < 512
        run = {
            "dtype": dtype_name, "batch": B, "seconds_audio": 10.0,
            "beam": beam, "ctc_weight": ctc_weight, "T_enc": enc.shape[1],
            "steps": steps, "launches": counts, "encode_ms": 1e3 * encode_s,
            "search_ms": 1e3 * search_s,
            "utt_per_s": B / (encode_s + search_s),
            "hyp_lens": [len(h) for h in hyps],
        }
        if dtype_name == "float32":
            # the same search through the plain PyTorch versions
            asr.set_kernels(False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc_p = asr.encode(sig, lens)
            torch.cuda.synchronize()
            plain_encode_s = time.perf_counter() - t0
            # the plain search starts from the kernel route's encoder
            # states, so that it holds the beam-cache kernel alone; the
            # two encoders are compared just below
            hyps_p, scores_p, steps_p, plain_search_s = _search(
                asr, enc, lens, beam, ctc_weight)
            asr.set_kernels(True)
            err = _err(enc, enc_p)
            # f32 on both routes; only summation order differs, 12 layers deep
            tol = 1e-3
            assert err <= tol, f"encoder kernel vs plain: {err} > {tol}"
            assert hyps == hyps_p, "hypotheses differ between kernels and plain"
            run.update({
                "enc_max_abs_err_vs_plain": err, "enc_tol": tol,
                "hyps_equal_plain": True,
                "score_max_abs_diff_vs_plain": float(np.abs(scores - scores_p).max()),
                "plain_encode_ms": 1e3 * plain_encode_s,
                "plain_search_ms": 1e3 * plain_search_s,
                "plain_utt_per_s": B / (plain_encode_s + plain_search_s),
            })
        run["profile"] = _profile_search(asr, enc, lens, beam, ctc_weight)
        emit({"phase": "serve", **run})
        runs[dtype_name] = run
        del asr
    return runs


def phase_long():
    """Encode an utterance long enough for T_enc = 512 (rel-pos kernel)."""
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.asr import CONFORMER_SMALL, ConformerASR

    B = 2
    samples = 160 * 2044  # 20.44 s -> 2045 frames -> 1023 -> 512
    sig, lens = _synthetic(B, samples, SEED + 1)
    lens = torch.tensor([1.0, 0.9], device="cuda")
    asr = ConformerASR(CONFORMER_SMALL, seed=SEED)
    with torch.no_grad():
        t_front = asr.frontend(asr.normalize(asr.fbank(sig), lens)).shape[1]
    asr.encode(sig, lens)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counters()
    t0 = time.perf_counter()
    enc = asr.encode(sig, lens)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    counts = ops.launch_counters()
    n_enc = CONFORMER_SMALL["num_encoder_layers"]
    assert t_front == 512 and enc.shape == (B, 512, CONFORMER_SMALL["d_model"]), (
        t_front, enc.shape)
    assert bool(torch.isfinite(enc).all()), "non-finite encoder output"
    assert counts["relpos_attention"] == n_enc, counts
    assert counts["depthwise_conv1d"] == n_enc, counts
    asr.set_kernels(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_p = asr.encode(sig, lens)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = _err(enc, enc_p)
    tol = 1e-3  # f32 on both routes, 12 layers deep
    assert err <= tol, f"long encode kernel vs plain: {err} > {tol}"
    run = {"phase": "long", "batch": B, "seconds_audio": samples / 16000,
           "T_enc": 512, "launches": counts, "encode_ms": 1e3 * encode_s,
           "plain_encode_ms": 1e3 * plain_s, "enc_max_abs_err_vs_plain": err,
           "enc_tol": tol}
    emit(run)
    return run


def kernels_line(records, serve, long_run):
    """The summary line: one entry per kernel at its main-path shape
    (float32; the bfloat16 numbers beside), launches from the main-path
    runs (serve f32 + bf16, long), each counted from 0."""
    launches = {}
    for run in (serve["float32"], serve["bfloat16"], long_run):
        for name, c in run["launches"].items():
            launches[name] = launches.get(name, 0) + c
    out = []
    for name, (source, replaces) in KERNEL_INFO.items():
        pick = [r for r in records if r["name"] == name
                and (name != "relpos_attention" or r["shape"][2] == 512)]
        by_dtype = {r["dtype"]: r for r in pick}
        main = by_dtype["float32"]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name]}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape"):
            entry[key] = main[key]
        entry["bfloat16"] = {k: by_dtype["bfloat16"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        out.append(entry)
    assert all(e["launches"] > 0 for e in out), launches
    return {"kernels": out}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import speechbrain_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the same convolution algorithms in every run, so that a run's
    # decode (a chaotic function of the encoder's last bits) repeats
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "setup", "allow_tf32": {"matmul": False, "cudnn": False},
          "cudnn_deterministic": True,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    records = phase_kernels()
    serve = phase_serve()
    long_run = phase_long()
    emit(kernels_line(records, serve, long_run))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
