#!/usr/bin/env python3
"""Shape study of the RNN-T warp-chain kernels (K8 alpha, K9 beta and
gradients, ``speechbrain_tpu_torch/csrc/transducer.cu``) on a CUDA card.

The C entries take no shape argument: a lattice of up to CHAIN_COLS
columns gets W = ceil((U+1)/32) chain warps with R = ROLES_K8 / ROLES_K9
role warps each, a wider one the block path.  This study builds copies
of the source with those constants rewritten (1, 2 or 3 role warps;
CHAIN_COLS 0 for the block path; "const": W and R compiled into the
kernels instead of passed as arguments) into ``build/study/`` with the
package's nvcc flags, checks every variant against the plain PyTorch versions (alpha
and final relative 2e-5, gradients absolute 2e-3, as ``chip_smoke.py``),
then times it: device ms a call from the profiler.  Shapes: B 12, T 251
at U 64 (the training shape) and U 159 (U+1 = 160, the widest lattice of
the warp-chain path, where the threshold lies).

    python3 tools/transducer_chain_study.py

Prints the card's name and power limit, then one JSON object:
{shape: {kernel: {variant: device ms}}}.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROLES = "constexpr int ROLES_K8 = 2, ROLES_K9 = 3;"
COLS = "constexpr int CHAIN_COLS = 160;"
VARIANTS = {
    **{f"r{r}": [(ROLES, f"constexpr int ROLES_K8 = {r}, ROLES_K9 = {r};")]
       for r in (1, 2, 3)},
    "block": [(COLS, "constexpr int CHAIN_COLS = 0;")],
    "const": [(f"float* __restrict__ {out}, int T, int U,\n{pad}int W, int R) {{",
               f"float* __restrict__ {out}, int T, int U,\n{pad}int, int) {{\n"
               f"  constexpr int R = {roles};\n  const int W = (U + 32) / 32;")
              for out, pad, roles in (("final_lp", " " * 34, "ROLES_K8"),
                                      ("demit", " " * 38, "ROLES_K9"))],
}
SHAPES = [(12, 251, 64), (12, 251, 159)]


def build():
    """{variant: ctypes library}, one nvcc per variant, all at once."""
    from speechbrain_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "transducer.cu").read_text()
    out = ROOT / "build" / "study"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            assert old in text, f"{name}: {old!r} not in transducer.cu"
            text = text.replace(old, new)
        cu, lib = out / f"transducer_{name}.cu", out / f"libtransducer_{name}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        libs[name].sb_transducer_alpha.argtypes = [P] * 6 + [I] * 3 + [P]
        libs[name].sb_transducer_beta_grad.argtypes = [P] * 8 + [I] * 3 + [P]
    return libs


def study(libs, B, T, U):
    import torch

    from speechbrain_tpu_torch import ops
    from speechbrain_tpu_torch.ops import transducer as ot

    logits, targets, tlen, ulen = cs._transducer_inputs(B, T, U, 16,
                                                        cs.SEED + U)
    with torch.no_grad():
        blank, emit = ot.transducer_tables(torch.log_softmax(logits, -1),
                                           targets, 0, tlen, ulen)
    tl, ul = ot._validated(tlen, ulen, T, U, blank.device, "study")
    alpha_p, final_p = ops.transducer_alpha_plain(blank, emit, tlen, ulen)
    grads_p = ops.transducer_beta_grad_plain(blank, emit, alpha_p, tlen, ulen,
                                             final_p)
    alpha, final = torch.empty_like(blank), torch.empty(B, device="cuda")
    db, de = torch.empty_like(blank), torch.empty_like(emit)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"transducer_alpha": {}, "transducer_beta_grad": {}}
    for name, lib in libs.items():
        def k8():
            assert lib.sb_transducer_alpha(
                blank.data_ptr(), emit.data_ptr(), tl.data_ptr(),
                ul.data_ptr(), alpha.data_ptr(), final.data_ptr(), B, T, U,
                stream) == 0

        def k9():
            assert lib.sb_transducer_beta_grad(
                blank.data_ptr(), emit.data_ptr(), alpha.data_ptr(),
                tl.data_ptr(), ul.data_ptr(), final.data_ptr(), db.data_ptr(),
                de.data_ptr(), B, T, U, stream) == 0

        k8()
        k9()
        torch.cuda.synchronize()
        rel = max(cs._err(final, final_p) / float(final_p.abs().max()),
                  cs._err(alpha, alpha_p) / float(alpha_p.abs().max()))
        g_err = max((cs._err(x, y) for x, y in zip((db, de), grads_p)
                     if x.numel()), default=0.0)
        assert rel <= 2e-5 and g_err <= 2e-3, (name, U, rel, g_err)
        out["transducer_alpha"][name] = cs._device_ms(k8)[0]
        out["transducer_beta_grad"][name] = cs._device_ms(k9)[0]
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build()
    print(json.dumps({f"B{B} T{T} U{U}": study(libs, B, T, U)
                      for B, T, U in SHAPES}), flush=True)


if __name__ == "__main__":
    main()
