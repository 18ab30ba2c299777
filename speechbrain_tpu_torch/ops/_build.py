"""Builds the CUDA kernels in ``csrc/`` with ``nvcc`` and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/kernels/lib<name>_<hash>.so`` under the repository
root, loaded with ``ctypes``.  The hash covers the source, the
``csrc/*.cuh`` headers it includes and the compiler flags, so an edited
source or header is never served from a stale build.
Building happens at first use (or up front through ``build()``, which
starts one ``nvcc`` per source, all at once); nothing is built when a
module is imported, and nothing here runs on a machine without
``nvcc`` unless a kernel is actually launched.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = [
    "KERNELS", "BUILD_DIR", "CSRC_DIR", "build", "load", "entry",
    "dtype_code", "stream_of", "check_launch", "refuse_grad",
]

KERNELS = ("depthwise_conv", "relpos_attention", "relpos_attention_bwd", "ctc",
           "beam_cache", "transducer")
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Loaded libraries by kernel name, and their bound entry points by
# (library, function): a cache of read-only handles, filled once per
# process.
_LOADED = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _lib_path(name):
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = sorted(set(_INCLUDE.findall(src)))  # csrc/ headers, one level
    digest = hashlib.sha1(
        src + b"".join((CSRC_DIR / h.decode()).read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=KERNELS):
    """Compile every library in ``names`` that is not built yet.

    One ``nvcc`` process per source, all started together; waits for
    all of them and raises with the compiler's output if any failed.
    ``ptxas -v`` reports (registers, shared memory, spills) go to
    ``build/kernels/<name>.log``.  Returns the wall seconds spent.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written .so is never loaded
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name):
    """The ``ctypes.CDLL`` of kernel library ``name``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


# Argument kinds of the C entry points: every pointer (and the stream)
# as c_void_p, so ctypes never truncates it to a 32-bit int.
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def entry(lib_name, fn_name, argtypes, restype=ctypes.c_int):
    """C function ``fn_name`` of library ``lib_name`` with its argument
    and result types declared (a launch returns ``cudaGetLastError()`` as
    an int)."""
    fn = _LOADED.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _LOADED[(lib_name, fn_name)] = fn
    return fn


def dtype_code(t):
    """0 for float32, 1 for bfloat16: the storage types the kernels take."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def stream_of(t):
    """PyTorch's current CUDA stream on ``t``'s device, as a handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc, what):
    """Raise if a kernel launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def refuse_grad(what, *tensors):
    """Raise if autograd would record this call: the kernel behind it has
    no backward of its own (it runs inside an autograd Function's
    forward or backward, where grad mode is off), so a result without a
    gradient must not pass silently."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad(), or "
            "call the differentiable function that uses it")
