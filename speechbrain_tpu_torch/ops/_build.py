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

import torch

__all__ = [
    "KERNELS", "BUILD_DIR", "CSRC_DIR", "build", "load", "Entry",
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

# Loaded libraries by kernel name: a cache of read-only handles, filled
# once per process.
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
# as c_void_p, so ctypes never truncates it to a 32-bit int; I64 for a
# stride or size that may pass 2^31.
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
I64 = ctypes.c_longlong


class Entry:
    """C function ``fn_name`` of library ``lib_name`` with its argument
    and result types declared (a launch returns ``cudaGetLastError()`` as
    an int).  A wrapper makes one per function when its module is
    imported; the library is loaded (built if need be) and the function
    bound at the first call, once per process, and every later call goes
    straight to the bound function."""

    __slots__ = ("lib_name", "fn_name", "argtypes", "restype", "fn")

    def __init__(self, lib_name, fn_name, argtypes, restype=ctypes.c_int):
        self.lib_name, self.fn_name = lib_name, fn_name
        self.argtypes, self.restype = list(argtypes), restype
        self.fn = None

    def __call__(self, *args):
        fn = self.fn
        if fn is None:
            fn = getattr(load(self.lib_name), self.fn_name)
            fn.argtypes = self.argtypes
            fn.restype = self.restype
            self.fn = fn
        return fn(*args)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t):
    """0 for float32, 1 for bfloat16: the storage types the kernels take."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


# The raw handle of a device's current stream, as an int, without the
# torch.cuda.Stream object that current_stream() builds; PyTorch's own
# code generators call the same function.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t):
    """PyTorch's current CUDA stream on ``t``'s device, as a handle."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad(), or "
            "call the differentiable function that uses it")
