"""Native (C++) host code: the tokenizer's trainer and encoder and the
FLAC decoder.

Copies of ``speechbrain_tpu/native/`` (``sb_tokenizer.cc``,
``sb_audio.cc`` and their ctypes binding).  The sources are compiled at
first use with ``g++ -O3 -std=c++17 -shared -fPIC`` into one library,
``build/native/libsb_native_<hash>.so`` under the repository root,
never beside the sources.  The hash covers the sources and the flags,
so an edited source is never served from a stale build, and the
library is written under a temporary name and renamed into place, so
processes that build at once never load a half-written file.

This is host code, not a device kernel.  Where ``g++`` is missing,
``get_lib()`` returns None and every caller takes its Python path
(FLAC then raises: there is no other decoder).
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["BUILD_DIR", "build", "get_lib", "tok_train", "NativeEncoder",
           "flac_decode"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SOURCES = ("sb_tokenizer.cc", "sb_audio.cc")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.RLock()  # get_lib() -> build() re-enters
_lib = None
_tried = False


def _lib_path():
    digest = hashlib.sha1(
        b"".join((_DIR / s).read_bytes() for s in _SOURCES)
        + " ".join(_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libsb_native_{digest}.so"


def build():
    """Compile the native library unless it is built; returns its path.
    Raises where ``g++`` is missing or fails."""
    with _lock:
        out = _lib_path()
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [gxx, *_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in _SOURCES)]
        logger.info("Building native library: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)  # atomic: a half-written .so is never loaded
        return out


def get_lib():
    """The loaded native library, or None when it cannot be built."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    # _tried is read under the lock only: a thread that sees it set
    # before _lib is assigned would take the Python path for no reason.
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            lib.sb_tok_train.restype = ctypes.c_void_p  # manual free
            lib.sb_tok_train.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_char_p,
            ]
            lib.sb_free.argtypes = [ctypes.c_void_p]
            lib.sb_tok_load.restype = ctypes.c_void_p
            lib.sb_tok_load.argtypes = [ctypes.c_char_p]
            lib.sb_tok_unload.argtypes = [ctypes.c_void_p]
            lib.sb_tok_encode.restype = ctypes.c_int
            lib.sb_tok_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
            lib.sb_flac_decode.restype = ctypes.c_int
            lib.sb_flac_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.sb_free_f32.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        except Exception as err:
            logger.warning("Native library unavailable (%s); using Python",
                           err)
            _lib = None
    return _lib


def tok_train(sentences, vocab_size, model_type, special_tokens):
    """Train natively; returns the model blob string or None."""
    lib = get_lib()
    if lib is None or model_type not in ("bpe", "unigram"):
        return None
    corpus = "\n".join(sentences).encode("utf-8")
    ptr = lib.sb_tok_train(corpus, int(vocab_size), model_type.encode(),
                           " ".join(special_tokens).encode())
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.sb_free(ptr)


class NativeEncoder:
    """ctypes handle around the native encoder.  ``encode`` may be called
    from several threads at once (the loader's workers share one
    tokenizer): the model is read-only on the C side, and each call
    writes its ids into a buffer of its own."""

    def __init__(self, blob):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.sb_tok_load(blob.encode("utf-8"))

    def encode(self, text):
        """Token ids for whitespace-split text."""
        data = text.encode("utf-8")
        # a piece holds one character or more, and each word adds its
        # boundary marker: at most 2 ids a byte, plus one
        buf = (ctypes.c_int32 * (2 * len(data) + 1))()
        n = self._lib.sb_tok_encode(self._h, data, buf, len(buf))
        if n > len(buf):
            buf = (ctypes.c_int32 * n)()
            n = self._lib.sb_tok_encode(self._h, data, buf, len(buf))
        return list(buf[:n])

    def close(self):
        """Release the native model."""
        if getattr(self, "_h", None):
            self._lib.sb_tok_unload(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def flac_decode(path):
    """Decode a FLAC file natively.

    Returns ``(audio, sample_rate)`` with float32 ``audio`` shaped
    (frames,) for mono or (frames, channels); None when the native
    library is unavailable.  Raises ValueError on malformed files.
    """
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    code = lib.sb_flac_decode(os.fspath(path).encode(), ctypes.byref(out),
                              ctypes.byref(n_frames), ctypes.byref(channels),
                              ctypes.byref(rate))
    if code != 0:
        raise ValueError(f"FLAC decode failed ({code}): {path}")
    try:
        n = n_frames.value * channels.value
        audio = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.sb_free_f32(out)
    if channels.value > 1:
        audio = audio.reshape(n_frames.value, channels.value)
    return audio, rate.value
