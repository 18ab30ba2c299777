"""Manifests and audio files on the host, and ``length_to_mask``.

Copies of ``speechbrain_tpu/dataio/dataio.py``'s ``load_data_json``,
``load_data_csv``, ``read_audio`` and ``read_audio_multichannel`` (the
port imports nothing of the
JAX package): WAV through the stdlib ``wave`` module (PCM 16/24/32-bit;
``scipy.io.wavfile`` for IEEE float), NIST SPHERE and ``.npy`` in
numpy, and FLAC through the native decoder (``native/``), which raises
without ``g++``.  Audio comes back as float32 numpy;
``length_to_mask`` is the torch counterpart of the JAX function.
"""

import csv
import json
import logging
import os
import re

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["load_data_json", "load_data_csv", "read_audio",
           "read_audio_multichannel", "length_to_mask"]


def load_data_json(json_path, replacements={}):
    """Load a JSON manifest of the form {id: {key: value...}}.

    String values get ``$key`` substrings replaced via ``replacements``
    (e.g. ``{"data_root": "/corpora/LibriSpeech"}``).

    Example
    -------
    >>> import tempfile, json as J
    >>> f = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
    >>> _ = f.write(J.dumps({"u1": {"wav": "$root/a.wav", "length": 1.0}}))
    >>> f.close()
    >>> load_data_json(f.name, {"root": "/data"})["u1"]["wav"]
    '/data/a.wav'
    """
    with open(json_path) as f:
        out_json = json.load(f)
    for data_key in out_json:
        for field in out_json[data_key]:
            value = out_json[data_key][field]
            if isinstance(value, str):
                for repl_key, repl_value in replacements.items():
                    value = value.replace("$" + repl_key, repl_value)
                out_json[data_key][field] = value
    return out_json


def load_data_csv(csv_path, replacements={}):
    """Load a CSV manifest (must have an ID column) into a dict-of-dicts.

    Supports ``$key`` replacements and converts a ``duration`` column to
    float.
    """
    with open(csv_path, newline="") as csvfile:
        result = {}
        reader = csv.DictReader(csvfile, skipinitialspace=True)
        variable_finder = re.compile(r"\$([\w.]+)")
        for row in reader:
            try:
                data_id = row["ID"]
                del row["ID"]
            except KeyError:
                raise KeyError(
                    "CSV has to have an 'ID' field, with unique ids for all data points"
                )
            if data_id in result:
                raise ValueError(f"Duplicate id: {data_id}")
            for key, value in row.items():
                if isinstance(value, str):
                    row[key] = variable_finder.sub(
                        lambda match: str(replacements.get(match[1], match[0])),
                        value,
                    )
            if "duration" in row:
                row["duration"] = float(row["duration"])
            result[data_id] = row
    return result


def _read_wav(path, start=0, stop=None):
    """Decode a WAV file to float32 numpy in [-1, 1]; returns (audio, sr).

    Handles PCM 16/24/32-bit and IEEE float WAVs without torchaudio.
    """
    import wave

    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            n_frames = w.getnframes()
            if stop is None:
                stop = n_frames
            start = max(0, int(start))
            stop = min(n_frames, int(stop))
            w.setpos(start)
            raw = w.readframes(stop - start)
        if sampwidth == 2:
            audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif sampwidth == 4:
            audio = (
                np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
            )
        elif sampwidth == 3:
            a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            signed = (
                a[:, 0].astype(np.int32)
                | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16)
            )
            signed = np.where(signed >= 2 ** 23, signed - 2 ** 24, signed)
            audio = signed.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
        if n_channels > 1:
            audio = audio.reshape(-1, n_channels)
        return audio, sr
    except wave.Error:
        # IEEE-float or otherwise non-PCM wav: fall back to scipy.
        from scipy.io import wavfile

        sr, audio = wavfile.read(path)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        elif audio.dtype == np.int32:
            audio = audio.astype(np.float32) / 2147483648.0
        elif audio.dtype == np.uint8:
            audio = (audio.astype(np.float32) - 128.0) / 128.0
        else:
            audio = audio.astype(np.float32)
        if stop is None:
            stop = len(audio)
        return audio[start:stop], sr


def read_audio(waveforms_obj):
    """Read audio to a float32 numpy array (time,) or (time, channels).

    Accepts a path string, or a dict ``{"file": path, "start": s,
    "stop": e}`` for segment reads (sample offsets).
    """
    if isinstance(waveforms_obj, str):
        audio, _ = _load_audio_any(waveforms_obj)
        return audio
    path = waveforms_obj["file"]
    start = int(waveforms_obj.get("start", 0))
    stop = waveforms_obj.get("stop", None)
    audio, _ = _load_audio_any(path, start, stop)
    return audio


def read_audio_multichannel(waveforms_obj):
    """Audio as (time, channels) float32 numpy: a path reads as
    ``read_audio`` (a stereo WAV gives (time, 2), a mono one (time,)); a
    dict ``{"files": [paths], "start": s, "stop": e}`` (or ``"file"``)
    stacks each file's channels side by side.

    Example
    -------
    >>> import tempfile, wave
    >>> path = tempfile.NamedTemporaryFile(suffix=".wav", delete=False).name
    >>> with wave.open(path, "wb") as w:
    ...     w.setnchannels(2); w.setsampwidth(2); w.setframerate(8000)
    ...     w.writeframes(np.array([[0, 16384]] * 5, "<i2").tobytes())
    >>> read_audio_multichannel(path)[0].tolist()
    [0.0, 0.5]
    >>> read_audio_multichannel({"files": [path, path], "stop": 3}).shape
    (3, 4)
    """
    if isinstance(waveforms_obj, str):
        return read_audio(waveforms_obj)
    files = waveforms_obj.get("files", [waveforms_obj.get("file")])
    start = int(waveforms_obj.get("start", 0))
    stop = waveforms_obj.get("stop", None)
    waveforms = []
    for path in files:
        audio, _ = _load_audio_any(path, start, stop)
        waveforms.append(audio[:, None] if audio.ndim == 1 else audio)
    return np.concatenate(waveforms, axis=-1)


def _read_sphere(path, start=0, stop=None):
    """Decode a NIST SPHERE file (TIMIT's .WAV container) to float32.

    The header is ASCII ``key -type value`` lines in a fixed-size
    block; samples follow as PCM (optionally ulaw).
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"Not a NIST SPHERE file: {path}")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.split()
            if len(parts) >= 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
            elif line.strip() == "end_head":
                break
        sr = int(fields.get("sample_rate", 16000))
        n_bytes = int(fields.get("sample_n_bytes", 2))
        n_channels = int(fields.get("channel_count", 1))
        n_samples = int(fields.get("sample_count", -1))
        coding = fields.get("sample_coding", "pcm")
        byte_fmt = fields.get("sample_byte_format", "01")
        f.seek(header_size)
        raw = f.read()
    if coding.startswith("ulaw"):
        u = ~np.frombuffer(raw, dtype=np.uint8).astype(np.int32) & 0xFF
        sign = u & 0x80
        exponent = (u >> 4) & 0x07
        mantissa = u & 0x0F
        mag = ((mantissa << 3) + 0x84) << exponent
        pcm = np.where(sign, 0x84 - mag, mag - 0x84).astype(np.float32)
        audio = pcm / 32768.0
    elif n_bytes == 2:
        dt = "<i2" if byte_fmt == "01" else ">i2"
        audio = np.frombuffer(raw, dtype=dt).astype(np.float32) / 32768.0
    elif n_bytes == 1:
        audio = (
            np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
        )
    else:
        raise ValueError(f"Unsupported SPHERE sample width: {n_bytes}")
    if n_samples > 0:
        audio = audio[: n_samples * n_channels]
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels)
    if stop is None:
        stop = len(audio)
    return audio[int(start):int(stop)], sr


def _load_audio_any(path, start=0, stop=None):
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave", ""):
        # TIMIT ships SPHERE files with a .WAV extension: sniff magic.
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"NIST":
            return _read_sphere(path, start, stop)
        return _read_wav(path, start, stop)
    if ext == ".sph":
        return _read_sphere(path, start, stop)
    if ext == ".npy":
        audio = np.load(path).astype(np.float32)
        return audio[start:stop], 16000
    if ext == ".flac":
        # The native C++ decoder (covers LibriSpeech); there is no
        # other: without g++ a FLAC file cannot be read.
        from .. import native

        result = native.flac_decode(path)
        if result is None:
            raise ImportError(
                "FLAC decode needs the native library (g++); convert to "
                "WAV otherwise.")
        audio, sr = result
        return audio[start:stop], sr
    raise ValueError(f"Unsupported audio format: {ext}")


def length_to_mask(length, max_len=None, dtype=None):
    """Binary mask (batch, max_len) from absolute lengths.

    Example
    -------
    >>> length_to_mask(torch.tensor([2, 3]), max_len=4).int()
    tensor([[1, 1, 0, 0],
            [1, 1, 1, 0]], dtype=torch.int32)
    """
    length = torch.as_tensor(length)
    if max_len is None:
        max_len = int(length.max())
    positions = torch.arange(max_len, device=length.device)[None, :]
    mask = positions < length[:, None]
    if dtype is not None:
        mask = mask.to(dtype)
    return mask
