"""The port's tokenizer (``tokenizers.SentencePiece``, with its native
trainer and encoder in ``native/``) against the JAX package's.

On one synthetic corpus, for unigram and BPE, on the native and the
Python path each against JAX's same path: the same pieces, scores and
merges, the same ids from ``encode_as_ids``, ``decode_ids`` gives back
the text, and each package loads the other's ``model.json``.  The
recipe-facing ``SentencePiece`` trains from a JSON and a CSV manifest
to the JAX model and decodes batches as JAX does.  The native library
is built into ``build/native/`` (never beside the sources) with an
atomic rename, so processes that build at once never load a
half-written file.  The native cases skip only where ``g++`` is
missing.
"""

import json
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

from speechbrain_tpu import native as jnative
from speechbrain_tpu.tokenizers.SentencePiece import BPEModel as JBPEModel
from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JSentencePiece,
)
from speechbrain_tpu_torch import native
from speechbrain_tpu_torch.tokenizers.SentencePiece import (
    BPEModel,
    SentencePiece,
)

from .test_torch_kernels import one_torch_thread  # noqa: F401

HAVE_GXX = shutil.which("g++") is not None


def _corpus(n_sentences=150, seed=0):
    rnd = random.Random(seed)
    words = ["".join(rnd.choices("abcdefghijklmnop", k=rnd.randint(2, 8)))
             for _ in range(80)]
    return [" ".join(rnd.choices(words, k=rnd.randint(3, 10)))
            for _ in range(n_sentences)]


CORPUS = _corpus()


def _paths():
    out = []
    for model_type in ("unigram", "bpe"):
        out.append(pytest.param(model_type, False, id=f"{model_type}-python"))
        out.append(pytest.param(
            model_type, True, id=f"{model_type}-native",
            marks=pytest.mark.skipif(not HAVE_GXX, reason="g++ missing")))
    return out


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(model_type, use_native):
        key = (model_type, use_native)
        if key not in cache:
            size = 70 if model_type == "unigram" else 60
            cache[key] = (
                BPEModel(vocab_size=size, model_type=model_type,
                         use_native=use_native).train(CORPUS),
                JBPEModel(vocab_size=size, model_type=model_type,
                          use_native=use_native).train(CORPUS),
            )
        return cache[key]

    return get


@pytest.mark.parametrize("model_type,use_native", _paths())
def test_same_model_as_jax(trained, model_type, use_native):
    port, ref = trained(model_type, use_native)
    if use_native:  # the native path is taken where the library loads
        assert native.get_lib() is not None
        assert port._native_encoder() is not None
    assert port.pieces == ref.pieces
    assert port.scores == ref.scores
    assert port.merges == ref.merges
    assert len(port.pieces) > 20


@pytest.mark.parametrize("model_type,use_native", _paths())
def test_same_ids_and_roundtrip(trained, model_type, use_native):
    port, ref = trained(model_type, use_native)
    for text in CORPUS[:40] + ["ab cd unseenzz"]:
        ids = port.encode_as_ids(text)
        assert ids == ref.encode_as_ids(text)
        assert port.encode_as_pieces(text) == ref.encode_as_pieces(text)
        if text in CORPUS:
            assert port.decode_ids(ids) == text


@pytest.mark.parametrize("model_type,use_native", _paths())
def test_each_loads_the_others_model(trained, tmp_path, model_type,
                                     use_native):
    port, ref = trained(model_type, use_native)
    port.save(str(tmp_path / "port.model.json"))
    ref.save(str(tmp_path / "jax.model.json"))
    assert json.load(open(tmp_path / "port.model.json")) == json.load(
        open(tmp_path / "jax.model.json"))
    from_jax = BPEModel.load(str(tmp_path / "jax.model.json"))
    from_port = JBPEModel.load(str(tmp_path / "port.model.json"))
    for text in CORPUS[:20]:
        ids = ref.encode_as_ids(text)
        assert from_jax.encode_as_ids(text) == ids
        assert from_port.encode_as_ids(text) == ids


@pytest.mark.parametrize("annotation_format", ["json", "csv"])
def test_sentencepiece_from_manifest(tmp_path, annotation_format):
    """Train-or-load from a manifest: the same model file as JAX's, a
    second construction loads it, and ``__call__``'s tasks agree."""
    rows = {f"u{i}": {"words": s.upper(), "duration": 1.0}
            for i, s in enumerate(CORPUS[:60])}
    path = tmp_path / f"train.{annotation_format}"
    if annotation_format == "json":
        path.write_text(json.dumps(rows))
    else:
        path.write_text("ID,duration,words\n" + "".join(
            f"{k},{v['duration']},{v['words']}\n" for k, v in rows.items()))
    kw = dict(vocab_size=50, annotation_train=str(path),
              annotation_read="words", model_type="unigram",
              annotation_format=annotation_format)
    port = SentencePiece(model_dir=str(tmp_path / "port"), **kw)
    ref = JSentencePiece(model_dir=str(tmp_path / "jax"), **kw)
    name = "50_unigram.model.json"
    assert (tmp_path / "port" / name).read_text() == (
        tmp_path / "jax" / name).read_text()
    again = SentencePiece(model_dir=str(tmp_path / "port"), vocab_size=50,
                          model_type="unigram")
    texts = [rows["u0"]["words"], rows["u1"]["words"]]
    ids, lens = again(texts)
    ref_ids, ref_lens = ref(texts)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(lens, ref_lens)
    assert again(ids.tolist(), lens, task="decode") == ref(
        ref_ids.tolist(), ref_lens, task="decode")
    assert again(ids.tolist(), lens, task="decode")[0] == texts[0].split(" ")
    assert again([ids[1].tolist()], task="decode_from_list") == ref(
        [ref_ids[1].tolist()], task="decode_from_list")


@pytest.mark.skipif(not HAVE_GXX, reason="g++ missing")
def test_native_encoder_is_thread_safe(trained):
    """The recipe's loader encodes from several worker threads with one
    tokenizer: 8 threads encoding at once give the serial ids."""
    from concurrent.futures import ThreadPoolExecutor

    port, _ = trained("unigram", True)
    texts = CORPUS * 4
    want = [port.encode_as_ids(t) for t in texts]
    for _ in range(3):
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(port.encode_as_ids, texts))
        assert got == want


@pytest.mark.skipif(not HAVE_GXX, reason="g++ missing")
def test_native_library_builds_into_build_dir():
    """The library lands in ``build/native/`` under a name hashed from
    the sources and flags, never beside the sources, and the JAX
    package's own library is a separate file."""
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libsb_native_") and path.exists()
    assert not list(native._DIR.glob("*.so"))
    assert native.get_lib() is not None and jnative.get_lib() is not None


@pytest.mark.skipif(not HAVE_GXX, reason="g++ missing")
def test_concurrent_builds_are_atomic(tmp_path):
    """Four processes that build into one empty directory at once all
    load a whole library: each writes its own temporary file and
    renames it into place."""
    code = (
        "import sys; from pathlib import Path\n"
        "import speechbrain_tpu_torch.native as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "assert n.get_lib() is not None\n"
        "print(n.NativeEncoder('TYPE bpe\\nUNK 0\\nSPECIAL <unk>\\n"
        "PIECE <unk> 0.0\\nPIECE \\u2581 0.0\\nPIECE a 0.0').encode('a a'))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out for out, _ in outs}) == 1
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]
