"""The port's data path (``dataio``, ``utils.data_pipeline``,
``utils.depgraph``) against the JAX package's.

One manifest of WAV files in ``tmp_path`` (mixed lengths; 16-, 24- and
32-bit PCM) goes through ``DynamicItemDataset`` -> ``DynamicBatchSampler``
-> ``PaddedBatch`` with the LibriSpeech recipe's ``BatchShapePolicy``
(``recipes/LibriSpeech/ASR/transformer/train.py:273-281``) ->
``SaveableDataLoader`` in each package, with 0 and 2 worker threads:
every batch over two shuffled epochs is the same (keys, shapes, dtypes,
values bit for bit, relative lengths, ``batch_mask``), and so are the
batches left after a mid-epoch recovery.  The samplers give the same
index lists for 3 seeds x 2 epochs x every ``batch_ordering``;
``read_audio`` equals JAX's on WAV, SPHERE and FLAC (the FLAC files from
the in-test encoder of ``tests/unittests/test_native_audio.py``; skipped
only where g++ is missing); the ``DataPipeline`` and ``DependencyGraph``
cases of the JAX unit tests give the same outputs.
"""

import shutil
import wave

import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio import batch as jbatch
from speechbrain_tpu.dataio import dataio as jdataio
from speechbrain_tpu.dataio import dataloader as jloader
from speechbrain_tpu.dataio import dataset as jdataset
from speechbrain_tpu.dataio import sampler as jsampler
from speechbrain_tpu.utils import data_pipeline as jpipeline
from speechbrain_tpu.utils import depgraph as jdepgraph
from speechbrain_tpu_torch.dataio import batch as pbatch
from speechbrain_tpu_torch.dataio import dataio as pdataio
from speechbrain_tpu_torch.dataio import dataloader as ploader
from speechbrain_tpu_torch.dataio import dataset as pdataset
from speechbrain_tpu_torch.dataio import sampler as psampler
from speechbrain_tpu_torch.utils import data_pipeline as ppipeline
from speechbrain_tpu_torch.utils import depgraph as pdepgraph
from tests.unittests.test_native_audio import _int_wave, encode_flac

from .test_torch_kernels import one_torch_thread  # noqa: F401

JAX = dict(batch=jbatch, dataio=jdataio, loader=jloader, dataset=jdataset,
           sampler=jsampler)
PORT = dict(batch=pbatch, dataio=pdataio, loader=ploader, dataset=pdataset,
            sampler=psampler)
SR = 16000


def _write_wav(path, samples, width):
    """Integer samples as PCM of ``width`` bytes a sample."""
    if width == 3:
        raw = np.asarray(samples, "<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        raw = raw.tobytes()
    else:
        raw = np.asarray(samples, f"<i{width}").tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(SR)
        w.writeframes(raw)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """18 utterances of 0.3-2.4 s in 16-, 24- and 32-bit PCM, with
    transcripts of 1-12 tokens."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    data = {}
    for i in range(18):
        width = (2, 3, 4)[i % 3]
        n = int(rng.uniform(0.3, 2.4) * SR)
        peak = 2 ** (8 * width - 1) - 1
        samples = np.clip(rng.normal(0, 0.2, n), -1, 1) * peak
        path = root / f"u{i:02d}.wav"
        _write_wav(path, samples.astype(np.int64), width)
        data[f"u{i:02d}"] = {
            "wav": str(path), "duration": n / SR,
            "words": " ".join(str(t) for t in
                               rng.integers(3, 40, rng.integers(1, 13))),
        }
    path = root / "train.json"
    import json

    path.write_text(json.dumps(data))
    return str(path)


def _loader(pkg, manifest, num_workers, seed=11):
    """The recipe's train loader in package ``pkg``."""
    ds = pkg["dataset"].DynamicItemDataset.from_json(manifest)
    ds.add_dynamic_item(pkg["dataio"].read_audio, takes="wav", provides="sig")

    def text(words):
        ids = [int(t) for t in words.split()]
        return (np.asarray(ids, np.int64), np.asarray([1] + ids, np.int64),
                np.asarray(ids + [2], np.int64))

    ds.add_dynamic_item(text, takes="words",
                        provides=["tokens", "tokens_bos", "tokens_eos"])
    ds.set_output_keys(["id", "sig", "tokens", "tokens_bos", "tokens_eos"])
    sampler = pkg["sampler"].DynamicBatchSampler(
        ds, max_batch_length=6, num_buckets=4, shuffle=True, seed=seed)
    policy = pkg["batch"].BatchShapePolicy(
        time_buckets=[int(b * SR) for b in sampler.bucket_boundaries],
        time_keys=("sig",),
        key_buckets={k: [16, 32] for k in ("tokens", "tokens_bos",
                                           "tokens_eos")},
        batch_buckets=[2, 4, 8, 16],
    )
    return pkg["loader"].SaveableDataLoader(
        ds, batch_sampler=sampler, num_workers=num_workers,
        collate_fn=lambda ex: pkg["batch"].PaddedBatch(ex,
                                                       shape_policy=policy))


def _assert_same_batch(p, j):
    assert p.batch_keys == j.batch_keys and p.padded_keys == j.padded_keys
    assert p.id == j.id
    pn, jn = p.numeric_dict(), j.numeric_dict()
    assert list(pn) == list(jn)
    for k in jn:
        assert pn[k].shape == jn[k].shape and pn[k].dtype == jn[k].dtype, k
        np.testing.assert_array_equal(pn[k], jn[k], err_msg=k)


def _epoch(loader, epoch, limit=None):
    loader.batch_sampler.set_epoch(epoch)
    out = []
    for b in loader:
        out.append(b)
        if limit is not None and len(out) == limit:
            break
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
def test_same_batches_over_two_epochs(manifest, num_workers):
    port, ref = (_loader(PORT, manifest, num_workers),
                 _loader(JAX, manifest, num_workers))
    shapes = set()
    for epoch in (1, 2):
        got, want = _epoch(port, epoch), _epoch(ref, epoch)
        assert len(got) == len(want) > 2
        for p, j in zip(got, want):
            _assert_same_batch(p, j)
            shapes.add(p.sig.data.shape)
    # the case this guards: several buckets, and dummy rows of length 0
    assert len(shapes) > 1
    assert any("batch_mask" in b.numeric_dict() for b in got)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_same_batches_after_mid_epoch_recovery(manifest, tmp_path,
                                               num_workers):
    """Save the position after 2 batches of epoch 2, recover a fresh
    loader in each package: the remaining batches are the same."""
    for name, pkg in (("port", PORT), ("jax", JAX)):
        loader = _loader(pkg, manifest, num_workers)
        loader.batch_sampler.set_epoch(2)
        it = iter(loader)
        next(it), next(it)
        loader._save(str(tmp_path / f"{name}.pos"))
        it.close()
    assert (tmp_path / "port.pos").read_text() == "2"
    rest = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        loader = _loader(pkg, manifest, num_workers)
        loader._recover(str(tmp_path / f"{name}.pos"), end_of_epoch=False)
        rest[name] = _epoch(loader, 2)
    full = _epoch(_loader(JAX, manifest, 0), 2)
    assert len(rest["port"]) == len(rest["jax"]) == len(full) - 2
    for p, j, f in zip(rest["port"], rest["jax"], full[2:]):
        _assert_same_batch(p, j)
        _assert_same_batch(p, f)


@pytest.mark.parametrize("ordering",
                         ["random", "random_runs", "ascending", "descending"])
def test_sampler_same_indices(manifest, ordering):
    for seed in (0, 1, 42):
        made = []
        for pkg in (PORT, JAX):
            ds = pkg["dataset"].DynamicItemDataset.from_json(manifest)
            made.append(pkg["sampler"].DynamicBatchSampler(
                ds, max_batch_length=5, num_buckets=3, shuffle=True,
                batch_ordering=ordering, seed=seed, run_length=2))
        port, ref = made
        assert port.bucket_boundaries == ref.bucket_boundaries
        for epoch in (1, 2):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(port) == list(ref)
            assert list(port) == list(ref)  # the re-draw after a pass
            assert len(port) == len(ref)
        p = psampler.ReproducibleRandomSampler(range(9), seed=seed)
        j = jsampler.ReproducibleRandomSampler(range(9), seed=seed)
        for epoch in (1, 2):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j)


def _sphere(path, pcm_int16):
    hdr = "\n".join([
        "NIST_1A", "   1024", f"sample_rate -i {SR}", "channel_count -i 1",
        "sample_n_bytes -i 2", f"sample_count -i {len(pcm_int16)}",
        "sample_byte_format -s2 01", "sample_coding -s3 pcm", "end_head",
    ]).encode("ascii") + b"\n"
    with open(path, "wb") as f:
        f.write(hdr + b" " * (1024 - len(hdr))
                + np.asarray(pcm_int16, "<i2").tobytes())


def test_read_audio_wav_and_sphere(tmp_path):
    rng = np.random.default_rng(4)
    files = []
    for width in (2, 3, 4):
        peak = 2 ** (8 * width - 1) - 1
        samples = (np.clip(rng.normal(0, 0.3, 1000), -1, 1) * peak)
        files.append(tmp_path / f"w{width}.wav")
        _write_wav(files[-1], samples.astype(np.int64), width)
    from scipy.io import wavfile

    files.append(tmp_path / "float.wav")  # IEEE float: the scipy path
    wavfile.write(files[-1], SR, rng.normal(0, 0.1, 500).astype(np.float32))
    files.append(tmp_path / "sph.WAV")  # SPHERE behind a .WAV name
    _sphere(files[-1], (rng.normal(0, 0.2, 800) * 32767).astype(np.int16))
    files.append(tmp_path / "sph.sph")
    _sphere(files[-1], (rng.normal(0, 0.2, 300) * 32767).astype(np.int16))
    np.save(tmp_path / "a.npy", rng.normal(size=400).astype(np.float32))
    files.append(tmp_path / "a.npy")
    for f in files:
        for spec in (str(f), {"file": str(f), "start": 50, "stop": 250}):
            got, want = pdataio.read_audio(spec), jdataio.read_audio(spec)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=str(f))


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ missing")
@pytest.mark.parametrize("bps,channels", [(16, 1), (24, 1), (16, 2)])
def test_read_audio_flac(tmp_path, bps, channels):
    chans = [_int_wave(700, bps, seed=c).tolist() for c in range(channels)]
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(chans, SR, bps, 256, "lpc2"))
    for spec in (str(path), {"file": str(path), "start": 10, "stop": 400}):
        got, want = pdataio.read_audio(spec), jdataio.read_audio(spec)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_length_to_mask_matches_jax():
    lengths = np.array([0, 3, 5])
    got = pdataio.length_to_mask(torch.tensor(lengths), max_len=6)
    want = np.asarray(jdataio.length_to_mask(lengths, max_len=6))
    np.testing.assert_array_equal(got.numpy(), want)


def test_manifests_match(tmp_path, manifest):
    csv = tmp_path / "m.csv"
    csv.write_text("ID,duration,wav\nu1,1.5,$root/a.wav\nu2,2,$root/b.wav\n")
    repl = {"root": "/data"}
    assert pdataio.load_data_csv(str(csv), repl) == jdataio.load_data_csv(
        str(csv), repl)
    assert pdataio.load_data_json(manifest) == jdataio.load_data_json(manifest)


# -------------------------------------------- DataPipeline / DependencyGraph


def _pipeline_cases(mod):
    """The JAX unit tests' DataPipeline cases, run on ``mod``; returns
    what each produced (or the exception type it raised)."""
    DataPipeline, takes, provides = mod.DataPipeline, mod.takes, mod.provides
    out = {}
    p = DataPipeline(["text"])
    p.add_dynamic_item(func=lambda t: t.lower(), takes="text", provides="lower")
    p.add_dynamic_item(func=lambda t: t[::-1], takes="lower", provides="rev")
    p.set_output_keys(["rev"])
    out["chained"] = p({"text": "Hello"})

    @takes("a", "b")
    @provides("sum", "diff")
    def math_item(a, b):
        yield a + b
        yield a - b

    out["decorated"] = DataPipeline(["a", "b"], [math_item],
                                    ["sum", "diff"])({"a": 5, "b": 3})
    calls = []

    @takes("x")
    @provides("first", "second")
    def gen(x):
        calls.append("expensive")
        yield x + 1
        yield x + 2

    out["partial"] = (DataPipeline(["x"], [gen], ["first"])({"x": 0}),
                      list(calls))
    computed = []
    p = DataPipeline(["x"])
    p.add_dynamic_item(lambda x: computed.append("a") or x, takes="x",
                       provides="a")
    p.add_dynamic_item(lambda x: computed.append("b") or x, takes="x",
                       provides="b")
    p.set_output_keys(["a"])
    out["lazy"] = (p({"x": 1}), computed)
    p = DataPipeline(["x"])
    p.add_dynamic_item(lambda x: x * 2, takes="x", provides="doubled")
    p.set_output_keys({"renamed": "doubled"})
    out["mapping"] = p({"x": 2})
    p = DataPipeline(["x"])
    p.add_dynamic_item(lambda m: m + 1, takes="mid", provides="final")
    p.add_dynamic_item(lambda x: x * 10, takes="x", provides="mid")
    p.set_output_keys(["final"])
    out["forward"] = p({"x": 1})
    p = DataPipeline(["x"])
    p.add_dynamic_item(lambda m: m, takes="missing", provides="out")
    p.set_output_keys(["out"])
    try:
        p({"x": 1})
    except Exception as e:
        out["unaccounted"] = type(e).__name__
    p = DataPipeline(["x"])
    p.add_dynamic_item(lambda x: x + 1, takes="x", provides="y")
    p.add_dynamic_item(lambda y: y * 2, takes="y", provides="z")
    p.set_output_keys(["z"])
    out["specific"] = p.compute_specific(["y"], {"x": 1})
    return out


def _depgraph_cases(mod):
    out = {}
    g = mod.DependencyGraph()
    for key in "abcde":
        g.add_node(key)
    for a, b in ("ba", "cb", "dc", "ed"):
        g.add_edge(a, b)
    out["order"] = [n.key for n in g.get_evaluation_order()]
    g = mod.DependencyGraph()
    g.add_edge("b", "a")
    g.add_edge("c", "b")
    g.add_edge("z", "y")
    out["selected"] = [n.key for n in g.get_evaluation_order(
        selected_keys=["c"])]
    g = mod.DependencyGraph()
    g.add_edge("a", "b")
    g.add_edge("b", "a")
    out["valid"] = g.is_valid()
    try:
        list(g.get_evaluation_order())
    except mod.CircularDependencyError:
        out["cycle"] = "raised"
    g = mod.DependencyGraph()
    g.add_node("a")
    try:
        g.add_node("a")
    except ValueError:
        out["duplicate"] = "raised"
    g = mod.DependencyGraph()
    g.add_edge("b", "a")
    g.add_node("a", data="payload")
    out["implicit"] = {n.key: n.data for n in g.get_evaluation_order()}
    return out


def test_pipeline_cases_match_jax():
    got, want = _pipeline_cases(ppipeline), _pipeline_cases(jpipeline)
    assert got == want and len(got) == 8


def test_depgraph_cases_match_jax():
    got, want = _depgraph_cases(pdepgraph), _depgraph_cases(jdepgraph)
    assert got == want and got["cycle"] == got["duplicate"] == "raised"


def test_dataset_filtered_sorted_matches_jax(manifest):
    for key, kw in (("duration", {}), ("duration", {"reverse": True})):
        ids = []
        for pkg in (PORT, JAX):
            ds = pkg["dataset"].DynamicItemDataset.from_json(manifest)
            ds.set_output_keys(["id"])
            sub = ds.filtered_sorted(sort_key=key,
                                     key_max_value={"duration": 2.0}, **kw)
            ids.append([sub[i]["id"] for i in range(len(sub))])
        assert ids[0] == ids[1] and 0 < len(ids[0]) < 18
