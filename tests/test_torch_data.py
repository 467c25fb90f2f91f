"""The port's data path against the JAX package on the CPU: the committed
synthetic sets against the JAX renderer, the input pipeline (packing,
batch order, padding, prefetch, the move to the device) and the metrics.
Every comparison here is exact."""

import sys

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu.core import metrics as jmetrics
from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec as JAttnCodec
from multimodal_scene_text_recognition_tpu.data import pipeline as jpipe
from multimodal_scene_text_recognition_tpu.data import synthetic as jsyn
from multimodal_scene_text_recognition_tpu_torch import metrics
from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
from multimodal_scene_text_recognition_tpu_torch.config import DEFAULT_CHARS, SYNTHETIC_DIR
from multimodal_scene_text_recognition_tpu_torch.data import pipeline, synthetic
import torch_threads

torch_threads.limit()

SETS = ((4096, 999), (512, 1000))  # the committed sets: (size, seed)
KEYS = ("image", "text", "overlap", "scene", "ious", "anno_id")


def jax_metadata(size, seed, monkeypatch):
    """JAX ``make_dataset(size, seed)`` with the PIL render replaced by a
    blank crop: the labels and object ids come from its own draws."""
    monkeypatch.setattr(jsyn, "_render", lambda text, rng, h=32, w=100:
                        np.zeros((h, w, 1), np.float32))
    return jsyn.make_dataset(size, seed=seed)


# --- the committed sets ----------------------------------------------------------


def test_committed_files_are_the_renderers_cache_names():
    """Each committed file has the name JAX ``make_dataset(size, seed,
    cache_dir=...)`` looks for, and the port finds both sets."""
    for size, seed in SETS:
        name = jsyn._cache_names(size, seed, 10, jsyn._CHARS_EASY, None, 2000)[0]
        assert synthetic.committed_sets()[seed][1].endswith("/" + name)
    assert {s: n for s, (n, _) in synthetic.committed_sets().items()} == {999: 4096, 1000: 512}


@pytest.mark.parametrize("size,seed", SETS)
def test_committed_metadata_matches_jax_for_every_row(size, seed, monkeypatch):
    """Labels, label rows, object ids, ious and anno ids of every row equal
    the JAX renderer's draws at the set's seed."""
    got = synthetic.make_dataset(size, seed)
    want = jax_metadata(size, seed, monkeypatch)
    assert got.labels == [s.label for s in want]
    codec = JAttnCodec(DEFAULT_CHARS, 25)
    np.testing.assert_array_equal(got.text, codec.encode(got.labels)[0])
    np.testing.assert_array_equal(got.overlap, np.stack([s.overlap for s in want]))
    np.testing.assert_array_equal(got.scene, np.stack([s.scene for s in want]))
    np.testing.assert_array_equal(got.ious, np.stack([s.ious for s in want]))
    np.testing.assert_array_equal(got.anno_id, [s.anno_id for s in want])
    assert got.image.dtype == np.uint8 and got.image.shape == (size, 32, 100, 1)
    assert got.text.dtype == np.int32 and got.overlap.dtype == np.int32


@pytest.mark.parametrize("size,seed", SETS)
def test_committed_images_match_a_fresh_jax_render(size, seed):
    """The first 16 crops of each set, uint8, equal a fresh JAX render of
    16 crops at its seed (PIL draws them; skipped where PIL is missing):
    the prefix property the port serves smaller sizes by."""
    pytest.importorskip("PIL")
    want = jsyn.make_dataset(16, seed=seed)
    got = synthetic.make_dataset(16, seed)
    np.testing.assert_array_equal(
        got.image, np.stack([np.clip(np.rint(s.image * 255.0), 0, 255).astype(np.uint8)
                             for s in want]))
    assert got.labels == [s.label for s in want]


def test_jax_loads_the_committed_set_through_its_cache():
    """``make_packed_dataset(cache_dir=assets/synthetic)`` in the JAX
    package loads the very arrays the port does."""
    want = jsyn.make_packed_dataset(JAttnCodec(DEFAULT_CHARS, 25), 512, seed=1000,
                                    cache_dir=SYNTHETIC_DIR)
    got = synthetic.make_dataset(512, 1000)
    for k in KEYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.labels == want.labels


def test_smaller_sizes_are_prefixes_and_others_raise():
    full = synthetic.make_dataset(4096, 999)
    part = synthetic.make_dataset(100, 999)
    for k in KEYS:
        np.testing.assert_array_equal(getattr(part, k), getattr(full, k)[:100], err_msg=k)
    assert part.labels == full.labels[:100] and len(part) == 100
    for size, seed in ((4097, 999), (513, 1000), (16, 0), (0, 999)):
        with pytest.raises(ValueError, match="render_synthetic_set.py"):
            synthetic.make_dataset(size, seed)
    with pytest.raises(ValueError, match="4096 crops at seed 999"):
        synthetic.make_dataset(16, 7)


def test_codec_of_the_set_is_the_callers():
    short = AttnCodec(DEFAULT_CHARS, 12)
    got = synthetic.make_dataset(8, 1000, codec=short)
    assert got.text.shape == (8, 14)
    np.testing.assert_array_equal(got.text, JAttnCodec(DEFAULT_CHARS, 12).encode(got.labels)[0])


# --- the pipeline ------------------------------------------------------------------


def float_samples(n, seed):
    """JAX ``SyntheticSample``s with float crops in [0, 1], some off the
    uint8 grid and some on its half-way points."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = rng.uniform(0, 1, (32, 100, 1)).astype(np.float32)
        img[0, :4, 0] = np.array([0.5, 1.5, 2.5, 254.5], np.float32) / 255.0
        out.append(jsyn.SyntheticSample(
            anno_id=100 + i, image=img, label="".join(rng.choice(list("abcXYZ09"), 1 + i % 7)),
            overlap=rng.integers(0, 50, 15).astype(np.int32),
            scene=rng.integers(0, 50, 52).astype(np.int32),
            ious=rng.standard_normal(52).astype(np.float32)))
    return out


def assert_batch_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "labels":
            assert got[k] == v
        else:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_quantize_images_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-0.1, 1.1, 1000),
                        (np.arange(256) + 0.5) / 255.0]).astype(np.float32)
    np.testing.assert_array_equal(pipeline.quantize_images(x), jpipe.quantize_images(x))
    u = rng.integers(0, 256, (4, 5), dtype=np.uint8)
    assert pipeline.quantize_images(u) is u


def test_packed_samples_match_jax():
    samples = float_samples(11, 4)
    got = pipeline.PackedSamples.from_samples(samples, AttnCodec(DEFAULT_CHARS, 25))
    want = jpipe.PackedSamples.from_samples(samples, JAttnCodec(DEFAULT_CHARS, 25))
    for k in KEYS:
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert len(got) == 11 and got.labels == want.labels
    assert pipeline.PackedSamples.from_samples(got, None) is got
    view = got[3]
    assert view.label == want[3].label and view.anno_id == want[3].anno_id
    np.testing.assert_array_equal(view.image, want[3].image)
    idx = np.array([5, 0, 5, 10])
    assert_batch_equal(got.take(idx), want.take(idx))
    assert got.nbytes() == sum(getattr(want, k).nbytes for k in KEYS[:5])


@pytest.mark.parametrize("shuffle,drop_last,seed", [(True, True, 0), (True, False, 5),
                                                    (False, False, 0), (False, True, 2)])
def test_packed_batches_match_jax(shuffle, drop_last, seed):
    """Two epochs of 27 crops at B=8: the same order, the short batch
    dropped or padded (row 0's crop, "" labels, ``valid``) as JAX does."""
    packed = synthetic.make_dataset(27, 999)
    got = list(pipeline.packed_batches(packed, 8, shuffle=shuffle, seed=seed,
                                       drop_last=drop_last, epochs=2))
    want = list(jpipe.packed_batches(packed, 8, shuffle=shuffle, seed=seed,
                                     drop_last=drop_last, epochs=2))
    assert len(got) == len(want) == (6 if drop_last else 8)
    for g, w in zip(got, want):
        assert_batch_equal(g, w)
    if not drop_last:
        assert got[3]["valid"].sum() == 3 and got[3]["labels"][3:] == [""] * 5


@pytest.mark.parametrize("kind", ["float", "uint8"])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batcher_and_batches_match_jax(kind, shuffle, drop_last):
    """``batches`` over a ``Batcher`` on float samples and on the packed
    set's uint8 sample views: the same arrays, dtypes (uint8 stays uint8,
    float becomes float32), order and zero padding with ``valid``."""
    if kind == "float":
        samples = float_samples(13, 6)
    else:
        samples = synthetic.make_dataset(13, 1000)
    got = list(pipeline.batches(samples, pipeline.Batcher(AttnCodec(DEFAULT_CHARS, 25), 4),
                                shuffle=shuffle, seed=9, drop_last=drop_last, epochs=2))
    want = list(jpipe.batches(samples, jpipe.Batcher(JAttnCodec(DEFAULT_CHARS, 25), 4),
                              shuffle=shuffle, seed=9, drop_last=drop_last, epochs=2))
    assert len(got) == len(want) == (6 if drop_last else 8)
    for g, w in zip(got, want):
        assert_batch_equal(g, w)
    assert got[0]["image"].dtype == (np.float32 if kind == "float" else np.uint8)
    if not drop_last:
        assert not got[3]["image"][1:].any() and got[3]["valid"].tolist() == [1, 0, 0, 0]


def test_pad_batch_matches_jax():
    samples = float_samples(3, 7)
    b = pipeline.Batcher(AttnCodec(DEFAULT_CHARS, 25), 3)
    jb = jpipe.Batcher(JAttnCodec(DEFAULT_CHARS, 25), 3)
    assert_batch_equal(b.pad_batch(b.collate(samples)), jb.pad_batch(jb.collate(samples)))


def test_prefetcher_keeps_order_and_raises_the_producers_error():
    items = list(pipeline.Prefetcher(iter(range(50)), depth=3))
    assert items == list(jpipe.Prefetcher(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise KeyError("bad crop")

    got = []
    with pytest.raises(KeyError, match="bad crop"):
        for x in pipeline.Prefetcher(failing(), depth=1):
            got.append(x)
    assert got == [1, 2]


def test_prefetcher_close_ends_its_thread():
    """A consumer that stops early (the loop at its iteration limit) ends
    the producer, which would otherwise block on the full queue for good."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = pipeline.Prefetcher(endless(), depth=2)
    it = iter(pf)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    pf.close()
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


def test_device_batch_keeps_dtypes_and_drops_host_fields():
    packed = synthetic.make_dataset(5, 999)
    batch = next(pipeline.packed_batches(packed, 8, shuffle=False, drop_last=False))
    dev = pipeline.device_batch(batch, "cpu")
    assert set(dev) == {"image", "text", "overlap", "scene", "ious"}
    assert dev["image"].dtype == torch.uint8 and dev["ious"].dtype == torch.float32
    assert dev["text"].dtype == torch.int32 and dev["image"].device.type == "cpu"
    np.testing.assert_array_equal(dev["image"].numpy(), batch["image"])


# --- metrics -------------------------------------------------------------------------

METRIC_CASES = [
    ([], []),
    (["abc"], ["abc"]),
    (["abc", "ABd", "", "x"], ["abc", "abd", "", "xy"]),
    (["Hello", "wOrld", "a1", "zz"], ["hello", "world", "a1", "z"]),
    (["", "q"], ["q", ""]),
]


@pytest.mark.parametrize("preds,targets", METRIC_CASES)
def test_word_and_char_accuracy_match_jax(preds, targets):
    for cs in (True, False):
        assert metrics.word_accuracy(preds, targets, cs) == \
            jmetrics.word_accuracy(preds, targets, cs)
    assert metrics.char_accuracy(preds, targets) == jmetrics.char_accuracy(preds, targets)


def test_word_accuracy_values():
    assert metrics.word_accuracy(["Ab", "c", "d"], ["ab", "c", "e"]) == 33.33333
    assert metrics.word_accuracy(["Ab", "c", "d"], ["ab", "c", "e"], case_sensitive=False) \
        == 66.66667
    assert metrics.word_accuracy([], []) == 0.0


def test_averager_matches_jax():
    a, j = metrics.Averager(), jmetrics.Averager()
    assert a.val() == j.val() == 0.0
    for v, n in ((1.5, 1), (2.25, 3), (-0.5, 2)):
        a.add(v, n)
        j.add(v, n)
    assert a.val() == j.val() and a.n == j.n == 6
    a.reset()
    assert a.val() == 0.0 and a.n == 0


def test_eval_result_dataframe_and_missing_pandas(monkeypatch):
    recs = [metrics.PredRecord(3, "ab", "ab", True), metrics.PredRecord(4, "cd", "c", False)]
    res = metrics.EvalResult(50.0, recs)
    pytest.importorskip("pandas")
    df = res.to_dataframe()
    want = jmetrics.EvalResult(50.0, [jmetrics.PredRecord(**r.__dict__) for r in recs])
    assert df.equals(want.to_dataframe())
    assert list(df.columns) == ["anno_id", "ground_truth", "prediction", "correct"]
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="needs pandas"):
        res.to_dataframe()
    assert res.records == recs
