"""The port's real-data loaders against the JAX package's on the same files
(the fixtures in ``assets/loader_fixtures/``, made by
``tests/loader_fixtures.py``): geometry, the COCO-Text index, annotations
and samples, TextOCR, the LMDB reader (on ``tests/fake_lmdb.py``, as the
JAX package's own tests run it), the balanced mixture, the image folder and
``api.get_dataset``; the port's loop on a mixture; and the fixtures
themselves, regenerated and held to the committed ``expected.npz``.  Every
comparison is exact."""

import dataclasses
import json
import shutil
import sys

import numpy as np
import pytest
import torch

import fake_lmdb
import image_writers as iw
import loader_fixtures as lf
from multimodal_scene_text_recognition_tpu import api as japi
from multimodal_scene_text_recognition_tpu.data import cocotext as jcoco
from multimodal_scene_text_recognition_tpu.data import geometry as jgeo
from multimodal_scene_text_recognition_tpu.data import lmdb_data as jlmdb
from multimodal_scene_text_recognition_tpu.data import raw as jraw
from multimodal_scene_text_recognition_tpu.data import textocr as jtextocr
from multimodal_scene_text_recognition_tpu_torch import api
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.data import (cocotext, geometry, lmdb_data,
                                                              raw, textocr)
from test_torch_resize import jax_native_library  # noqa: F401  (autouse: JAX's private build)
import torch_threads

torch_threads.limit()

SOURCES = ("coco", "vg", "vinvl", "zero")
ASSIGNMENTS = ("resize", "0.25", "0.50", "0.75")


def configs(**model):
    return lf.fixture_config(jax=True, **model), lf.fixture_config(jax=False, **model)


def same_samples(got, want):
    """Two sequences of samples with equal fields (images bit for bit)."""
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert (g.anno_id, g.label) == (w.anno_id, w.label)
        assert g.image.dtype == w.image.dtype and g.image.shape == w.image.shape
        np.testing.assert_array_equal(g.image, w.image)
        for k in ("overlap", "scene", "ious"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
            assert getattr(g, k).dtype == getattr(w, k).dtype


# --- geometry ---------------------------------------------------------------------


@pytest.mark.parametrize("assignment", ASSIGNMENTS)
def test_geometry_matches_jax(assignment):
    """The overlap vector under each assignment, the scene vector, IoU,
    containment and padding on seeded random boxes (repeated classes, boxes
    around, across and off the word, an empty object list)."""
    rng = np.random.default_rng(len(assignment))
    for trial in range(40):
        n = int(rng.integers(0, 12))
        classes = rng.integers(0, 30, n)
        word = np.concatenate([rng.uniform(20, 200, 2), rng.uniform(5, 80, 2)])
        boxes = np.concatenate([word[:2] - rng.uniform(-20, 30, (n, 2)),
                                word[2:] + rng.uniform(-20, 60, (n, 2))], axis=1)
        area = float(word[2] * word[3] * rng.uniform(0.5, 1.1))
        got = geometry.overlap_vector(word, area, classes, boxes, assignment)
        assert got == jgeo.overlap_vector(word, area, classes, boxes, assignment)
        assert geometry.scene_vector(classes) == jgeo.scene_vector(classes)
        if n:
            np.testing.assert_array_equal(geometry.iou_xywh(boxes, word),
                                          jgeo.iou_xywh(boxes, word))
            np.testing.assert_array_equal(geometry.contains(boxes, word),
                                          jgeo.contains(boxes, word))
        for a, b in zip(geometry.pad_semantic_vectors(got, classes.tolist() * 9),
                        jgeo.pad_semantic_vectors(got, classes.tolist() * 9)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# --- COCO-Text --------------------------------------------------------------------


def test_cocotext_index_queries_match_jax(tmp_path):
    """The index's lists and queries, and ``load_results`` (ids given and
    numbered), against JAX's on the fixture annotations."""
    path = str(lf.OUT / "cocotext.json")
    got, want = cocotext.COCOTextIndex(path), jcoco.COCOTextIndex(path)
    for k in ("train", "val", "test", "anns", "imgs", "img_to_anns", "cats"):
        assert getattr(got, k) == getattr(want, k)
    img = want.val[0]
    queries = [dict(), dict(img_ids=[img]), dict(props=[("legibility", "illegible")]),
               dict(area_range=(800, 2000)),
               dict(img_ids=want.train, props=[("language", "english")], area_range=(0, 5e3))]
    for q in queries:
        assert got.get_ann_ids(**q) == want.get_ann_ids(**q)
    for q in (dict(), dict(img_ids=want.val[:2]), dict(props=[("language", "not english")])):
        assert sorted(got.get_img_ids(**q)) == sorted(want.get_img_ids(**q))
    ids = want.get_ann_ids(img_ids=[img])
    assert got.load_anns(ids) == want.load_anns(ids)
    assert got.load_anns(ids[0]) == want.load_anns(ids[0])
    assert got.load_imgs(img) == want.load_imgs(img)
    assert cocotext.ann_rects(got.load_anns(ids)) == jcoco.ann_rects(want.load_anns(ids))
    results = [{"image_id": img, "bbox": [1, 2, 3, 4], "utf8_string": "a"},
               {"id": 77, "image_id": want.val[1], "bbox": [5, 6, 7, 8], "utf8_string": "b"}]
    res_path = tmp_path / "results.json"
    res_path.write_text(json.dumps(results))
    r_got, r_want = got.load_results(str(res_path)), want.load_results(str(res_path))
    assert (r_got.anns, r_got.img_to_anns, r_got.imgs) == (r_want.anns, r_want.img_to_anns,
                                                           r_want.imgs)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("source", SOURCES)
def test_cocotext_annotations_match_jax(source, split):
    """Both splits' annotations (legibility, language and label filters,
    image paths, vectors of each semantic source), also under an IoU
    assignment and through ``anno_filter``."""
    for assignment in ("resize", "0.50"):
        jcfg, cfg = configs(semantic_source=source, semantic_assignment=assignment)
        want = jcoco.build_cocotext_annotations(jcfg, split)
        got = cocotext.build_cocotext_annotations(cfg, split)
        assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a) for a in want]
        assert len(got) > 5
    keep = [a.anno_id for a in want[::3]] + [1]
    assert ([dataclasses.asdict(a) for a in cocotext.build_cocotext_annotations(
        cfg, split, anno_filter=keep)] == [dataclasses.asdict(a) for a in
                                           jcoco.build_cocotext_annotations(jcfg, split,
                                                                            anno_filter=keep)])


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "PIL route"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_cocotext_samples_match_jax(split, use_native):
    """The word crops of a split: images bit for bit (the page cache and the
    C++ crop resize against JAX's native library; the crop-then-resize route
    against PIL's), ids, labels and padded vectors."""
    jcfg, cfg = configs()
    got = cocotext.CocoTextSamples(cocotext.build_cocotext_annotations(cfg, split), cfg,
                                   use_native=use_native)
    want = jcoco.CocoTextSamples(jcoco.build_cocotext_annotations(jcfg, split), jcfg,
                                 use_native=use_native)
    same_samples(got, want)


def test_show_annotations_draws_as_jax():
    """The matplotlib rendering draws the same patches and texts."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    index = cocotext.COCOTextIndex(str(lf.OUT / "cocotext.json"))
    anns = index.load_anns(index.get_ann_ids(img_ids=index.val[:1]))
    drawn = []
    for mod in (cocotext, jcoco):
        for mask in (False, True):
            fig, ax = plt.subplots()
            mod.show_annotations(anns, ax=ax, show_mask=mask)
            coll = ax.collections[0]
            drawn.append(([p.vertices.tolist() for p in coll.get_paths()],
                          coll.get_facecolors().tolist(), [t.get_text() for t in ax.texts]))
            plt.close(fig)
    assert drawn[:2] == drawn[2:]
    assert cocotext.show_annotations([]) is None


# --- TextOCR ----------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "val"])
def test_textocr_matches_jax(split):
    """Annotations (the "." marker, the wrong-set image, the page without
    detections, string and numeric ids) and samples."""
    for assignment in ("resize", "0.75"):
        jcfg, cfg = configs(semantic_assignment=assignment)
        want = jtextocr.build_textocr_annotations(jcfg, split)
        got = textocr.build_textocr_annotations(cfg, split)
        assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a) for a in want]
    assert any(a.anno_id > 2 ** 31 for a in got) and any(a.anno_id < 10 ** 6 for a in got)
    same_samples(cocotext.CocoTextSamples(got, cfg), jcoco.CocoTextSamples(want, jcfg))
    assert textocr._to_int_id("123") == 123 == jtextocr._to_int_id("123")
    assert textocr._to_int_id("ab_1") == jtextocr._to_int_id("ab_1")


# --- LMDB, the mixture ------------------------------------------------------------


def write_lmdb(path, records):
    """A clovaai-layout LMDB of ``records`` [(label, image bytes)] through
    the fake lmdb package."""
    env = fake_lmdb.open(str(path))
    with env.begin(write=True) as txn:
        for i, (label, buf) in enumerate(records, start=1):
            txn.put(b"image-%09d" % i, buf)
            txn.put(b"label-%09d" % i, label.encode("utf-8"))
        txn.put(b"num-samples", str(len(records)).encode())
    env.close()


def crop_records(names=None):
    labels = json.loads((lf.OUT / "crops" / "labels.json").read_text())
    names = names or sorted(labels)
    return [(labels[n], (lf.OUT / "crops" / n).read_bytes()) for n in names]


@pytest.fixture
def lmdb_env(monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)


@pytest.fixture
def corpus(tmp_path, lmdb_env):
    """The fixture crops and the truncated one, plus labels the filter drops
    (too long, outside the charset) and a record that is no image."""
    records = crop_records() + [("x" * 40, crop_records(["crop_01.jpg"])[0][1]),
                                ("naïve", crop_records(["crop_02.jpg"])[0][1]),
                                ("Ok!", b"notanimage")]
    write_lmdb(tmp_path / "corpus", records)
    return str(tmp_path / "corpus")


@pytest.mark.parametrize("keep_ratio", [False, True], ids=["squash", "keep ratio"])
@pytest.mark.parametrize("filter_charset", [True, False], ids=["filtered", "unfiltered"])
def test_lmdb_reader_matches_jax(corpus, keep_ratio, filter_charset):
    """Every record: the bilinear squash or the keep-ratio bicubic resize,
    the dummy for the truncated JPEG and the non-image, labels cleaned and
    cut; the filter's index."""
    chars = ModelConfig().chars
    got = lmdb_data.LmdbReader(corpus, chars, keep_ratio=keep_ratio,
                               filter_charset=filter_charset)
    want = jlmdb.LmdbReader(corpus, chars, keep_ratio=keep_ratio, filter_charset=filter_charset)
    assert got.index == want.index
    assert len(got) == (18 if filter_charset else 20)
    same_samples(got, want)
    assert sum(got[i].label == "[dummy_label]" for i in range(len(got))) == 2


def test_keep_ratio_resize_matches_jax():
    """Float crops of several aspect ratios (wider than 100 at 32 high too)."""
    rng = np.random.default_rng(9)
    for h, w in ((20, 30), (32, 100), (40, 300), (64, 64), (1, 1), (10, 200)):
        img = (rng.integers(0, 256, (h, w, 1)) / 255.0).astype(np.float32)
        np.testing.assert_array_equal(lmdb_data.keep_ratio_resize(img),
                                      jlmdb.keep_ratio_resize(img))


def test_concat_and_balanced_mixture_match_jax():
    """ConcatSamples' indexing, and BalancedMixture's quotas and its first 5
    batches' draws (each source's permutations from one generator)."""
    parts = [list(range(5)), list(range(100, 103)), list(range(200, 211))]
    got, want = lmdb_data.ConcatSamples(parts), jlmdb.ConcatSamples(parts)
    assert len(got) == len(want) == 19
    assert [got[i] for i in range(19)] == [want[i] for i in range(19)]
    Item = type("Item", (), {})

    def source(offset, n):
        out = []
        for i in range(n):
            item = Item()
            item.anno_id = offset + i
            out.append(item)
        return out

    for ratios, batch in (((0.5, 0.5), 8), ((0.3, 0.7), 10), ((1.0, 2.0, 1.0), 7)):
        srcs = [source(1000 * k, n) for k, n in zip(range(len(ratios)), (5, 13, 3))]
        g = lmdb_data.BalancedMixture(srcs, ratios, batch, seed=999)
        w = jlmdb.BalancedMixture(srcs, ratios, batch, seed=999)
        assert g.quotas == w.quotas and sum(g.quotas) == batch
        for _ in range(5):
            assert ([s.anno_id for s in g.next_batch()]
                    == [s.anno_id for s in w.next_batch()])


def synth_tree(root):
    """MJ (three parts) and ST from the fixture crops, and a validation LMDB."""
    records = crop_records()
    parts = {"training/MJ/MJ_train": records[0:5], "training/MJ/MJ_test": records[5:8],
             "training/MJ/MJ_valid": records[8:10], "training/ST": records[10:],
             "validation": records[3:9]}
    for rel, recs in parts.items():
        write_lmdb(root / rel, recs)
    return str(root) + "/"


@pytest.mark.parametrize("mixture", ["", "0.5,0.5"], ids=["concat", "mixture"])
def test_synth_datasets_match_jax(tmp_path, lmdb_env, mixture, capsys):
    """``get_synth_datasets`` with and without ``data.mixture_ratios`` and
    with ``data.keep_ratio``: the same samples, the same printed line."""
    sets = {"data.deep_text_dataset_path": synth_tree(tmp_path), "data.mixture_ratios": mixture,
            "data.keep_ratio": "true", "train.batch_size": "6"}
    jcfg, cfg = configs()
    jcfg = lf.apply(jcfg, sets, jax=True)
    cfg = lf.apply(cfg, sets, jax=False)
    want_train, want_val = jlmdb.get_synth_datasets(jcfg)
    want_line = capsys.readouterr().out
    got_train, got_val = lmdb_data.get_synth_datasets(cfg)
    assert capsys.readouterr().out == want_line
    same_samples(got_val, want_val)
    if mixture:
        for _ in range(4):
            same_samples(got_train.next_batch(), want_train.next_batch())
    else:
        same_samples(got_train, want_train)
    with pytest.raises(ValueError, match="two comma floats"):
        lmdb_data.get_synth_datasets(lf.apply(cfg, {"data.mixture_ratios": "1,2,3"}, jax=False))


def _word(name="crop_04.jpg"):
    """A fixture crop as PIL reads it: RGB uint8 [H, W, 3]."""
    from PIL import Image

    return np.asarray(Image.open(lf.OUT / "crops" / name).convert("RGB"))


def format_records():
    """LMDB records in the kinds the decoder gained (progressive and CMYK
    JPEG, interlaced and 16-bit PNG, 32-bit BMP; lossy, lossy-with-alpha
    and lossless WebP) and the kinds PIL refuses with an OSError (12-bit
    and hierarchical JPEG, a truncated JPEG and a truncated WebP):
    (label, bytes)."""
    import io

    from PIL import Image

    def encode(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, format=fmt, **kw)
        return buf.getvalue()

    rgb, grey = _word(), np.asarray(Image.fromarray(_word("crop_07.jpg")).convert("L"))
    base = encode(Image.fromarray(_word("crop_02.jpg")), "JPEG", quality=90)
    lossy = encode(Image.fromarray(_word("crop_09.jpg")), "WEBP", quality=60)
    return [
        ("progressive", encode(Image.fromarray(rgb), "JPEG", quality=85, progressive=True)),
        ("cmyk", encode(Image.fromarray(_word("crop_05.jpg")).convert("CMYK"), "JPEG",
                        quality=90)),
        ("interlaced", iw.png(rgb, interlace=True)),
        ("sixteen", iw.png(grey.astype(np.uint16) * 3, 16)),  # above 255: clipped, as PIL
        ("bitmap", iw.bmp(rgb.shape[1], rgb.shape[0], 32, [np.concatenate(
            [r[:, ::-1], np.zeros((len(r), 1), np.uint8)], 1).tobytes() for r in rgb])),
        ("twelve", iw.retag_frame(base, precision=12)),
        ("hierarchical", iw.retag_frame(base, marker=0xC5)),
        ("truncated", base[:len(base) // 2]),
        ("webp", encode(Image.fromarray(rgb), "WEBP")),
        ("webplossy", lossy),
        ("webpalpha", encode(Image.fromarray(lf._alpha_bands(_word("crop_11.jpg"))), "WEBP",
                              quality=50, alpha_quality=40)),
        ("webplossless", encode(Image.fromarray(_word("crop_13.jpg")), "WEBP", lossless=True)),
        ("webptruncated", lossy[:len(lossy) * 2 // 3]),
    ]


@pytest.mark.parametrize("keep_ratio", [False, True], ids=["squash", "keep ratio"])
def test_lmdb_reader_on_new_formats_matches_jax(tmp_path, lmdb_env, keep_ratio):
    """A corpus of a progressive JPEG, a CMYK JPEG, an interlaced PNG, a
    16-bit PNG, a 32-bit BMP and lossy, lossy-with-alpha and lossless WebP
    (all of which PIL decodes), a 12-bit JPEG, a SOF5 (hierarchical) JPEG, a
    truncated JPEG and a truncated WebP (which PIL refuses with an
    OSError): the port's samples are JAX's, the dummies at the same
    records."""
    records = format_records()
    write_lmdb(tmp_path / "formats", records)
    chars = ModelConfig().chars
    got = lmdb_data.LmdbReader(str(tmp_path / "formats"), chars, keep_ratio=keep_ratio)
    want = jlmdb.LmdbReader(str(tmp_path / "formats"), chars, keep_ratio=keep_ratio)
    assert got.index == want.index and len(got) == len(records)
    dummies = []
    for i in range(len(records)):
        same_samples([got[i]], [want[i]])
        if want[i].label == "[dummy_label]":
            dummies.append(records[i][0])
    assert dummies == ["twelve", "hierarchical", "truncated", "webptruncated"]


# --- the image folder -------------------------------------------------------------


def test_raw_image_folder_matches_jax(tmp_path):
    """A folder of JPEG, PNG, BMP and PPM crops in subfolders, natural
    order: the same paths and samples."""
    from PIL import Image

    for n, name in enumerate(lf.crop_files()[:6]):
        sub = tmp_path / ("a" if n % 2 else "b")
        sub.mkdir(exist_ok=True)
        shutil.copy(lf.OUT / "crops" / name, sub / f"word{10 - n}.jpg")
    img = Image.open(lf.OUT / "crops" / "crop_03.jpg")
    img.save(tmp_path / "word2.png")
    img.convert("RGB").save(tmp_path / "word11.BMP")
    img.save(tmp_path / "word1.ppm")
    (tmp_path / "notes.txt").write_text("not an image")
    got, want = raw.RawImageFolder(str(tmp_path)), jraw.RawImageFolder(str(tmp_path))
    assert got.paths == want.paths and len(got) == 9
    same_samples(got, want)
    names = ["a10.jpg", "a2.jpg", "A1.png", "b1.jpg"]
    assert sorted(names, key=raw.natural_key) == sorted(names, key=jraw.natural_key)


def test_raw_image_folder_reads_progressive_and_interlaced_as_jax(tmp_path):
    """A progressive ``.jpg`` (4:2:0 and grey) and an Adam7 ``.png`` crop:
    the same samples as JAX's folder."""
    from PIL import Image

    rgb = _word("crop_08.jpg")
    Image.fromarray(rgb).save(tmp_path / "a1.jpg", quality=80, progressive=True)
    Image.fromarray(rgb).convert("L").save(tmp_path / "a2.jpeg", quality=60, progressive=True)
    (tmp_path / "a3.png").write_bytes(iw.png(rgb, interlace=True))
    got, want = raw.RawImageFolder(str(tmp_path)), jraw.RawImageFolder(str(tmp_path))
    assert got.paths == want.paths and len(got) == 3
    same_samples(got, want)


def test_raw_image_folder_raises_for_webp(tmp_path):
    """A folder holding ``.webp`` crops (one of its extensions) beside a JPEG:
    lossy, lossless and an animation, read as JAX's folder reads them (the
    WebP kinds no longer raise)."""
    from PIL import Image

    img = Image.open(lf.OUT / "crops" / "crop_03.jpg")
    img.save(tmp_path / "w1.webp")
    img.save(tmp_path / "w2.webp", lossless=True)
    img.save(tmp_path / "w3.webp", save_all=True, append_images=[img.rotate(180)], quality=40)
    img.save(tmp_path / "w4.jpg")
    got, want = raw.RawImageFolder(str(tmp_path)), jraw.RawImageFolder(str(tmp_path))
    assert got.paths == want.paths and len(got) == 4
    same_samples(got, want)


# --- api.get_dataset, the loop ----------------------------------------------------


@pytest.mark.parametrize("name", ["cocotext", "textocr", "synth", "cocotext_single_image_val"])
def test_get_dataset_matches_jax(name, tmp_path, lmdb_env):
    """``api.get_dataset`` of the four real-data names against JAX's."""
    sets = {"data.deep_text_dataset_path": synth_tree(tmp_path)}
    jcfg = lf.apply(lf.fixture_config(jax=True), sets, jax=True)
    cfg = lf.apply(lf.fixture_config(jax=False), sets, jax=False)
    got, want = api.get_dataset(name, cfg), japi.get_dataset(name, jcfg)
    if name == "cocotext_single_image_val":
        same_samples(got, want)
        return
    for g, w in zip(got, want):
        same_samples(g, w)


def test_loop_trains_on_a_mixture(tmp_path, lmdb_env, monkeypatch):
    """The port's loop on ``get_synth_datasets``' balanced mixture at MICRO
    widths on the CPU: 2 steps through host collate, validation before and
    after on the validation LMDB; the steps per epoch count both sources."""
    from multimodal_scene_text_recognition_tpu_torch.train import loop

    cfg = lf.apply(lf.fixture_config(jax=False, enc_layers=1, dec_layers=1, ff_dim=32,
                                     hidden_dim=32, embed_dim=32, num_heads=2,
                                     compute_dtype="float32", use_tps=False),
                   {"data.deep_text_dataset_path": synth_tree(tmp_path),
                    "data.mixture_ratios": "0.5,0.5", "data.keep_ratio": "true",
                    "train.batch_size": "4", "train.iteration_limit": "2",
                    "train.validation_steps": "2", "results_dir": str(tmp_path / "results")},
                   jax=False)
    train, val = api.get_dataset("synth", cfg)
    assert isinstance(train, lmdb_data.BalancedMixture)
    step = api.get_trainer(None, cfg.model, cfg.train, device="cpu", seed=3)
    seen, configured = [], []
    real_step, real_configure = type(step).__call__, step.configure

    def spy(self, batch):
        seen.append(batch["image"].dtype)
        return real_step(self, batch)

    def configure(tc, steps_per_epoch):
        configured.append(steps_per_epoch)
        real_configure(tc, steps_per_epoch)

    monkeypatch.setattr(type(step), "__call__", spy)
    monkeypatch.setattr(step, "configure", configure)
    loop.train(cfg, step, train, val, verbose=False)
    # 17 samples in MJ and ST: 4 steps an epoch; float crops, never packed
    assert step.step_count == 2 and seen == [torch.float32] * 2 and configured == [4]
    log = (tmp_path / "results" / f"{cfg.experiment}_training_log.csv").read_text()
    assert log.splitlines()[0] == "iter,cost_avg,val_acc,train_acc"


# --- the fixtures -----------------------------------------------------------------


def test_fixtures_are_what_pil_and_jax_read():
    """``expected.npz`` regenerated from the committed files (PIL's decode
    of every page and crop, JAX's COCO-Text val samples, the trained
    flagship's float32 strings and top-2 gaps) equals the committed one,
    and the fixture directory stays under 2 MB."""
    want = np.load(lf.OUT / "expected.npz")
    got = lf.expected()
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    total = sum(p.stat().st_size for p in lf.OUT.rglob("*") if p.is_file())
    assert total < 2 * 2 ** 20


# sha256 over (key, dtype, shape, bytes), in key order, of the 29 arrays
# expected.npz held before formats/ was added
EXPECTED_BEFORE_FORMATS = "10c4a6401e9bce4dfbbbcb88e6bb844f3b99eafcff1cf06d8f17ca5e18cc03b7"


def test_fixture_keys_before_formats_are_unchanged():
    """Adding formats/ changed no array of ``expected.npz`` that was there
    before it: pages, crops, the COCO-Text val samples and JAX's strings."""
    import hashlib

    exp = np.load(lf.OUT / "expected.npz")
    keys = sorted(k for k in exp.files if not k.startswith("format"))
    assert len(keys) == 29
    digest = hashlib.sha256()
    for k in keys:
        a = exp[k]
        digest.update(k.encode() + str(a.dtype).encode() + str(a.shape).encode())
        digest.update(np.ascontiguousarray(a).tobytes())
    assert digest.hexdigest() == EXPECTED_BEFORE_FORMATS


@pytest.mark.parametrize("name", lf.format_files())
def test_format_fixtures_decode_as_pil(name):
    """Each file of formats/ (a progressive and a CMYK page, the lossy
    crops) decodes to PIL's array in ``expected.npz``, bit for bit."""
    from multimodal_scene_text_recognition_tpu_torch.data import images

    want = np.load(lf.OUT / "expected.npz")[f"format/{name}"]
    np.testing.assert_array_equal(images.read_gray(str(lf.FORMATS / name)), want)


@pytest.mark.parametrize("name", lf.webp_files())
def test_webp_fixtures_decode_as_pil(name):
    """Each WebP file of formats/ (lossless at methods 0, 3 and 6, RGBA with
    ``exact``, palettes of 2, 4 and 16 colours; lossy at qualities 10, 50
    and 95, with raw, lossless and quantized alpha, with the simple loop
    filter and with sharpness 7; VP8X with ICC, EXIF and XMP; a PIL
    animation and one built by hand whose first frame is smaller than its
    canvas; page 0 lossy) decodes to PIL's ``convert("L")``, bit for bit,
    and to the sha256 ``expected.npz`` keeps of it."""
    from PIL import Image

    from multimodal_scene_text_recognition_tpu_torch.data import images

    got = images.read_gray(str(lf.FORMATS / name))
    np.testing.assert_array_equal(got, np.asarray(Image.open(lf.FORMATS / name).convert("L")))
    np.testing.assert_array_equal(lf.gray_sha256(got),
                                  np.load(lf.OUT / "expected.npz")[f"format_webp/{name}"])


def test_webp_crops_decode_as_pil():
    """The 192 committed crops as lossy WebP (the folder chip_smoke.py
    recognizes): each decodes to PIL's array, whose sha256 ``expected.npz``
    keeps."""
    import io

    from PIL import Image

    from multimodal_scene_text_recognition_tpu_torch.data import images

    files = lf.webp_crops()
    want = np.load(lf.OUT / "expected.npz")["format_webp_crops/sha256"]
    assert len(files) == len(want) == lf.WEBP_CROPS_N
    for data, digest in zip(files, want):
        got = images.decode_gray(data)
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("L")))
        np.testing.assert_array_equal(lf.gray_sha256(got), digest)


def test_webp_lossless_page_reads_back_page_0():
    """Page 0 written as a lossless WebP by ``image_writers.webp_lossless``
    (the page chip_smoke.py times) reads back as page 0 in PIL and in the
    port."""
    import io

    from PIL import Image

    from multimodal_scene_text_recognition_tpu_torch.data import images

    page = np.load(lf.OUT / "expected.npz")["page/page_0.jpg"]
    data = iw.webp_lossless(page)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("L")), page)
    np.testing.assert_array_equal(images.decode_gray(data), page)


@pytest.mark.parametrize("name", lf.WEBP_REFUSED)
def test_webp_fixtures_pil_refuses_raise_oserror(name):
    """The truncated and the corrupt WebP of formats/: OSError in PIL and in
    the port."""
    from PIL import Image

    from multimodal_scene_text_recognition_tpu_torch.data import images

    with pytest.raises(OSError):
        Image.open(lf.FORMATS / name).convert("L")
    with pytest.raises(OSError) as err:
        images.read_gray(str(lf.FORMATS / name))
    assert not isinstance(err.value, NotImplementedError)


@pytest.mark.parametrize("name", lf.FORMAT_REFUSED)
def test_format_fixtures_pil_refuses_raise_oserror(name):
    """The 12-bit and the hierarchical (SOF5) JPEG of formats/: OSError in
    PIL and in the port."""
    from PIL import Image

    from multimodal_scene_text_recognition_tpu_torch.data import images

    with pytest.raises(OSError):
        Image.open(lf.FORMATS / name).convert("L")
    with pytest.raises(OSError) as err:
        images.read_gray(str(lf.FORMATS / name))
    assert not isinstance(err.value, NotImplementedError)
