"""The port's data layer held against the JAX package's on the CPU: the
native mask ops, the AnyText json utilities, the three datasets and the
thread-mode bucketed loader. Same seeds and files on both sides; every
comparison is exact (bitwise for arrays)."""

import json
import threading
import time

import numpy as np
import pytest
from PIL import Image

from textflux_tpu.data import AnyWordSingleLineDataset as JaxAnyWord
from textflux_tpu.data import BucketedLoader as JaxLoader
from textflux_tpu.data import CombinedFolderDataset as JaxCombined
from textflux_tpu.data import UnionDataset as JaxUnion
from textflux_tpu.data import anytext as jax_anytext
from textflux_tpu.data import native as jax_native

from textflux_torch.data import (AnyWordSingleLineDataset, BucketedLoader,
                                 CombinedFolderDataset, UnionDataset, anytext, native)


@pytest.fixture()
def anyword_fixture(tmp_path, rng):
    """Six AnyText-format items (two annotations each, one of them filtered
    out) and one dropped item, as tests/test_data.py writes them, with
    quadrilaterals that are not axis-aligned."""
    img_root = tmp_path / "imgs"
    img_root.mkdir()
    data = {"data_list": []}
    for i in range(6):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8)).save(img_root / name)
        data["data_list"].append({
            "img_name": name,
            "annotations": [
                {"text": f"word{i}", "polygon": [[10, 10], [80, 14], [78, 40], [12, 44]]},
                {"text": "", "polygon": []},  # filtered
                {"text": f"alt {i}", "polygon": [[30, 60], [150, 55], [140, 110], [35, 100]]},
            ],
        })
    data["data_list"].append({"img_name": "missing.png", "annotations": []})  # dropped
    json_path = tmp_path / "data.json"
    json_path.write_text(json.dumps(data))
    return str(json_path), str(img_root)


@pytest.fixture()
def folder_fixture(tmp_path, rng):
    """Two CombinedFolderDataset directories (three and four samples, mixed
    sizes, .txt captions) under one root, for UnionDataset."""
    root = tmp_path / "union"
    for sub, sizes in (("a", (96, 128, 100)), ("b", (80, 128, 96, 150))):
        d = root / sub
        (d / "mask").mkdir(parents=True)
        for i, size in enumerate(sizes):
            Image.fromarray(rng.integers(0, 255, (size, size + 16, 3), np.uint8)).save(
                d / f"s_{i}.png")
            Image.fromarray((rng.random((size, size + 16)) > 0.5).astype(np.uint8) * 255).save(
                d / "mask" / f"s_{i}_mask.png")
            (d / f"s_{i}.txt").write_text(f"hello{i}\nline {sub}\n")
    return str(root)


def assert_same_sample(got, want):
    assert set(got) == set(want) == {"pixel_values", "mask", "prompt", "clip_prompt", "bucket"}
    for k in ("pixel_values", "mask"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("prompt", "clip_prompt", "bucket"):
        assert got[k] == want[k], k


def test_native_ops_match_jax(rng):
    for trial in range(6):
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        quad = rng.uniform(-10, max(h, w) + 10, (int(rng.integers(3, 7)), 2)).astype(np.float32)
        ours, ref = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        native.fill_poly(ours, quad)
        jax_native.fill_poly(ref, quad)
        np.testing.assert_array_equal(ours, ref)
        mask = (rng.random((h, w)) > 0.6).astype(np.uint8) * 255
        before = mask.copy()
        for it in (1, 2):
            np.testing.assert_array_equal(native.dilate(mask, it), jax_native.dilate(mask, it))
            np.testing.assert_array_equal(native.erode(mask, it), jax_native.erode(mask, it))
        np.testing.assert_array_equal(mask, before)   # the caller's mask stays as it was
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(native.normalize_pm1(img), jax_native.normalize_pm1(img))
        np.testing.assert_array_equal(native.normalize_01(img), jax_native.normalize_01(img))
    with pytest.raises(ValueError, match="uint8"):
        native.fill_poly(np.zeros((4, 4), np.float32), quad)


def test_anytext_utils_match_jax(anyword_fixture, tmp_path):
    json_path, _ = anyword_fixture
    data = anytext.load_anytext_json(json_path)
    assert data == jax_anytext.load_anytext_json(json_path)
    data["data_list"][0]["annotations"][0]["valid"] = False
    data["data_list"][1]["annotations"][0]["text"] = "ÄÖ text"
    for kw in ({}, {"max_items": 2}, {"exclude_invalid": False}, {"require_text": False}):
        assert anytext.filter_items(data, **kw) == jax_anytext.filter_items(data, **kw)
    anytext.save_anytext_json(data, str(tmp_path / "ours.json"))
    jax_anytext.save_anytext_json(data, str(tmp_path / "ref.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("quant", [32, 128])
def test_anyword_dataset_matches_jax(anyword_fixture, quant, monkeypatch):
    json_path, img_root = anyword_fixture
    kw = dict(resolutions=[128, 160, 200], seed=3, bucket_quant=quant)
    ours = AnyWordSingleLineDataset([(json_path, img_root)], **kw)
    ref = JaxAnyWord([(json_path, img_root)], **kw)
    assert len(ours) == len(ref) == 6
    augmented = set()
    for name in ("dilate", "erode"):
        def counted(mask, iterations=1, _name=name, _fn=getattr(native, name)):
            augmented.add((_name, iterations))
            return _fn(mask, iterations)
        monkeypatch.setattr(native, name, counted)
    # the shared RNG draws the annotation, the mask augmentation and the
    # resolution; over these passes every augmentation branch comes up
    for i in list(range(6)) * 8:
        assert_same_sample(ours[i], ref[i])
    assert ours.rng.getstate() == ref.rng.getstate()
    assert augmented == {(n, it) for n in ("dilate", "erode") for it in (1, 2)}


def test_anyword_dataset_retries_like_jax(anyword_fixture, tmp_path):
    json_path, img_root = anyword_fixture
    data = json.loads(open(json_path).read())
    data["data_list"][2]["img_name"] = "absent.png"    # a bad file: retried elsewhere
    data["data_list"][4]["annotations"][0]["polygon"] = [[1, 1], [5, 5]]   # < 3 points
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(data))
    ours = AnyWordSingleLineDataset([(str(bad), img_root)], resolutions=[128], seed=5)
    ref = JaxAnyWord([(str(bad), img_root)], resolutions=[128], seed=5)
    for i in (2, 4, 0, 2):
        assert_same_sample(ours[i], ref[i])


@pytest.mark.parametrize("quant", [32, 128])
def test_folder_datasets_match_jax(folder_fixture, quant):
    kw = dict(img_size=[96, 128], seed=4, bucket_quant=quant)
    ours, ref = UnionDataset(folder_fixture, **kw), JaxUnion(folder_fixture, **kw)
    assert len(ours) == len(ref) == 7
    for i in list(range(7)) * 2:
        assert_same_sample(ours[i], ref[i])
    sub = folder_fixture + "/b"
    ours, ref = CombinedFolderDataset(sub, img_size=112), JaxCombined(sub, img_size=112)
    for i in range(4):
        assert_same_sample(ours[i], ref[i])


def _batches(loader, epochs):
    return [b for _ in range(epochs) for b in loader]


def test_loader_matches_jax_over_epochs(anyword_fixture, folder_fixture):
    json_path, img_root = anyword_fixture
    for make_ours, make_ref, kw in (
            (lambda: AnyWordSingleLineDataset([(json_path, img_root)], resolutions=[128, 160],
                                              seed=1, bucket_quant=128),
             lambda: JaxAnyWord([(json_path, img_root)], resolutions=[128, 160], seed=1,
                                bucket_quant=128),
             dict(batch_size=1, grad_accum=2)),
            (lambda: UnionDataset(folder_fixture, img_size=[96, 128], seed=2),
             lambda: JaxUnion(folder_fixture, img_size=[96, 128], seed=2),
             dict(batch_size=2, grad_accum=1))):
        # one worker: the only order that does not depend on thread timing
        ours = BucketedLoader(make_ours(), num_workers=1, seed=7, **kw)
        ref = JaxLoader(make_ref(), num_workers=1, seed=7, **kw)
        got, want = _batches(ours, 2), _batches(ref, 2)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["bucket"] == w["bucket"] and g["prompts"] == w["prompts"]
            assert g["clip_prompts"] == w["clip_prompts"]
            a, b = kw["grad_accum"], kw["batch_size"]
            assert g["pixel_values"].shape[:2] == (a, b) and g["mask"].shape[:2] == (a, b)
            np.testing.assert_array_equal(g["pixel_values"], w["pixel_values"])
            np.testing.assert_array_equal(g["mask"], w["mask"])
        # set_epoch positions the shuffle stream as the JAX loader's does
        ours = BucketedLoader(make_ours(), num_workers=1, seed=7, **kw)
        ref = JaxLoader(make_ref(), num_workers=1, seed=7, **kw)
        ours.set_epoch(3)
        ref.set_epoch(3)
        assert [b["prompts"] for b in ours] == [b["prompts"] for b in ref]


def test_loader_abandoned_epoch_leaves_no_threads(anyword_fixture):
    json_path, img_root = anyword_fixture
    ds = AnyWordSingleLineDataset([(json_path, img_root)], resolutions=[128], seed=1)
    before = threading.active_count()
    loader = BucketedLoader(ds, batch_size=1, grad_accum=1, num_workers=2, seed=0, prefetch=1)
    it = iter(loader)
    next(it)      # one batch; prefetch=1 leaves the batcher blocked in put
    it.close()    # abandon the epoch (as `break` in a for-loop does)
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


class _NoBucket:
    """A dataset whose samples lack the bucket key: the batcher thread fails."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return {"pixel_values": np.zeros((4, 4, 3), np.float32)}


def test_loader_forwards_batcher_errors_and_refuses_processes():
    with pytest.raises(KeyError, match="bucket"):
        list(BucketedLoader(_NoBucket(), num_workers=1))
    with pytest.raises(NotImplementedError, match="item 7"):
        BucketedLoader(_NoBucket(), num_procs=2)
