"""The port's evaluation layer held against the JAX package on the CPU:
metrics, polygon crops, the FID math, the FID InceptionV3, the AlexNet LPIPS
and the PP-OCRv3 recognizer at their full published widths, the three
state-dict converters, and the eval_ocr / eval_fid_lpips entry points.

Weights: random torch state dicts in the published key layouts
(``random_*_state_dict``, He-scaled, so activations stay O(1)) go through
the JAX converter, and the JAX tree crosses into the port through
``io/from_jax.py``; both sides then run the same numpy-seeded inputs in
float32. Tolerances: Inception pool3 within 1e-4 of the largest |feature|;
LPIPS within 1e-5 relative; PP-OCR logits within 1e-4 absolute (logits are
O(1)) with the same decoded text; FID within 1e-6 relative; metrics and
crops equal (both sides crop with the same cv2 calls)."""

import json
import os

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from textflux_tpu.cli import eval_fid_lpips as JEF, eval_ocr as JEO
from textflux_tpu.evaluation import (crop as JC, fid as JFID, inception as JI, lpips as JL,
                                     metrics as JM, ppocr as JP)

from textflux_torch.cli import eval_fid_lpips as TEF, eval_ocr as TEO
from textflux_torch.evaluation import (crop as TCR, fid as TFID, inception as TI, lpips as TL,
                                       metrics as TM, ppocr as TP)
from textflux_torch.io.from_jax import load_jax_inception, load_jax_lpips, load_jax_ppocr

N_CHARS = 6623   # ppocr_keys_v1: + 'sos' + ' ' = the 6625 classes


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Random state dicts in the published layouts, written as .pth files,
    and each network on both sides (JAX tree, port module from that tree)."""
    root = tmp_path_factory.mktemp("eval_weights")
    g = torch.Generator().manual_seed(0)
    sds = {"inception": TI.random_torchvision_state_dict(g),
           "lpips": TL.random_lpips_state_dict(g),
           "ppocr": TP.random_recmodel_state_dict(TP.PPOCRConfig(), g)}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(root / f"{name}.pth")
        torch.save(sd, paths[name])
    charset = root / "keys.txt"
    charset.write_text("".join(chr(0x4E00 + i) + "\n" for i in range(N_CHARS)),
                       encoding="utf-8")
    jtrees = {"inception": JI.convert_inception_state_dict(_np(sds["inception"])),
              "lpips": JL.convert_lpips_state_dict(_np(sds["lpips"])),
              "ppocr": JP.convert_ppocr_state_dict(_np(sds["ppocr"]), JP.PPOCRConfig())}
    ports = {"inception": load_jax_inception(_tree(jtrees["inception"]), device="cpu"),
             "lpips": load_jax_lpips(_tree(jtrees["lpips"]), device="cpu"),
             "ppocr": load_jax_ppocr(_tree(jtrees["ppocr"]), TP.PPOCRConfig(), device="cpu")}
    return dict(sds=sds, paths=paths, charset=str(charset), jax=jtrees, port=ports)


# ---------------------------------------------------------------------------
# metrics, crops, FID math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("char2id", [None, {"a": 0, "b": 1, "c": 2}])
def test_metrics_match_jax(char2id):
    rng = np.random.default_rng(0)
    alphabet = list("abcdé ")
    preds = ["".join(rng.choice(alphabet, rng.integers(0, 8))) for _ in range(40)]
    gts = ["".join(rng.choice(alphabet, rng.integers(0, 8))) for _ in range(40)]
    gts[:5] = preds[:5]
    assert TM.evaluate_texts(preds, gts, char2id) == JM.evaluate_texts(preds, gts, char2id)
    for p, t in zip(preds, gts):
        assert TM.levenshtein(p, t) == JM.levenshtein(p, t)
        assert TM.normalized_edit_distance(p, t, char2id) == \
            JM.normalized_edit_distance(p, t, char2id)
    assert TM.evaluate_texts([], []) == JM.evaluate_texts([], [])
    with pytest.raises(ValueError):
        TM.evaluate_texts(["a"], [])


@pytest.mark.parametrize("polygon", [
    [[20, 30], [120, 30], [120, 70], [20, 70]],            # axis-aligned
    [[30, 20], [130, 50], [120, 85], [20, 55]],            # rotated
    [[60, 10], [90, 10], [92, 110], [58, 110]],            # vertical: rotated CCW
    [[70, 10], [120, 60], [70, 110], [20, 60]],            # ~45 degrees
])
def test_crop_matches_jax(polygon):
    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (128, 160, 3), np.uint8)
    ours = TCR.crop_polygon_region(image, polygon)
    ref = JC.crop_polygon_region(image, polygon)
    assert ours.shape[0] == 48 and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    mask = np.zeros((128, 160), np.uint8)
    import cv2

    cv2.fillPoly(mask, [np.asarray(polygon, np.int32)], 255)
    np.testing.assert_array_equal(TCR.min_bounding_rect(mask), JC.min_bounding_rect(mask))
    with pytest.raises(ValueError, match="empty mask"):
        TCR.min_bounding_rect(np.zeros((8, 8), np.uint8))


def test_fid_matches_jax():
    rng = np.random.default_rng(2)
    real = rng.standard_normal((64, 16))
    fake = rng.standard_normal((64, 16)) * 1.3 + 0.2
    ours, ref = TFID.fid_from_features(real, fake), JFID.fid_from_features(real, fake)
    assert ours == pytest.approx(ref, rel=1e-6) and ours > 0
    # the eps offset on both covariances: ~-2 eps D, as the JAX package gives
    assert TFID.fid_from_features(real, real) == pytest.approx(
        JFID.fid_from_features(real, real), rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(TFID._sqrtm_psd(np.cov(real, rowvar=False)),
                               JFID._sqrtm_psd(np.cov(real, rowvar=False)), rtol=1e-6)
    with pytest.raises(ValueError, match=">= 2 samples"):
        TFID.gaussian_stats(real[:1])
    images = [rng.uniform(-1, 1, (8, 8, 3)) for _ in range(5)]

    def extractor(x):
        return x.reshape(len(x), -1)[:, :6]

    ours = TFID.fid_from_images(images, images[::-1][:4] + images[:1], extractor, batch_size=2)
    ref = JFID.fid_from_images(images, images[::-1][:4] + images[:1], extractor, batch_size=2)
    assert ours == pytest.approx(ref, rel=1e-6)


# ---------------------------------------------------------------------------
# the networks at their published widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(299, 299), (96, 120)])
def test_inception_pool3_matches_jax(weights, hw):
    """Full-width FID InceptionV3; (96, 120) goes through the 299 resize."""
    x = np.random.default_rng(3).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    ref = JI.make_fid_extractor(weights["jax"]["inception"])(x)
    ours = TI.make_fid_extractor(weights["port"]["inception"])(x)
    assert ours.shape == (2, 2048) and ref.std() > 0.1
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_lpips_matches_jax(weights):
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    ref = np.asarray(JL.lpips_distance(weights["jax"]["lpips"], a, b))
    ours = TL.lpips_distance(weights["port"]["lpips"], a, b).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert (ours > 0).all()
    np.testing.assert_allclose(TL.lpips_distance(weights["port"]["lpips"], a, a).numpy(), 0.0,
                               atol=1e-7)


def test_ppocr_matches_jax(weights):
    cfg = JP.PPOCRConfig()
    charset = JP.load_charset(weights["charset"])
    assert TP.load_charset(weights["charset"]) == charset and len(charset) == cfg.n_class
    ref_rec = JP.PPOCRRecognizer(weights["jax"]["ppocr"], cfg, charset)
    ours_rec = TP.PPOCRRecognizer(weights["port"]["ppocr"], charset)
    rng = np.random.default_rng(5)
    for h, w in ((40, 150), (48, 400), (30, 20)):
        crop = rng.integers(0, 255, (h, w, 3), np.uint8)
        x = TP.preprocess_crop(crop)
        np.testing.assert_array_equal(x, JP.preprocess_crop(crop))
        ref = np.asarray(ref_rec._apply(ref_rec.params, x))
        ours = ours_rec.logits(crop)
        assert ours.shape == (1, 40, cfg.n_class)
        np.testing.assert_allclose(ours, ref, atol=1e-4)
        assert ours_rec(crop) == ref_rec(crop) != ""
    logits = rng.standard_normal((3, 12, 8))
    assert TP.ctc_greedy_decode(logits, list("_abcdefg")) == \
        JP.ctc_greedy_decode(logits, list("_abcdefg"))


def test_converters_give_the_jax_trees(weights):
    """Each convert_*_state_dict of the port, on a random torch state dict
    in the published layout, gives the module that the JAX converter's tree
    gives through io/from_jax.py, value for value."""
    sds = {k: _np(v) for k, v in weights["sds"].items()}
    built = {"inception": (TI.InceptionV3(device="cpu"),
                           TI.convert_inception_state_dict(sds["inception"])),
             "lpips": (TL.LPIPS(device="cpu"), TL.convert_lpips_state_dict(sds["lpips"])),
             "ppocr": (TP.RecModel(TP.PPOCRConfig(), device="cpu"),
                       TP.convert_ppocr_state_dict(sds["ppocr"], TP.PPOCRConfig()))}
    for name, (model, sd) in built.items():
        model.load_state_dict(sd)
        ref = weights["port"][name].state_dict()
        assert sorted(model.state_dict()) == sorted(ref), name
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=f"{name}: {k}")
    # the lpips heads also load from the `lins.{i}` key form
    lins = {k.replace("lin", "lins.", 1) if k.startswith("lin") else k: v
            for k, v in sds["lpips"].items()}
    for k, v in TL.convert_lpips_state_dict(lins).items():
        torch.testing.assert_close(v, built["lpips"][1][k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="lacks"):
        TP.convert_ppocr_state_dict({}, TP.PPOCRConfig())


def test_inception_loads_a_state_dict_and_a_pickled_module(weights, tmp_path):
    """A state dict loads under torch.load's default weights_only=True; a
    pickled module object (which that refuses) loads as the JAX package
    loads it, with weights_only=False."""
    sd = weights["sds"]["inception"]
    holder = torch.nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        mod = holder
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.register_buffer(leaf, value.clone())
    torch.save(holder, tmp_path / "module.pth")
    x = np.random.default_rng(6).uniform(-1, 1, (1, 80, 80, 3)).astype(np.float32)
    ref = TI.make_fid_extractor(weights["port"]["inception"])(x)
    for path in (weights["paths"]["inception"], str(tmp_path / "module.pth")):
        np.testing.assert_allclose(TI.load_inception_extractor(path, device="cpu")(x), ref,
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """Generated images, their ground truth (same file names, one differing
    by a size) and an AnyText json with one or two polygons per item."""
    root = tmp_path_factory.mktemp("eval_dirs")
    rng = np.random.default_rng(7)
    gen, gt = root / "gen", root / "gt"
    gen.mkdir()
    gt.mkdir()
    data = {"data_list": []}
    for i, (h, w) in enumerate(((96, 128), (96, 128), (80, 112))):
        name = f"sub_{i}.png"
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        Image.fromarray(base).save(gt / name)
        noisy = np.clip(base + rng.normal(0, 40, base.shape), 0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(gen / name)
        anns = [{"text": f"字{i}", "polygon": [[8, 10], [w - 8, 14], [w - 10, 44], [10, 40]]}]
        if i == 1:
            anns.append({"text": "二", "polygon": [[10, 50], [w - 20, 50], [w - 20, 90],
                                                    [10, 90]]})
        data["data_list"].append({"img_name": name if i else f"sub/{i}.png",
                                  "annotations": anns})
    # item 0's img_name has a subdirectory: the harness falls back to its
    # safe_name ("sub_0.png"), as run_eval writes it
    data["data_list"].append({"img_name": "absent.png",
                              "annotations": [{"text": "x", "polygon": [[0, 0], [4, 0],
                                                                         [4, 4]]}]})
    jp = root / "gt.json"
    jp.write_text(json.dumps(data, ensure_ascii=False), encoding="utf-8")
    return dict(gen=str(gen), gt=str(gt), json=str(jp))


@pytest.mark.parametrize("all_regions", [False, True])
def test_eval_ocr_main_matches_jax(weights, eval_dirs, monkeypatch, capsys, tmp_path,
                                   all_regions):
    """Both main()s over the same crops with the PP-OCR recognizer entry
    point (random full-config weights via PPOCR_CKPT / PPOCR_DICT) print the
    same metrics line and write the same --report."""
    import sys

    monkeypatch.setenv("PPOCR_CKPT", weights["paths"]["ppocr"])
    monkeypatch.setenv("PPOCR_DICT", weights["charset"])
    monkeypatch.setenv("PPOCR_DEVICE", "cpu")
    monkeypatch.setattr(JP, "_DEFAULT_RECOGNIZER", None)
    monkeypatch.setattr(TP, "_DEFAULT_RECOGNIZER", None)
    lines, reports = [], []
    for pkg, mod in (("textflux_tpu", JEO), ("textflux_torch", TEO)):
        report = tmp_path / f"{pkg}.json"
        argv = ["--images-dir", eval_dirs["gen"], "--json-path", eval_dirs["json"],
                "--recognizer", f"{pkg}.evaluation.ppocr:recognize",
                "--charset", weights["charset"], "--report", str(report)]
        argv += ["--all-regions"] if all_regions else []
        if mod is JEO:
            monkeypatch.setattr(sys, "argv", ["eval_ocr"] + argv)
            mod.main()
        else:
            mod.main(argv)
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        reports.append(json.loads(report.read_text()))
    assert lines[0] == lines[1] and reports[0] == reports[1] == lines[1]
    assert lines[1]["count"] == (4 if all_regions else 3) and lines[1]["skipped"] == 1
    assert 0.0 <= lines[1]["ned"] < 1.0
    assert TP._DEFAULT_RECOGNIZER.model.head.fc.weight.device.type == "cpu"


def test_ppocr_recognize_names_the_missing_files(monkeypatch, tmp_path):
    monkeypatch.setattr(TP, "_DEFAULT_RECOGNIZER", None)
    monkeypatch.setenv("PPOCR_CKPT", str(tmp_path / "none.pth"))
    monkeypatch.setenv("PPOCR_DICT", str(tmp_path / "none.txt"))
    with pytest.raises(FileNotFoundError, match="PP-OCRv3 recognizer weights not found"):
        TP.recognize(np.zeros((48, 64, 3), np.uint8))


def test_eval_fid_lpips_main_matches_jax(weights, eval_dirs, capsys, tmp_path):
    """Both main()s over the same directories and weight files print the
    same pair count, FID (1e-4 relative: three samples of 2048 features
    make a rank-2 covariance, whose square root amplifies feature noise)
    and LPIPS (1e-5 relative)."""
    argv = ["--gt-dir", eval_dirs["gt"], "--gen-dir", eval_dirs["gen"],
            "--inception-weights", weights["paths"]["inception"],
            "--lpips-weights", weights["paths"]["lpips"]]
    results = []
    for mod, extra in ((JEF, ["--log-dir", str(tmp_path / "jax")]),
                       (TEF, ["--log-dir", str(tmp_path / "torch"), "--device", "cpu"])):
        mod.main(argv + extra)
        results.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    ref, ours = results
    assert ours["pairs"] == ref["pairs"] == 3
    assert np.isfinite(ours["fid"]) and ours["fid"] > 0
    assert ours["fid"] == pytest.approx(ref["fid"], rel=1e-4)
    assert ours["lpips"] == pytest.approx(ref["lpips"], rel=1e-5) and ours["lpips"] > 0
    log = [f for f in os.listdir(tmp_path / "torch") if f.endswith(".log")]
    assert len(log) == 1 and "LPIPS" in (tmp_path / "torch" / log[0]).read_text()


def test_load_matches_jax_resize(eval_dirs):
    """_load's pre-resize (F.interpolate bilinear, half-pixel, no
    antialias) against the JAX package's jax.image.resize."""
    path = os.path.join(eval_dirs["gen"], "sub_2.png")
    for size in (299, 64, None):
        np.testing.assert_allclose(TEF._load(path, size), JEF._load(path, size), atol=1e-5)
    pairs = TEF.matched_pairs(eval_dirs["gt"], eval_dirs["gen"])
    assert pairs == JEF.matched_pairs(eval_dirs["gt"], eval_dirs["gen"]) and len(pairs) == 3
