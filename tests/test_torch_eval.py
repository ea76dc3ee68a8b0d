"""The port's batch evaluation, t2i and demo entry points held against the
JAX package on the CPU: find_render_token_windows, draw_glyph_beta, the
run_eval helpers (bitwise on fixtures), run_eval.main() against the JAX
main() (per item, batched, --multiline, --staged-text, --skip-existing, a
recorded failure, --mesh with fsdp > 1), Text2ImagePipeline (euler and overshoot) and the
demo callbacks.

The pipelines are the JAX package's tiny test pipelines (tests/helpers.py),
their parameters carried into the port with io/from_jax.py and shared by
module-scoped fixtures; both sides run in float32, and every draw the JAX
side makes with jax.random is handed to the port (``noise=``): main()'s
pipeline is wrapped so each call gets its seed's JAX draws. Tolerances:
images saved by main() and the demo callbacks within 1 grey level; t2i's
float images within 1e-4; the helpers' canvases, masks and strips bitwise."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tests.helpers import (CLIP_TINY, T5_TINY, VAE_TINY, dummy_clip_tokenize,
                           dummy_t5_tokenize, tiny_pipeline)
from textflux_tpu.cli import demo as JD, run_eval as JR
from textflux_tpu.config import FluxConfig, PipelineConfig
from textflux_tpu.models import vae as JV
from textflux_tpu.models.clip import init_clip_params
from textflux_tpu.models.t5 import init_t5_params
from textflux_tpu.models.transformer import init_flux_params
from textflux_tpu.pipeline.fill import FillPipeline as JaxFillPipeline
from textflux_tpu.pipeline.prompts import find_render_token_windows as jax_windows
from textflux_tpu.pipeline.t2i import Text2ImagePipeline as JaxT2I
from textflux_tpu.rendering import draw_glyph_beta as jax_glyph_beta

import textflux_torch.config as TC
from textflux_torch.cli import demo as TD, run_eval as TR
from textflux_torch.pipeline.fill import FillPipeline
from textflux_torch.pipeline.prompts import find_render_token_windows, words_prompt
from textflux_torch.pipeline.t2i import Text2ImagePipeline
from textflux_torch.rendering import draw_glyph_beta, load_font

from torch_port_helpers import jax_pipeline_noise, port_module, port_pipeline

STEPS = 2


# ---------------------------------------------------------------------------
# shared pipelines: the JAX tiny pipeline and the port on its parameters,
# both wrapped to run in float32 with the JAX draws
# ---------------------------------------------------------------------------

class _JaxF32:
    """The JAX pipeline with every call in float32."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, **kw):
        return self.pipe(**dict(kw, dtype=jnp.float32))

    def generate_batch(self, *a, **kw):
        return self.pipe.generate_batch(*a, **dict(kw, dtype=jnp.float32))

    def encode_batch_prompts(self, words_list):
        return self.pipe.encode_batch_prompts(words_list, dtype=jnp.float32)


class _PortJaxNoise:
    """The port pipeline with every call in float32 and handed the draws
    the JAX pipeline makes for the call's seed."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def _noise(self, seed, width, height, steps):
        return jax_pipeline_noise(seed, height=(height // 16) * 16, width=(width // 16) * 16,
                                  vae_cfg=self.pipe.vae_cfg, steps=steps)

    def __call__(self, **kw):
        noise = self._noise(kw["seed"], kw["width"], kw["height"],
                            kw.get("num_inference_steps") or STEPS)
        return self.pipe(**dict(kw, dtype=torch.float32, noise=noise))

    def generate_batch(self, images, masks, words_list, **kw):
        noise = [self._noise(kw["seed"], kw["width"], kw["height"], kw["num_inference_steps"])
                 for _ in images]
        return self.pipe.generate_batch(images, masks, words_list,
                                        **dict(kw, dtype=torch.float32, noise=noise))

    def encode_batch_prompts(self, words_list):
        return self.pipe.encode_batch_prompts(words_list, dtype=torch.float32)


@pytest.fixture(scope="module")
def pipes():
    jax_pipe = tiny_pipeline(steps=STEPS)
    return jax_pipe, port_pipeline(jax_pipe)


def _staged_port(jax_pipe):
    """A port pipeline whose DiT is deferred, as from_pretrained(
    defer_transformer=True) leaves it."""
    full = port_pipeline(jax_pipe)
    staged = FillPipeline(flux=None, flux_cfg=full.flux_cfg, vae=full.vae, clip=full.clip,
                          t5=full.t5, clip_tokenize=full.clip_tokenize,
                          t5_tokenize=full.t5_tokenize, pipe_cfg=full.pipe_cfg,
                          attn_impl="plain", device="cpu")
    staged._deferred_flux = lambda: full.flux
    return staged


# ---------------------------------------------------------------------------
# prompts and glyphs
# ---------------------------------------------------------------------------

def _char_tokenize(text):
    return np.array([[ord(c) % 97 + 2 for c in text]])


def _spm_tokenize(text):
    ids, prev_space = [], True
    for c in text:
        if c == " ":
            prev_space = True
            continue
        ids.append(ord(c) + (1000 if prev_space else 0))
        prev_space = False
    return np.array([ids + [1] + [0] * 4])


@pytest.mark.parametrize("tokenize,prompt", [
    (_char_tokenize, words_prompt(["cat", "dog"])),
    (_spm_tokenize, "an image with the words 'cat', nice"),
    (_spm_tokenize, 'double "quoted" words "here"'),
    (_char_tokenize, "no quotes at all"),
])
def test_find_render_token_windows_matches_jax(tokenize, prompt):
    ours = find_render_token_windows(tokenize, prompt)
    assert ours == jax_windows(tokenize, prompt)
    assert ours or "'" not in prompt and '"' not in prompt
    with pytest.raises(ValueError, match="no token window"):
        find_render_token_windows(_spm_tokenize, "the words 'cat' end", max_length=3)


@pytest.mark.parametrize("text,width,height", [("OPEN", 96, 15), ("CAFE 24H", 1400, 80),
                                               ("字", 2100, 120), ("", 64, 10)])
def test_draw_glyph_beta_is_jax_bitwise(text, width, height):
    font = load_font(size=60)
    ours = np.asarray(draw_glyph_beta(font, text, width, height))
    np.testing.assert_array_equal(ours, np.asarray(jax_glyph_beta(font, text, width, height)))
    assert ours.shape == (height, width, 3)


# ---------------------------------------------------------------------------
# run_eval helpers
# ---------------------------------------------------------------------------

def _write_items(root, sizes, texts, *, regions=1, rng):
    imgs = root / "imgs"
    imgs.mkdir(exist_ok=True)
    data = {"data_list": []}
    for i, ((h, w), text) in enumerate(zip(sizes, texts)):
        name = f"part{i % 2}/e_{i}.png"
        os.makedirs(imgs / os.path.dirname(name), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(imgs / name)
        anns = [{"text": text, "polygon": [[10, 12], [w - 12, 14], [w - 10, 40], [12, 38]]}]
        if regions == 2:
            anns.append({"text": text[::-1],
                         "polygon": [[10, h - 40], [w - 10, h - 40], [w - 10, h - 12],
                                     [10, h - 12]]})
        data["data_list"].append({"img_name": name, "annotations": anns})
    return data, str(imgs)


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    """Five items in two //32 buckets (subdirectory img_names), a json with
    an unusable item and one whose image is missing, and a multi-region
    json."""
    root = tmp_path_factory.mktemp("eval_items")
    rng = np.random.default_rng(0)
    data, imgs = _write_items(root, [(96, 128), (96, 128), (64, 96), (96, 128), (64, 96)],
                              ["OPEN", "SALE", "AB", "CAFE", "Z"], rng=rng)
    with_failure = json.loads(json.dumps(data))
    with_failure["data_list"].append({"img_name": "missing.png", "annotations": [
        {"text": "X", "polygon": [[1, 1], [20, 1], [20, 20], [1, 20]]}]})
    with_failure["data_list"].append({"img_name": "e_9.png", "annotations": [{"text": "X"}]})
    ml_root = root / "ml"
    ml_root.mkdir()
    ml, ml_imgs = _write_items(ml_root, [(96, 128), (128, 64)], ["TOP", "UP"], regions=2,
                               rng=rng)
    paths = {}
    for name, d in (("items", data), ("with_failure", with_failure), ("multiline", ml)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(d, f)
    return dict(json=paths, imgs=imgs, ml_imgs=ml_imgs, root=root)


def _same_prep(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, Image.Image):
            assert ours[k].size == v.size and ours[k].mode == v.mode, k
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)
        else:
            assert ours[k] == v, k


def test_run_eval_helpers_are_jax_bitwise(items, capsys):
    for name in ("a/b/c.png", "\\x\\y.jpg", "plain.png", "/lead/t.png"):
        assert TR.safe_name(name) == JR.safe_name(name)
    loaded = TR.load_items(items["json"]["with_failure"])
    out = capsys.readouterr().out
    assert loaded == JR.load_items(items["json"]["with_failure"]) and len(loaded) == 6
    assert "skipped 1 item(s)" in out
    font = load_font(size=60)
    for item in loaded[:5]:
        for renderer in ("inference", "dataset"):
            _same_prep(TR.prepare_item(item, items["imgs"], font, 0.15625, renderer),
                       JR.prepare_item(item, items["imgs"], font, 0.15625, renderer))
    preps = [TR.prepare_item(it, items["imgs"], font, 0.15625) for it in loaded[:5]]
    buckets = TR.group_by_bucket(preps)
    ref = JR.group_by_bucket(preps)
    assert list(buckets) == list(ref) == [(128, 96), (96, 64)]
    assert [[p["img_name"] for p in b] for b in buckets.values()] == \
        [[p["img_name"] for p in b] for b in ref.values()]
    result = Image.fromarray(np.random.default_rng(1).integers(0, 255, (96, 128, 3), np.uint8))
    np.testing.assert_array_equal(np.asarray(TR.crop_scene(result, 96, 20)),
                                  np.asarray(JR.crop_scene(result, 96, 20)))
    ml_font = load_font(size=40)
    for item in TR.load_items(items["json"]["multiline"]):
        _same_prep(TR.prepare_item_multiline(item, items["ml_imgs"], ml_font),
                   JR.prepare_item_multiline(item, items["ml_imgs"], ml_font))
    with pytest.raises(ValueError, match="data_list"):
        bad = items["root"] / "bad.json"
        bad.write_text("[]")
        TR.load_items(str(bad))


# ---------------------------------------------------------------------------
# run_eval.main()
# ---------------------------------------------------------------------------

def _main(module, pipe, monkeypatch, json_path, imgs, out, batch_size, extra=()):
    cls = JaxFillPipeline if module is JR else FillPipeline
    with monkeypatch.context() as mp:
        mp.setattr(cls, "from_pretrained", classmethod(lambda c, *a, **k: pipe))
        argv = ["--model", "unused", "--json-path", json_path,
                "--original-images-dir", imgs, "--output-dir", str(out), "--steps", str(STEPS),
                "--batch-size", str(batch_size), "--seq-pad-multiple", "16", *extra]
        module.main(argv + (["--device", "cpu"] if module is TR else []))
    with open(os.path.join(out, "failures.json")) as f:
        return json.load(f)


def _assert_same_images(a_dir, b_dir, names):
    for sub in ("full_images", "cropped_images"):
        assert sorted(os.listdir(os.path.join(a_dir, sub))) == sorted(names), sub
        for name in names:
            a = np.asarray(Image.open(os.path.join(a_dir, sub, name)), np.int16)
            b = np.asarray(Image.open(os.path.join(b_dir, sub, name)), np.int16)
            assert a.shape == b.shape, (sub, name)
            assert np.abs(a - b).max() <= 1, (sub, name, np.abs(a - b).max())


@pytest.fixture(scope="module")
def jax_runs(pipes, items, tmp_path_factory):
    """The JAX main() per item over the json with failures, and batched
    with --multiline."""
    out = tmp_path_factory.mktemp("jax_eval")
    mp = pytest.MonkeyPatch()
    try:
        reports = {
            "items": _main(JR, _JaxF32(pipes[0]), mp, items["json"]["with_failure"],
                           items["imgs"], out / "items", 1),
            "multiline": _main(JR, _JaxF32(pipes[0]), mp, items["json"]["multiline"],
                               items["ml_imgs"], out / "multiline", 2, ["--multiline"]),
        }
    finally:
        mp.undo()
    return out, reports


def test_run_eval_main_matches_jax(pipes, items, jax_runs, monkeypatch, tmp_path):
    """Per item and batched (2 per bucket), the port's main() writes the
    JAX main()'s images within one grey level and the same failures.json
    (the missing image recorded, the unusable item counted out)."""
    jax_out, reports = jax_runs
    port = _PortJaxNoise(pipes[1])
    names = [f"part{i % 2}_e_{i}.png" for i in range(5)]
    for batch in (1, 2):
        report = _main(TR, port, monkeypatch, items["json"]["with_failure"], items["imgs"],
                       tmp_path / f"b{batch}", batch)
        assert report == reports["items"]
        assert report["done"] == 5 and report["failed"] == 1 and report["total"] == 6
        assert report["failures"][0]["img_name"] == "missing.png"
        _assert_same_images(jax_out / "items", tmp_path / f"b{batch}", names)
    _assert_same_images(tmp_path / "b1", tmp_path / "b2", names)


def test_run_eval_main_multiline_matches_jax(pipes, items, jax_runs, monkeypatch, tmp_path):
    jax_out, reports = jax_runs
    report = _main(TR, _PortJaxNoise(pipes[1]), monkeypatch, items["json"]["multiline"],
                   items["ml_imgs"], tmp_path / "ml", 2, ["--multiline"])
    assert report == reports["multiline"] and report["done"] == 2
    _assert_same_images(jax_out / "multiline", tmp_path / "ml",
                        ["part0_e_0.png", "part1_e_1.png"])
    assert Image.open(tmp_path / "ml" / "cropped_images" / "part1_e_1.png").size == (64, 128)


def test_run_eval_main_staged_and_skip_existing(pipes, items, jax_runs, monkeypatch,
                                                tmp_path):
    """--staged-text (encode in chunks, release the text encoders, load the
    DiT) writes the default path's images; --skip-existing then does
    nothing; a chunk whose generate_batch raises records each item."""
    jax_out, _ = jax_runs
    staged = _staged_port(pipes[0])
    out = tmp_path / "staged"
    report = _main(TR, _PortJaxNoise(staged), monkeypatch, items["json"]["items"],
                   items["imgs"], out, 2, ["--staged-text"])
    assert report["done"] == 5 and report["failed"] == 0
    assert staged.clip is None and staged.t5 is None and staged.flux is not None
    _assert_same_images(jax_out / "items", out, [f"part{i % 2}_e_{i}.png" for i in range(5)])
    again = _main(TR, _PortJaxNoise(pipes[1]), monkeypatch, items["json"]["items"],
                  items["imgs"], out, 2, ["--skip-existing"])
    assert again == {"total": 0, "done": 0, "failed": 0, "skipped_existing": 5,
                     "failures": []}

    class Broken(_PortJaxNoise):
        def generate_batch(self, images, *a, **kw):
            if len(images) == 2:
                raise RuntimeError("out of memory")
            return super().generate_batch(images, *a, **kw)

    report = _main(TR, Broken(pipes[1]), monkeypatch, items["json"]["items"], items["imgs"],
                   tmp_path / "broken", 2)
    assert report["done"] == 1 and report["failed"] == 4
    assert {f["error"] for f in report["failures"]} == {"RuntimeError('out of memory')"}


def test_run_eval_mesh_raises_before_loading(monkeypatch, items, tmp_path):
    """--mesh serves over torch.distributed (tests/test_torch_parallel.py);
    an fsdp axis > 1 is the next slice and raises before anything loads."""
    def never(*a, **k):
        raise AssertionError("loaded a pipeline")

    monkeypatch.setattr(FillPipeline, "from_pretrained", classmethod(never))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6b"):
        TR.main(["--model", "unused", "--json-path", items["json"]["items"],
                 "--original-images-dir", items["imgs"], "--output-dir", str(tmp_path),
                 "--mesh", "1,2,1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Text2ImagePipeline
# ---------------------------------------------------------------------------

T2I_TINY = FluxConfig(in_channels=16, out_channels=16, num_double_layers=1, num_single_layers=1,
                      num_heads=2, head_dim=8, joint_dim=32, pooled_dim=16, guidance_embeds=True,
                      axes_dims_rope=(4, 2, 2), time_embed_channels=256)


def jax_t2i_noise(seed, *, b, height, width, vae_cfg, steps):
    """The draws Text2ImagePipeline.__call__ of the JAX package makes for
    `seed`: the initial latents and, per step, each sample's draw."""
    f = vae_cfg.spatial_factor
    t_img = (height // f // 2) * (width // f // 2)
    c = vae_cfg.latent_channels * 4
    key_noise, key_steps = jax.random.split(jax.random.PRNGKey(seed))
    step_keys = jax.vmap(lambda k: jax.random.split(k, b))(jax.random.split(key_steps, steps))
    return {"latents": np.array(jax.random.normal(key_noise, (b, t_img, c), jnp.float32)),
            "steps": np.stack([np.stack([np.array(jax.random.normal(k, (t_img, c), jnp.float32))
                                         for k in keys]) for keys in step_keys])}


@pytest.fixture(scope="module")
def t2i_pipes():
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    trees = dict(flux=(init_flux_params(ks[0], T2I_TINY), T2I_TINY),
                 vae=(JV.init_vae_params(ks[1], VAE_TINY), VAE_TINY),
                 clip=(init_clip_params(ks[2], CLIP_TINY), CLIP_TINY),
                 t5=(init_t5_params(ks[3], T5_TINY), T5_TINY))
    toks = dict(clip_tokenize=dummy_clip_tokenize, t5_tokenize=dummy_t5_tokenize)
    ref = JaxT2I(**{f"{k}_params": v[0] for k, v in trees.items()},
                 **{f"{k}_cfg": v[1] for k, v in trees.items()}, **toks,
                 pipe_cfg=PipelineConfig(num_inference_steps=STEPS, guidance_scale=3.5),
                 attn_impl="xla")
    ours = Text2ImagePipeline(**{k: port_module(*v) for k, v in trees.items()}, **toks,
                              pipe_cfg=TC.PipelineConfig(num_inference_steps=STEPS,
                                                         guidance_scale=3.5),
                              device="cpu")
    return ref, ours


@pytest.mark.parametrize("sampler,steps,seed,hw", [("euler", 2, 1, (32, 48)),
                                                   ("overshoot", 3, 4, (40, 50))])
def test_t2i_matches_jax(t2i_pipes, sampler, steps, seed, hw):
    ref_pipe, pipe = t2i_pipes
    kw = dict(prompt="a sign that says 'HELLO'", height=hw[0], width=hw[1], seed=seed,
              num_inference_steps=steps, sampler=sampler, overshoot_c=1.5)
    ref = ref_pipe(**kw, dtype=jnp.float32, output_type="np")
    h, w = (hw[0] // 16) * 16, (hw[1] // 16) * 16
    noise = jax_t2i_noise(seed, b=1, height=h, width=w, vae_cfg=VAE_TINY, steps=steps)
    out = pipe(**kw, dtype=torch.float32, output_type="np", noise=noise)
    assert out.shape == ref.shape == (1, h, w, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert pipe._fill.last_joint_seq == 16 + (h // 4) * (w // 4)
    # drawn from the generator: finite, seeded
    drawn = pipe(**kw, dtype=torch.float32, output_type="np")
    assert np.isfinite(drawn).all()
    np.testing.assert_array_equal(drawn, pipe(**kw, dtype=torch.float32, output_type="np"))
    # sequence-padded buckets take the zero-width cond tokens too
    padded = pipe(**dict(kw, sampler="euler"), dtype=torch.float32, output_type="np",
                  noise=noise, seq_pad_multiple=64)
    unpadded = pipe(**dict(kw, sampler="euler"), dtype=torch.float32, output_type="np",
                    noise=noise)
    np.testing.assert_allclose(padded, unpadded, atol=1e-5)


# ---------------------------------------------------------------------------
# demo callbacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    original = Image.fromarray(rng.integers(0, 255, (64, 96, 3), np.uint8))
    drawn = np.array(original).copy()
    drawn[20:40, 30:70] = 255
    return original, Image.fromarray(drawn)


@pytest.mark.parametrize("fn,words,kw", [
    ("demo_custom_beta", "single", {}),
    ("demo_custom_beta", "one\ntwo", {}),
    ("demo_custom", "hi\nyo", {"font": "font40"}),
    ("demo_custom_beta", "many\nlines\nof\ntext\nhere\nnow\nand\nmore\nstill\nend",
     {"sampler": "euler"}),
])
def test_demo_callbacks_match_jax(pipes, scene, fn, words, kw):
    """The default sampler (overshoot) with the JAX step draws; strips,
    renders and crops bitwise, results within one grey level."""
    original, drawn = scene
    kw = dict(kw)
    if kw.get("font") == "font40":
        kw["font"] = load_font(size=40)
    ref = getattr(JD, fn)(_JaxF32(pipes[0]), original, drawn, words, steps=STEPS, seed=3,
                          **kw)
    ours = getattr(TD, fn)(_PortJaxNoise(pipes[1]), original, drawn, words, steps=STEPS,
                           seed=3, **kw)
    for a, b in zip(ours, ref):
        a, b = np.asarray(a, np.int16), np.asarray(b, np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    if fn == "demo_custom_beta" and "\n" in words:
        n = len(words.split("\n"))
        assert ours[2].size == (96, n * max(1, int(min(96 // 6, 64 / n))))


def test_demo_normal_and_clicks_match_jax(pipes, scene):
    original, drawn = scene
    mask = Image.fromarray((np.asarray(drawn)[..., 0] == 255).astype(np.uint8) * 255)
    ref = JD.demo_normal(_JaxF32(pipes[0]), original, mask, "word", steps=STEPS)
    ours = TD.demo_normal(_PortJaxNoise(pipes[1]), original, mask, "word", steps=STEPS)
    assert np.abs(np.asarray(ours, np.int16) - np.asarray(ref, np.int16)).max() <= 1
    sketch = {"image": original, "mask": drawn}
    ref = JD._custom_click(_JaxF32(pipes[0]), JD.demo_custom_beta)(sketch, "hi", STEPS, 7.0,
                                                                    2, 1.5)
    ours = TD._custom_click(_PortJaxNoise(pipes[1]), TD.demo_custom_beta)(sketch, "hi", STEPS,
                                                                          7.0, 2, 1.5)
    assert np.abs(np.asarray(ours, np.int16) - np.asarray(ref, np.int16)).max() <= 1
    assert TD._snap32(original).size == JD._snap32(original).size == (96, 64)


def test_check_gradio_gives_the_jax_messages(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "gradio", None)    # an import of it fails
    with pytest.raises(RuntimeError) as ours:
        TD.check_gradio()
    with pytest.raises(RuntimeError) as ref:
        JD.check_gradio()
    assert str(ours.value) == str(ref.value) and "gradio==3.50.1" in str(ours.value)
    stub = types.ModuleType("gradio")
    stub.__version__ = "4.2.0"
    monkeypatch.setitem(sys.modules, "gradio", stub)
    with pytest.raises(RuntimeError) as ours:
        TD.check_gradio()
    with pytest.raises(RuntimeError) as ref:
        JD.check_gradio()
    assert str(ours.value) == str(ref.value) and "unsupported" in str(ours.value)
    stub.__version__ = "3.50.1"
    assert TD.check_gradio() is stub
    assert TD.SUPPORTED_GRADIO == JD.SUPPORTED_GRADIO


def test_demo_main_checks_gradio_before_loading(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "gradio", None)

    def never(*a, **k):
        raise AssertionError("loaded a pipeline")

    monkeypatch.setattr(FillPipeline, "from_pretrained", classmethod(never))
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        TD.main(["--model", "unused", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6b"):
        TD.main(["--model", "unused", "--mesh", "1,2,1"])
