"""The port's serving entry points held against the JAX package on a tiny
diffusers-layout checkpoint on disk: tokenizers, the tiled VAE,
FillPipeline.from_pretrained (with and without a LoRA folded in),
generate_batch (B = 2, padded), and cli.run_inference.main on the CPU.
CPU, float32; the JAX draws are handed to the port through ``noise=``."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from textflux_tpu.config import PipelineConfig, VAEConfig
from textflux_tpu.io.params import convert_vae_state_dict
from textflux_tpu.models import vae as JV
from textflux_tpu.pipeline import fill as JF
from textflux_tpu.pipeline.fill import FillPipeline as JaxFillPipeline
from textflux_tpu.pipeline.tokenizers import load_tokenizers as jax_load_tokenizers

import textflux_torch.config as TC
from textflux_torch.models import vae as TV
from textflux_torch.pipeline import fill as TF
from textflux_torch.pipeline.fill import FillPipeline
from textflux_torch.pipeline.tokenizers import load_tokenizers

from torch_port_helpers import (VAE_CFG, jax_pipeline_noise, n, port_cfg, real_naming, t,
                                write_tiny_checkpoint)

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "resource", "example")
EXAMPLE_PATHS = [os.path.join(EXAMPLE, sub, name) for sub, name in
                 (("ori", "ori_0001.png"), ("mask", "mask_0001.png"),
                  ("txt", "words_0001.txt"))]

MAX_T5 = 16
H, W, STEPS = 48, 64, 2
LORA_SCALE = 0.8


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("tiny_ckpt")))


def _pipe_cfgs():
    return (PipelineConfig(num_inference_steps=STEPS, max_sequence_length=MAX_T5),
            TC.PipelineConfig(num_inference_steps=STEPS, max_sequence_length=MAX_T5))


@pytest.fixture(scope="module")
def pipes(checkpoint):
    jcfg, tcfg = _pipe_cfgs()
    return {
        lora: (JaxFillPipeline.from_pretrained(
                   checkpoint, lora_path=lora, lora_scale=LORA_SCALE, dtype=jnp.float32,
                   pipe_cfg=jcfg, attn_impl="xla"),
               FillPipeline.from_pretrained(
                   checkpoint, lora_path=lora, lora_scale=LORA_SCALE, dtype=torch.float32,
                   pipe_cfg=tcfg, device="cpu"))
        for lora in (None, os.path.join(checkpoint, "lora"))}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8))
    mask = np.zeros((H, W), np.uint8)
    mask[10 + seed:30, 8:40 + seed] = 255
    return img, Image.fromarray(mask)


def test_tokenizers_match_jax(checkpoint):
    ours = load_tokenizers(checkpoint, max_t5_length=MAX_T5)
    ref = jax_load_tokenizers(checkpoint, max_t5_length=MAX_T5)
    prompts = ["the image", "a pair of images with the words 'OPEN' on the image and text",
               "unknown zebra", "", " ".join(["words"] * 40)]
    for ours_fn, ref_fn in zip(ours, ref):
        for p in prompts:
            got, want = ours_fn(p), ref_fn(p)
            assert got.dtype == np.int32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert ours[0]("the").shape == (1, 77) and ours[1]("the").shape == (1, MAX_T5)


def test_tiled_vae_matches_jax(rng):
    cfg = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
                    norm_num_groups=4, scaling_factor=0.5, shift_factor=0.1)
    vae = TV.FluxVAE(port_cfg(cfg), device="cpu", generator=torch.Generator().manual_seed(5))
    params = convert_vae_state_dict({k: n(v) for k, v in real_naming(vae).items()}, cfg)
    img = rng.uniform(-1, 1, (1, 2 * 14, 2 * 17, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    tile, overlap = 8, 3
    ys = TV.tile_starts(14, tile, tile - overlap)
    xs = TV.tile_starts(17, tile, tile - overlap)
    assert ys == [0, 5, 6] and xs == [0, 5, 9]   # both append a last tile
    eps = [np.array(jax.random.normal(jax.random.fold_in(key, i), (1, tile, tile, 4),
                                      jnp.float32)) for i in range(len(ys) * len(xs))]
    z_ref = JV.vae_encode_tiled(params, cfg, jnp.asarray(img), key=key, tile=tile,
                                overlap=overlap)
    dec_ref = JV.vae_decode_tiled(params, cfg, z_ref, tile=tile, overlap=overlap)
    mode_ref = JV.vae_encode_tiled(params, cfg, jnp.asarray(img), tile=tile, overlap=overlap)
    with torch.no_grad():
        z = TV.vae_encode_tiled(vae, t(img), noise=[t(e) for e in eps], tile=tile,
                                overlap=overlap)
        dec = TV.vae_decode_tiled(vae, t(np.asarray(z_ref)), tile=tile, overlap=overlap)
        mode = TV.vae_encode_tiled(vae, t(img), tile=tile, overlap=overlap)
        # drawn tile by tile from a generator: one draw per tile
        g = torch.Generator().manual_seed(0)
        drawn = TV.vae_encode_tiled(vae, t(img), generator=g, tile=tile, overlap=overlap)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(n(z), np.asarray(z_ref), **tol)
    np.testing.assert_allclose(n(dec), np.asarray(dec_ref), **tol)
    np.testing.assert_allclose(n(mode), np.asarray(mode_ref), **tol)
    assert np.isfinite(n(drawn)).all() and np.abs(n(drawn) - n(mode)).max() > 1e-3


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
def test_from_pretrained_matches_jax(lora, pipes, checkpoint):
    jax_pipe, port_pipe = pipes[os.path.join(checkpoint, "lora") if lora else None]
    assert port_pipe.attn_impl == "plain" and port_pipe.flux.rope_layout == "interleaved"
    assert set(port_pipe.load_stats) == {"transformer", "vae", "clip", "t5"}
    img, mask = _inputs()
    kw = dict(image=img, mask_image=mask, words=["OPEN"], height=H, width=W, seed=4,
              output_type="np")
    ref = jax_pipe(**kw, dtype=jnp.float32)
    noise = jax_pipeline_noise(4, height=H, width=W, vae_cfg=VAE_CFG, steps=STEPS)
    out = port_pipe(**kw, dtype=torch.float32, noise=noise)
    assert out.shape == ref.shape == (1, H, W, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_lora_changes_the_image(pipes, checkpoint):
    img, mask = _inputs()
    kw = dict(image=img, mask_image=mask, words=["OPEN"], height=H, width=W, seed=4,
              output_type="np", dtype=torch.float32)
    base = pipes[None][1](**kw)
    folded = pipes[os.path.join(checkpoint, "lora")][1](**kw)
    assert np.abs(base - folded).max() > 1e-3


def test_generate_batch_matches_jax_and_per_item(pipes, monkeypatch):
    jax_pipe, port_pipe = pipes[None]
    (i0, m0), (i1, m1) = _inputs(0), _inputs(1)
    words = [["OPEN"], ["SALE", "the text"]]
    seeds = [3, 8]
    kw = dict(height=H, width=W, seeds=seeds, seq_pad_multiple=8)   # 12 image tokens -> 16
    # compare the float images, before the uint8 rounding
    monkeypatch.setattr(JF.improc, "postprocess_image", lambda x: x)
    monkeypatch.setattr(TF.improc, "postprocess_image", lambda x: x)
    ref = jax_pipe.generate_batch([i0, i1], [m0, m1], words, dtype=jnp.float32, **kw)
    noise = [jax_pipeline_noise(s, height=H, width=W, vae_cfg=VAE_CFG, steps=STEPS)
             for s in seeds]
    out = port_pipe.generate_batch([i0, i1], [m0, m1], words, dtype=torch.float32,
                                   noise=noise, **kw)
    assert out.shape == ref.shape == (2, H, W, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert port_pipe.last_joint_seq == MAX_T5 + 16
    # the batch is its items: sample i as a single __call__ with seed seeds[i]
    drawn = port_pipe.generate_batch([i0, i1], [m0, m1], words, dtype=torch.float32,
                                     sampler="overshoot", **kw)
    for i, (img, mask) in enumerate(((i0, m0), (i1, m1))):
        single = port_pipe(image=img, mask_image=mask, prompt_2=None, words=words[i],
                           height=H, width=W, seed=seeds[i], seq_pad_multiple=8,
                           sampler="overshoot", dtype=torch.float32, output_type="np")
        np.testing.assert_allclose(drawn[i:i + 1], single, atol=1e-5)
    assert np.abs(drawn[0] - drawn[1]).max() > 1e-3


def test_staged_residency_matches_default(checkpoint, pipes):
    _, tcfg = _pipe_cfgs()
    staged = FillPipeline.from_pretrained(checkpoint, dtype=torch.float32, pipe_cfg=tcfg,
                                          defer_transformer=True, device="cpu")
    assert staged.flux is None and "transformer" not in staged.load_stats
    img, mask = _inputs()
    kw = dict(image=img, mask_image=mask, height=H, width=W, seed=1, output_type="np",
              dtype=torch.float32)
    embeds = staged.encode_prompts(*TF.build_prompts(["OPEN"]), dtype=torch.float32)
    with pytest.raises(ValueError, match="load_transformer"):
        staged(**kw, text_embeds=embeds)
    staged.release_text_encoders()
    staged.load_transformer()
    assert staged.clip is None and "transformer" in staged.load_stats
    np.testing.assert_array_equal(staged(**kw, text_embeds=embeds),
                                  pipes[None][1](**kw, words=["OPEN"]))


def test_fused_load_half_permutes(checkpoint):
    _, tcfg = _pipe_cfgs()
    pipe = FillPipeline.from_pretrained(checkpoint, dtype=torch.float32, pipe_cfg=tcfg,
                                        attn_impl="fused", defer_transformer=True, device="cpu")
    pipe.load_transformer()
    assert pipe.flux.rope_layout == "half"


def test_main_on_cpu_writes_artifacts(checkpoint, tmp_path, capsys):
    from textflux_torch.cli.run_inference import main

    out = tmp_path / "out"
    base = ["--model", checkpoint, "--image", EXAMPLE_PATHS[0], "--mask", EXAMPLE_PATHS[1],
            "--words", EXAMPLE_PATHS[2], "--steps", "2", "--max-sequence-length", str(MAX_T5),
            "--device", "cpu", "--output-dir", str(out)]
    main(base + ["--lora", os.path.join(checkpoint, "lora"), "--staged-text"])
    assert "saved result_0001.png" in capsys.readouterr().out
    assert (out / "result_0001.png").exists()
    for sub, name in (("crop", "crop_0001.png"), ("mask", "mask_0001.png"),
                      ("ori", "ori_0001.png"), ("rendered", "rendered_0001.png"),
                      ("txt", "words_0001.txt")):
        assert (out / sub / name).exists(), sub
    arr = np.asarray(Image.open(out / "result_0001.png"), np.float32)
    assert arr.shape == (448, 512, 3) and arr.std() > 0
    # the default (unstaged) path, the DiT named by --transformer
    main(base + ["--transformer", os.path.join(checkpoint, "transformer")])
    assert (out / "result_0002.png").exists() and (out / "crop" / "crop_0002.png").exists()

    missing = list(base)
    missing[missing.index("--image") + 1] = str(tmp_path / "absent.png")
    with pytest.raises(SystemExit) as exc:
        main(missing)
    assert exc.value.code == 2 and "file not found" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 11"):
        main(base + ["--quantize-mode", "w8a8"])
