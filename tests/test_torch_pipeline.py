"""The textflux_torch fill pipeline held against the JAX package's tiny
pipeline (same parameters, the JAX noise draws injected), against the
committed goldens, and driven through the port's run_inference on
resource/example; plus the VAE on the tiny pipeline's parameters and the
rendering copy against the canvas goldens. CPU, float32."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from helpers import VAE_TINY, tiny_pipeline
from textflux_tpu.models import vae as JV

from textflux_torch.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig
from textflux_torch.models import vae as TV
from textflux_torch.models.clip import CLIPTextModel
from textflux_torch.models.t5 import T5Encoder
from textflux_torch.models.transformer import FluxTransformer
from textflux_torch.models.vae import FluxVAE
from textflux_torch.pipeline.fill import FillPipeline

from torch_port_helpers import jax_pipeline_noise, n, port_module, port_pipeline, t

HERE = os.path.dirname(__file__)
GOLDEN_DIR = os.path.join(HERE, "golden")
EXAMPLE = os.path.join(HERE, "..", "resource", "example")
SEED = 7          # the goldens' seed and size (tests/test_golden.py)
H, W = 32, 48
STEPS = 2


@pytest.fixture(scope="module")
def jax_pipe():
    return tiny_pipeline()


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    return port_pipeline(jax_pipe)


def _fixture_inputs():
    img = Image.open(os.path.join(EXAMPLE, "ori", "ori_0001.png"))
    mask = Image.open(os.path.join(EXAMPLE, "mask", "mask_0001.png"))
    return img, mask


def _port_run(pipe, sampler, **kw):
    img, mask = _fixture_inputs()
    noise = jax_pipeline_noise(SEED, height=H, width=W, vae_cfg=VAE_TINY, steps=STEPS)
    return pipe(image=img, mask_image=mask, words=["OPEN"], height=H, width=W, seed=SEED,
                sampler=sampler, overshoot_c=2.0, dtype=torch.float32, output_type="np",
                noise=noise, **kw)


@pytest.mark.parametrize("sampler", ["euler", "overshoot", "overshoot_spatial"])
def test_pipeline_matches_jax(sampler, jax_pipe, port_pipe):
    img, mask = _fixture_inputs()
    ref = jax_pipe(image=img, mask_image=mask, words=["OPEN"], height=H, width=W, seed=SEED,
                   sampler=sampler, overshoot_c=2.0, dtype=jnp.float32, output_type="np")
    out = _port_run(port_pipe, sampler)
    assert out.shape == ref.shape == (1, H, W, 3)
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("sampler", ["euler", "overshoot"])
def test_pipeline_matches_golden(sampler, port_pipe):
    want = np.load(os.path.join(GOLDEN_DIR, sampler + ".npz"))["out"]
    out = _port_run(port_pipe, sampler)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=2e-3)


def test_vae_matches_jax(jax_pipe, rng):
    params = jax_pipe.vae_params
    vae = port_module(params, VAE_TINY)
    img = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    mean, logvar = JV.vae_encode_moments(params, VAE_TINY, img)
    z_ref = JV.vae_encode(params, VAE_TINY, img, key=key)
    dec_ref = JV.vae_decode(params, VAE_TINY, z_ref)
    eps = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    with torch.no_grad():
        pm, plv = TV.vae_encode_moments(vae, t(img))
        z = TV.vae_encode(vae, t(img), noise=t(eps))
        z_mode = TV.vae_encode(vae, t(img))
        dec = TV.vae_decode(vae, z)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(n(pm), np.asarray(mean), **tol)
    np.testing.assert_allclose(n(plv), np.asarray(logvar), **tol)
    np.testing.assert_allclose(n(z), np.asarray(z_ref), **tol)
    np.testing.assert_allclose(
        n(z_mode), (np.asarray(mean) - VAE_TINY.shift_factor) * VAE_TINY.scaling_factor, **tol)
    np.testing.assert_allclose(n(dec), np.asarray(dec_ref), **tol)


def test_seq_pad_multiple_matches_unpadded(port_pipe):
    img, mask = _fixture_inputs()
    kw = dict(image=img, mask_image=mask, words=["pad"], height=H, width=W, seed=2,
              dtype=torch.float32, output_type="np")
    ref = port_pipe(**kw)
    out = port_pipe(**kw, seq_pad_multiple=64)   # t_img = 96 -> 128, keys masked
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_output_types_and_seeded_noise(port_pipe):
    img, mask = _fixture_inputs()
    kw = dict(image=img, mask_image=mask, words=["OPEN"], height=H, width=W,
              dtype=torch.float32)
    lat = port_pipe(**kw, seed=1, output_type="latent")
    assert tuple(lat.shape) == (1, (H // 4) * (W // 4), 16)
    pil = port_pipe(**kw, seed=1)
    assert isinstance(pil[0], Image.Image) and pil[0].size == (W, H)
    a = port_pipe(**kw, seed=1, output_type="np")
    b = port_pipe(**kw, seed=1, output_type="np")
    c = port_pipe(**kw, seed=2, output_type="np")
    np.testing.assert_array_equal(a, b)            # the generator is seeded by `seed`
    assert np.abs(a - c).max() > 1e-4
    with pytest.raises(ValueError, match="noise"):
        port_pipe(**kw, noise={"latent": np.zeros(1)})


def test_explicit_prompt_survives_words(port_pipe):
    """An explicit prompt override is never replaced by the words template;
    only the missing prompt is derived from the words."""
    from textflux_torch.pipeline.prompts import GENERIC_TEMPLATE, words_prompt

    seen = []
    clip_tok, t5_tok = port_pipe.clip_tokenize, port_pipe.t5_tokenize
    port_pipe.clip_tokenize = lambda p: (seen.append(("clip", p)), clip_tok(p))[1]
    port_pipe.t5_tokenize = lambda p: (seen.append(("t5", p)), t5_tok(p))[1]
    img, mask = _fixture_inputs()
    try:
        port_pipe(image=img, mask_image=mask, words=["OPEN"], prompt_2="my own t5 prompt",
                  height=H, width=W, seed=0, dtype=torch.float32, output_type="latent",
                  num_inference_steps=1)
        assert seen == [("clip", GENERIC_TEMPLATE), ("t5", "my own t5 prompt")]
        seen.clear()
        port_pipe(image=img, mask_image=mask, words=["OPEN"], height=H, width=W, seed=0,
                  dtype=torch.float32, output_type="latent", num_inference_steps=1)
        assert seen == [("clip", GENERIC_TEMPLATE), ("t5", words_prompt(["OPEN"]))]
        with pytest.raises(ValueError, match="prompt_2"):
            port_pipe(image=img, mask_image=mask, prompt="only one", height=H, width=W)
    finally:
        port_pipe.clip_tokenize, port_pipe.t5_tokenize = clip_tok, t5_tok


def test_rendered_canvas_matches_golden():
    """The port's copy of the glyph-render + concat path against the canvas
    goldens, with tests/test_golden.py's tolerances."""
    from textflux_torch.rendering.compose import concat_singleline
    from textflux_torch.rendering.glyph import draw_glyph_strip, load_font

    img, mask = _fixture_inputs()
    strip = draw_glyph_strip(load_font(), "OPEN", img.width, img.height)
    canvas, full_mask, strip_h = concat_singleline(img, mask, strip)
    assert strip_h == strip.height
    for name, arr, mean_tol in (
            ("canvas", np.asarray(canvas.convert("RGB"), np.float32) / 255.0, 0.01),
            ("canvas_mask", np.asarray(full_mask.convert("L"), np.float32) / 255.0, 0.005)):
        want = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["out"]
        assert want.shape == arr.shape
        assert float(np.mean(np.abs(arr - want))) < mean_tol, name


def _byte_tokenizers():
    def clip_tok(prompt):
        body = list(prompt.encode()[:14])
        return np.asarray([[98] + body + [99] * (15 - len(body))]) % 100

    def t5_tok(prompt):
        return (np.frombuffer(prompt.encode()[:16].ljust(16), np.uint8) % 99)[None].astype(np.int64)

    return clip_tok, t5_tok


def _tiny_8x_pipeline(device="cpu"):
    """A tiny pipeline with an 8x VAE (four blocks), so the example canvas
    (512x448) packs to the serving path's 896 image tokens while staying
    small."""
    g = torch.Generator().manual_seed(0)
    vae_cfg = VAEConfig(block_out_channels=(4, 4, 4, 8), layers_per_block=1,
                        latent_channels=4, norm_num_groups=4)
    flux_cfg = FluxConfig(in_channels=16 + 256 + 16, out_channels=16, num_double_layers=1,
                          num_single_layers=1, num_heads=2, head_dim=64, joint_dim=32,
                          pooled_dim=16, axes_dims_rope=(32, 16, 16))
    clip_tok, t5_tok = _byte_tokenizers()
    return FillPipeline(
        flux=FluxTransformer(flux_cfg, device=device, generator=g),
        vae=FluxVAE(vae_cfg, device=device, generator=g),
        clip=CLIPTextModel(CLIPTextConfig(vocab_size=100, hidden_dim=16, num_layers=1,
                                          num_heads=2, mlp_dim=32, max_positions=16,
                                          eos_token_id=99), device=device, generator=g),
        t5=T5Encoder(T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                              num_heads=4), device=device, generator=g),
        clip_tokenize=clip_tok, t5_tokenize=t5_tok, device=device)


@pytest.mark.parametrize("sampler", ["euler", "overshoot"])
def test_run_inference_on_example(sampler, tmp_path):
    from textflux_torch.cli.run_inference import run, save_results

    pipe = _tiny_8x_pipeline()
    assert pipe.attn_impl == "plain"        # the CPU default
    paths = [os.path.join(EXAMPLE, sub, name) for sub, name in
             (("ori", "ori_0001.png"), ("mask", "mask_0001.png"), ("txt", "words_0001.txt"))]
    result, cropped, rendered, original, mask = run(pipe, *paths, steps=2, seed=0,
                                                    sampler=sampler, device="cpu")
    # 512x384 scene + 80-row glyph strip -> 512x464 -> //32 snap -> 512x448
    assert result.size == (512, 448) and pipe.last_joint_seq == 16 + 896
    assert cropped.size[0] == 512 and cropped.size[1] < 448
    arr = np.asarray(result, np.float32)
    assert np.isfinite(arr).all() and arr.std() > 0
    seq = save_results(str(tmp_path), result, cropped, mask, original, rendered, paths[2])
    assert (tmp_path / f"result_{seq}.png").exists()
    assert (tmp_path / "crop" / f"crop_{seq}.png").exists()


def test_fused_path_on_cpu_matches_plain():
    """attn_impl="fused" on the CPU runs the kernel's plain version on
    half-permuted weights; in float32 it must give the plain path's images
    (the permutation is a similarity transform of the logits)."""
    plain = _tiny_8x_pipeline()
    fused = _tiny_8x_pipeline()
    fused = FillPipeline(flux=fused.flux, vae=fused.vae, clip=fused.clip, t5=fused.t5,
                         clip_tokenize=fused.clip_tokenize, t5_tokenize=fused.t5_tokenize,
                         attn_impl="fused", device="cpu")
    assert fused.flux.rope_layout == "half"
    img, mask = _fixture_inputs()
    kw = dict(image=img, mask_image=mask, words=["OPEN"], seed=0, num_inference_steps=2,
              dtype=torch.float32, output_type="np")
    np.testing.assert_allclose(fused(**kw), plain(**kw), atol=1e-4)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from textflux_torch.cli.run_inference import run

    cfg = FluxConfig(in_channels=48, out_channels=16, num_double_layers=1,
                     num_single_layers=1, num_heads=2, head_dim=8, joint_dim=32,
                     pooled_dim=16, axes_dims_rope=(4, 2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        FluxTransformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        FluxVAE(VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                          latent_channels=4, norm_num_groups=4))
    flux = FluxTransformer(cfg, device="cpu")
    vae = FluxVAE(VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                            latent_channels=4, norm_num_groups=4), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FillPipeline(flux=flux, vae=vae)
    pipe = FillPipeline(flux=flux, vae=vae, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(pipe, "unused.png", "unused.png", "unused.txt")
