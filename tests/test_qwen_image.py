"""Qwen-Image in the port, at a tiny size on the CPU, against the plain
float32 reference under ``h100_bench/reference`` (one seeded state dict of
names fills both): the DiT forward on both attention paths the CPU runs,
the bucketed text against the unpadded one, the centred RoPE ids, the
Qwen2.5 encoder (and the reference's equations against ``transformers``'
Qwen2.5-VL language model), the Wan VAE, one whole denoise step, and the
diffusers-layout checkpoint through ``from_pretrained`` and the CLI."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from h100_bench import weights
from h100_bench.reference import qwen_image as Q, qwen_text as QT, vae_wan as W
from textflux_torch.config import WanVAEConfig
from textflux_torch.io import config_io
from textflux_torch.io.params import key_map
from textflux_torch.io.safetensors import save_file
from textflux_torch.models import transformer as T
from textflux_torch.models.qwen_image import (QwenImageTransformer, model_timesteps, qwen_apply,
                                              qwen_vec, rope_ids, text_bucket)
from textflux_torch.models.qwen_text import QwenTextEncoder, qwen_encode
from textflux_torch.models.vae_wan import WanVAE, wan_decode, wan_encode
from textflux_torch.ops import packing, samplers
from textflux_torch.config import FluxConfig
from textflux_torch.ops.rope import rope_tables, rope_tables_half
from textflux_torch.pipeline.prompts import QWEN_PREFIX, QWEN_TEMPLATE
from textflux_torch.pipeline.qwen_image import QwenImagePipeline

SEED = 2 ** 31 + 11
BYTE_TEMPLATE_DROP = QT.TEMPLATE_DROP     # the system prefix's bytes


def byte_tokenize(text):
    """A stand-in tokenizer: the text's UTF-8 bytes, (1, L)."""
    return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)[None]
DIT = {"_class_name": "QwenImageTransformer2DModel", "attention_head_dim": 16,
       "axes_dims_rope": [4, 6, 6], "guidance_embeds": False, "in_channels": 64,
       "joint_attention_dim": 32, "num_attention_heads": 2, "num_layers": 2, "out_channels": 16,
       "patch_size": 2}
TEXT = {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 4,
        "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
        "rope_theta": 1000000.0, "vocab_size": 256}
VAE = {"_class_name": "AutoencoderKLQwenImage", "attn_scales": [], "base_dim": 8,
       "dim_mult": [1, 2, 2, 2], "num_res_blocks": 1, "temperal_downsample": [False, True, True],
       "z_dim": 16, "latents_mean": list(WanVAEConfig().latents_mean),
       "latents_std": list(WanVAEConfig().latents_std)}


def _cfg(folder, name, c, read):
    os.makedirs(folder / name, exist_ok=True)
    (folder / name / "config.json").write_text(json.dumps(c))
    return read(str(folder / name))


def _seeded(module, kind, skeleton):
    """`module` (float32, on the CPU) with the seed's weights, as the
    benchmark fills both sides."""
    sd = weights.state_dict(SEED, kind, weights.groups(skeleton), "cpu", torch.float32)
    module.load_state_dict(sd, strict=True)
    return module.requires_grad_(False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    folder = tmp_path_factory.mktemp("qwen_cfg")
    dit = _seeded(QwenImageTransformer(_cfg(folder, "transformer", DIT,
                                            config_io.qwen_image_config_from), device="cpu"),
                  Q.MODEL, Q.QwenDiT(DIT))
    text = _seeded(QwenTextEncoder(_cfg(folder, "text_encoder", TEXT,
                                        config_io.qwen_text_config_from), device="cpu"),
                   QT.MODEL, QT.QwenText(TEXT))
    vae = _seeded(WanVAE(_cfg(folder, "vae", VAE, config_io.wan_vae_config_from), device="cpu"),
                  W.MODEL, W.WanVAE(VAE))
    return dit, text, vae


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _dit_inputs(dit, grid, n_txt, sigma=0.6, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, grid[0] * grid[1], 64, generator=g)
    txt = torch.randn(1, n_txt, 32, generator=g)
    mods = T.flux_mods(dit, qwen_vec(dit, model_timesteps([sigma]), torch.float32))
    return x, txt, mods


def test_centred_rope_ids_by_hand():
    """A 3 x 5 grid of image tokens and two text tokens: rows -2..0,
    columns -3..1, the text from max(1, 2) = 2 on every axis."""
    ids = rope_ids(3, 5, 2)
    want = [(0, r, c) for r in (-2, -1, 0) for c in (-3, -2, -1, 0, 1)] + [(2, 2, 2), (3, 3, 3)]
    assert ids.tolist() == [list(map(float, w)) for w in want]
    txt, img = Q.rope_ids(3, 5, 2, "cpu")
    assert torch.equal(torch.cat([img, txt]), torch.as_tensor(ids))


@pytest.mark.parametrize("attn_impl", ["plain", "fused", "auto"])
def test_dit_forward_matches_the_reference(models, attn_impl):
    """On each path the serving pipeline may take ("auto" is "plain" on the
    CPU), its layout and tables from the shared functions."""
    dit = QwenImageTransformer(models[0].cfg, device="cpu")
    dit.load_state_dict(models[0].state_dict())
    attn_impl = T.resolve_attn_impl(attn_impl, dit.cfg.head_dim, torch.device("cpu"))
    T.to_attn_layout(dit, attn_impl)
    grid, n_txt, sigma = (4, 6), 7, 0.6
    x, txt, mods = _dit_inputs(dit, grid, n_txt, sigma)
    cos, sin = T.model_rope_tables(dit, rope_ids(*grid, n_txt), "cpu")
    with torch.no_grad():
        v = qwen_apply(dit, x, txt, cos, sin, mods=mods, attn_impl=attn_impl)
    ref = Q.velocities(DIT, SEED, [dict(x=x, txt=txt, sigma=sigma, grid=grid)], "cpu")[0]
    assert v.shape == (1, 24, 64)
    assert _rel(v, ref) < 1e-4


@pytest.mark.parametrize("attn_impl", ["plain", "fused"])
def test_bucketed_text_matches_the_unpadded(models, attn_impl):
    """The text zero-padded to its bucket after the image, its padding
    masked by a key-length tensor: the velocity of the unpadded call."""
    dit = QwenImageTransformer(models[0].cfg, device="cpu")
    dit.load_state_dict(models[0].state_dict())
    T.to_attn_layout(dit, attn_impl)
    grid, n_txt = (4, 4), 37
    x, txt, mods = _dit_inputs(dit, grid, n_txt)
    bucket = text_bucket(n_txt)
    assert bucket == 64

    def call(t, n, kv_len):
        cos, sin = T.model_rope_tables(dit, rope_ids(*grid, n), "cpu")
        with torch.no_grad():
            return qwen_apply(dit, x, t, cos, sin, mods=mods, attn_impl=attn_impl, kv_len=kv_len)

    plain = call(txt, n_txt, None)
    padded = call(torch.nn.functional.pad(txt, (0, 0, 0, bucket - n_txt)), bucket,
                  torch.tensor([16 + n_txt], dtype=torch.int32))
    unmasked = call(torch.nn.functional.pad(txt, (0, 0, 0, bucket - n_txt)), bucket, None)
    assert _rel(padded, plain) < 1e-5
    assert _rel(unmasked, plain) > 1e-3      # the padding, left unmasked, shows


@pytest.mark.parametrize("attn_impl", ["auto", "fused", "unknown"])
@pytest.mark.parametrize("kind", ["flux", "qwen"])
def test_the_serving_attention_path(models, kind, attn_impl):
    """What both pipelines decide through the shared functions, on tiny
    FLUX and Qwen-Image DiTs: "auto" is "plain" on the CPU (and on CUDA for
    a head_dim the fused kernel does not take), leaving the weights and
    tables interleaved; "fused" half-permutes the weights once and takes
    rotate-half tables; an unknown name raises."""
    if kind == "flux":
        dit = T.FluxTransformer(FluxConfig(in_channels=8, out_channels=4, num_double_layers=1,
                                           num_single_layers=1, num_heads=2, head_dim=16,
                                           joint_dim=8, pooled_dim=8, axes_dims_rope=(4, 6, 6)),
                                device="cpu")
        ids = np.arange(15, dtype=np.float64).reshape(5, 3)
    else:
        dit = QwenImageTransformer(models[0].cfg, device="cpu")
        ids = rope_ids(2, 3, 4)
    if attn_impl == "unknown":
        with pytest.raises(ValueError, match="attn_impl"):
            T.resolve_attn_impl(attn_impl, dit.cfg.head_dim, torch.device("cpu"))
        with pytest.raises(ValueError, match="attn_impl"):
            T.check_attn_layout(dit, attn_impl)
        return
    assert T.resolve_attn_impl("auto", dit.cfg.head_dim, torch.device("cuda")) == "plain"
    impl = T.resolve_attn_impl(attn_impl, dit.cfg.head_dim, torch.device("cpu"))
    assert impl == {"auto": "plain", "fused": "fused"}[attn_impl]
    weight = dit.double_blocks[0].img_qkv.weight.clone()
    for _ in range(2):                     # a second call leaves the layout as it is
        assert T.to_attn_layout(dit, impl) is dit
    T.check_attn_layout(dit, impl)
    assert dit.rope_layout == ("half" if impl == "fused" else "interleaved")
    assert torch.equal(dit.double_blocks[0].img_qkv.weight, weight) is (impl == "plain")
    fn = rope_tables_half if impl == "fused" else rope_tables
    for got, want in zip(T.model_rope_tables(dit, ids, "cpu"),
                         fn(ids, dit.cfg.axes_dims_rope, dit.cfg.rope_theta)):
        assert torch.equal(got, torch.as_tensor(want))


def test_text_buckets():
    assert [text_bucket(n) for n in (1, 34, 64, 65, 320, 410, 512, 513)] == \
        [64, 64, 64, 128, 512, 512, 512, 1024]


def test_encoder_matches_the_reference(models):
    _, text, _ = models
    prompt = "The words 'Qwen' and 'abc'"
    assert QT.TEMPLATE == QWEN_TEMPLATE and len(QWEN_PREFIX.encode()) == QT.TEMPLATE_DROP == 180
    ids = torch.as_tensor(QT.byte_ids(prompt))
    assert torch.equal(ids, torch.as_tensor(byte_tokenize(QWEN_TEMPLATE.format(prompt))))
    with torch.no_grad():
        out = qwen_encode(text, ids, dtype=torch.float32)[:, QT.TEMPLATE_DROP:]
    ref = QT.encode(TEXT, SEED, [prompt], "cpu")[0]
    assert out.shape == ref.shape == (1, ids.shape[1] - BYTE_TEMPLATE_DROP, 32)
    assert _rel(out, ref) < 1e-5


def test_encoder_reference_matches_transformers():
    """The reference's equations against transformers' Qwen2.5-VL language
    model at a tiny size (its own M-RoPE with equal t/h/w positions)."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLTextConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VLTextModel

    hf_cfg = Qwen2_5_VLTextConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=1e6,
                                  rope_scaling={"type": "mrope", "mrope_section": [2, 1, 1]},
                                  attn_implementation="eager")
    hf = Qwen2_5_VLTextModel(hf_cfg).eval()
    sd = weights.state_dict(SEED, QT.MODEL, weights.groups(QT.QwenText(TEXT)), "cpu",
                            torch.float32)
    names = {"embed_tokens": "embed_tokens.weight", "final_norm": "norm.weight",
             "attn_norm": "input_layernorm.weight", "mlp_norm": "post_attention_layernorm.weight",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    hf_sd = {}
    for name, t in sd.items():
        parts = name.split(".")
        if parts[0] == "layers":
            rest = names[parts[2]] + ("" if parts[2].endswith("norm") else "." + parts[3])
            hf_sd[f"layers.{parts[1]}.{rest}"] = t
        else:
            hf_sd[names[parts[0]]] = t
    hf.load_state_dict(hf_sd, strict=True)
    prompt = "'TextFlux' on a sign"
    with torch.no_grad():
        want = hf(input_ids=torch.as_tensor(QT.byte_ids(prompt))).last_hidden_state
    got = QT.encode(TEXT, SEED, [prompt], "cpu")[0]
    assert _rel(got, want[:, QT.TEMPLATE_DROP:]) < 1e-5


def test_wan_vae_matches_the_reference(models):
    _, _, vae = models
    ref = W.build(VAE, SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    img = torch.rand(1, 48, 32, 3, generator=g) * 2 - 1
    with torch.no_grad():
        z = wan_encode(vae, img)
        assert z.shape == (1, 6, 4, 16)
        assert _rel(z, W.encode(ref, img)) < 1e-5
        out = wan_decode(vae, z)
        want = W.decode(ref, z)
    assert out.shape == (1, 48, 32, 3) and float(out.abs().max()) <= 1.0
    assert float((out - want).abs().max()) < 1e-4


def test_one_denoise_step_matches_the_reference(models):
    """Schedule, both velocities, true CFG with its rescale, Euler and the
    blend of one step of the pipeline against the reference's, float32."""
    dit, text, vae = models
    pipe = QwenImagePipeline(dit=dit, vae=vae, text_encoder=text, tokenize=byte_tokenize,
                             template_drop=BYTE_TEMPLATE_DROP, attn_impl="plain", device="cpu")
    sig = samplers.make_terminal_schedule(30, 3000, max_seq_len=8192, max_shift=0.9)
    assert np.array_equal(sig, Q.schedule(30, 3000)) and sig[-2] == np.float32(0.02)
    grid = (4, 4)
    g = torch.Generator().manual_seed(5)
    x, z0, noise = (torch.randn(1, 16, 64, generator=g) for _ in range(3))
    mask = (torch.rand(1, 16, 64, generator=g) > 0.5).float()
    txt_pos, txt_neg = torch.randn(1, 11, 32, generator=g), torch.randn(1, 3, 32, generator=g)
    texts = pipe._texts(txt_pos, txt_neg, *grid)
    assert [t[0].shape[1] for t in texts] == [64, 64]
    assert pipe.text_tokens == {"real": 14, "padded": 114}
    k = 7
    mods = T.flux_mods(dit, qwen_vec(dit, model_timesteps([sig[k]]), torch.float32))
    with torch.no_grad():
        out = pipe._denoise_step(x, texts, mods, sig[k], sig[k + 1], cfg_scale=4.0, mask=mask,
                                 z0=z0, noise=noise)
    jobs = [dict(x=x, txt=t, sigma=float(sig[k]), grid=grid) for t in (txt_pos, txt_neg)]
    v_pos, v_neg = Q.velocities(DIT, SEED, jobs, "cpu")
    want = Q.euler_blend(x, Q.guide(v_pos, v_neg, 4.0), sig[k], sig[k + 1], mask, z0, noise)
    assert float((out - want).abs().max()) < 1e-4
    # the unmasked tokens are z0 noised to the next sigma
    s = float(sig[k + 1])
    keep = mask == 0
    assert torch.allclose(out[keep], ((1 - s) * z0 + s * noise)[keep], atol=1e-6)


def test_true_cfg_rescales_to_the_conditional_norm():
    g = torch.Generator().manual_seed(2)
    c, u = torch.randn(2, 9, 64, generator=g), torch.randn(2, 9, 64, generator=g)
    v = samplers.true_cfg(c, u, 4.0)
    assert torch.allclose(v.norm(dim=-1), c.norm(dim=-1), rtol=1e-5)
    assert torch.allclose(v, Q.guide(c, u, 4.0), atol=1e-6)


def _checkpoint(folder, models):
    """A diffusers-layout Qwen-Image checkpoint of `models`, with the
    vision tower and lm_head the text encoder's file holds beside."""
    dit, text, vae = models
    for sub, model, c in (("transformer", dit, DIT), ("text_encoder", text, TEXT),
                          ("vae", vae, VAE)):
        os.makedirs(folder / sub, exist_ok=True)
        (folder / sub / "config.json").write_text(json.dumps(c))
        sd = {k: (t if rows is None else t[rows]).detach().clone()
              for k, (t, rows) in key_map(model).items()}
        if sub == "text_encoder":
            sd["lm_head.weight"] = torch.zeros(256, 32)
            sd["visual.blocks.0.attn.qkv.weight"] = torch.zeros(3, 3)
        save_file(sd, str(folder / sub / "diffusion_pytorch_model.safetensors"))
        yield sub, sd


def test_checkpoint_names_and_from_pretrained(models, tmp_path):
    written = dict(_checkpoint(tmp_path, models))
    dit_keys, vae_keys = written["transformer"], written["vae"]
    for k in ("img_in.weight", "txt_norm.weight", "txt_in.bias", "proj_out.weight",
              "time_text_embed.timestep_embedder.linear_2.weight", "norm_out.linear.weight",
              "transformer_blocks.1.img_mod.1.weight", "transformer_blocks.1.txt_mod.1.bias",
              "transformer_blocks.0.attn.add_k_proj.bias", "transformer_blocks.0.attn.norm_added_q.weight",
              "transformer_blocks.0.attn.to_add_out.weight", "transformer_blocks.0.img_mlp.net.2.weight",
              "transformer_blocks.0.txt_mlp.net.0.proj.weight"):
        assert k in dit_keys, k
    assert not any("single" in k for k in dit_keys)
    assert tuple(vae_keys["encoder.down_blocks.0.norm1.gamma"].shape) == (8, 1, 1, 1)
    assert tuple(vae_keys["encoder.mid_block.attentions.0.norm.gamma"].shape) == (16, 1, 1)
    assert tuple(vae_keys["encoder.conv_in.weight"].shape) == (8, 3, 3, 3, 3)
    assert tuple(vae_keys["decoder.up_blocks.0.upsamplers.0.time_conv.weight"].shape) == \
        (32, 16, 3, 1, 1)
    # one residual block a level: the levels' resamples at 1, 3 and 5, the
    # first spatial alone
    assert "encoder.down_blocks.1.resample.1.weight" in vae_keys
    assert "encoder.down_blocks.1.time_conv.weight" not in vae_keys
    assert "encoder.down_blocks.5.time_conv.bias" in vae_keys
    assert "model.layers.1.self_attn.q_proj.bias" in written["text_encoder"]
    assert config_io.transformer_class(str(tmp_path / "transformer")) == \
        "QwenImageTransformer2DModel"
    pipe = QwenImagePipeline.from_pretrained(str(tmp_path), tokenize=byte_tokenize,
                                             template_drop=BYTE_TEMPLATE_DROP,
                                             dtype=torch.float32, device="cpu")
    for loaded, model in zip((pipe.dit, pipe.text_encoder, pipe.vae), models):
        want = model.state_dict()
        for name, t in loaded.state_dict().items():
            assert torch.equal(t.float(), want[name].float()), name


def test_cli_serves_a_qwen_image_checkpoint(models, tmp_path, monkeypatch):
    """``run_inference.main`` picks the Qwen-Image pipeline from the
    transformer's ``_class_name`` and edits the example through ``run``."""
    from textflux_torch.cli import run_inference
    from textflux_torch.pipeline import qwen_image

    dict(_checkpoint(tmp_path / "ckpt", models))
    monkeypatch.setattr(qwen_image, "load_qwen_tokenizer",
                        lambda path: (byte_tokenize, BYTE_TEMPLATE_DROP))
    scene = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    mask = np.zeros_like(scene)
    mask[16:48, 20:60] = 255
    Image.fromarray(scene).save(tmp_path / "scene.png")
    Image.fromarray(mask).save(tmp_path / "mask.png")
    (tmp_path / "words.txt").write_text("Qwen\n")
    run_inference.main(["--model", str(tmp_path / "ckpt"), "--image", str(tmp_path / "scene.png"),
                        "--mask", str(tmp_path / "mask.png"), "--words",
                        str(tmp_path / "words.txt"), "--steps", "2", "--device", "cpu",
                        "--output-dir", str(tmp_path / "out")])
    result = Image.open(tmp_path / "out" / "result_0001.png")
    crop = Image.open(tmp_path / "out" / "crop" / "crop_0001.png")
    # the canvas is snapped to multiples of 32: 96 wide, the strip and scene
    # (15 + 64 rows) cut to 64, of which the crop keeps the scene's share
    assert result.size == (96, 64) and crop.size[0] == 96


def test_flux_double_block_is_the_same_in_either_order():
    """FLUX's [txt | img] joint sequence and Qwen-Image's [img | txt] give
    the same block: attention does not see the order."""
    from textflux_torch.config import FluxConfig

    cfg = FluxConfig(num_heads=2, head_dim=16, num_double_layers=1, num_single_layers=0)
    blk = T.DoubleBlock(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    txt, img = torch.randn(1, 5, 32, generator=g), torch.randn(1, 12, 32, generator=g)
    mods = tuple(torch.randn(1, 6 * 32, generator=g) * 0.1 for _ in range(2))
    ids = packing.latent_image_ids(6, 8)
    tids = np.zeros((5, 3))
    cos, sin = (torch.as_tensor(t) for t in rope_tables(np.concatenate([tids, ids]), (4, 6, 6)))
    cos2, sin2 = (torch.as_tensor(t) for t in rope_tables(np.concatenate([ids, tids]),
                                                          (4, 6, 6)))
    with torch.no_grad():
        a = T.double_block(blk, cfg, txt, img, mods, cos, sin, "plain", None)
        b = T.double_block(blk, cfg, txt, img, mods, cos2, sin2, "plain", None, img_first=True)
    for x, y in zip(a, b):
        assert torch.allclose(x, y, atol=1e-5)
