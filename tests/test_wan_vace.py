"""Wan2.1-VACE in the port, at a tiny size on the CPU (2 heads of 128, 3
main blocks, ``vace_layers`` [0, 2], clips of 5 and 9 frames), against the
plain float32 references under ``h100_bench/reference`` on seeded random
weights (one state dict of names fills both sides): the DiT with its VACE
branch on both attention paths, the benchmark's part-by-part judgement on
the program's own taps, UMT5 (and its reference against ``transformers``'
UMT5), the clip VAE over more than one chunk, the single-frame VAE held
bitwise to its code before the clip path was added, and the
diffusers-layout checkpoint through ``from_pretrained`` and the CLI."""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

from h100_bench import weights
from h100_bench.reference import canvas, umt5 as U, vae_wan as W, vae_wan_video as WV
from h100_bench.reference import wan_vace as R
from textflux_torch.config import WanVAEConfig
from textflux_torch.io import config_io
from textflux_torch.io.params import key_map
from textflux_torch.io.safetensors import save_file
from textflux_torch.models import transformer as T
from textflux_torch.models.layers import silu
from textflux_torch.models.t5 import T5Encoder, t5_encode
from textflux_torch.models.vae_wan import (AttnBlock, MidBlock, Resample, ResBlock, RMSNorm,
                                           WanVAE, wan_decode, wan_decode_video, wan_encode,
                                           wan_encode_video)
from textflux_torch.models.wan import (WanVACETransformer, patchify, rope_ids, step_mods,
                                       unpatchify, wan_mods, wan_temb)
from textflux_torch.ops import flash_attention as FA
from textflux_torch.pipeline.wan_vace import WanVACEPipeline, mask_control

SEED = 2 ** 31 + 23
DIT = {"_class_name": "WanVACETransformer3DModel", "attention_head_dim": 128,
       "cross_attn_norm": True, "eps": 1e-6, "ffn_dim": 96, "freq_dim": 256,
       "in_channels": 16, "num_attention_heads": 2, "num_layers": 3, "out_channels": 16,
       "patch_size": [1, 2, 2], "qk_norm": "rms_norm_across_heads", "text_dim": 32,
       "vace_in_channels": 96, "vace_layers": [0, 2]}
TEXT = {"architectures": ["UMT5EncoderModel"], "d_ff": 64, "d_kv": 8, "d_model": 32,
        "feed_forward_proj": "gated-gelu", "layer_norm_epsilon": 1e-6, "model_type": "umt5",
        "num_heads": 4, "num_layers": 2, "relative_attention_max_distance": 128,
        "relative_attention_num_buckets": 32, "vocab_size": 300}
VAE = {"_class_name": "AutoencoderKLWan", "attn_scales": [], "base_dim": 8,
       "dim_mult": [1, 2, 2, 2], "num_res_blocks": 1, "temperal_downsample": [False, True, True],
       "z_dim": 16, "latents_mean": list(WanVAEConfig().latents_mean),
       "latents_std": list(WanVAEConfig().latents_std)}


def byte_tokenize(text):
    """A stand-in tokenizer: the text's UTF-8 bytes + 3, then EOS (1)."""
    return canvas.t5_ids(text, len(text.encode("utf-8")) + 1)


def _cfg(folder, name, c, read):
    os.makedirs(folder / name, exist_ok=True)
    (folder / name / "config.json").write_text(json.dumps(c))
    return read(str(folder / name))


def _seeded(module, kind, spec):
    sd = weights.state_dict(SEED, kind, spec, "cpu", torch.float32)
    module.load_state_dict(sd, strict=True)
    return module.requires_grad_(False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    folder = tmp_path_factory.mktemp("wan_cfg")
    dit = _seeded(WanVACETransformer(_cfg(folder, "transformer", DIT,
                                          config_io.wan_vace_config_from), device="cpu"),
                  R.MODEL, R.groups(R.WanDiT(DIT)))
    text = _seeded(T5Encoder(_cfg(folder, "text_encoder", TEXT, config_io.t5_config_from),
                             device="cpu"), U.MODEL, weights.groups(U.UMT5(TEXT)))
    vae = _seeded(WanVAE(_cfg(folder, "vae", VAE, config_io.wan_vae_config_from), device="cpu"),
                  W.MODEL, weights.groups(W.WanVAE(VAE)))
    return dit, text, vae


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _dit_inputs(frames=2, grid=(2, 3), seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (1, frames, 2 * grid[0], 2 * grid[1])
    lat = torch.randn(*shape, 16, generator=g)
    control = torch.randn(*shape, 96, generator=g)
    text = torch.randn(1, 512, 32, generator=g)
    text[:, 20:] = 0.0
    return lat, control, text


def _forward(dit, lat, control, text, sigma, attn_impl, taps=None):
    p = dit.cfg.patch_size
    cos, sin = T.model_rope_tables(dit, rope_ids(lat.shape[1] // p[0], lat.shape[2] // p[1],
                                                 lat.shape[3] // p[2]), "cpu")
    mods = step_mods(wan_mods(dit, wan_temb(dit, [sigma], torch.float32)), 0, 1)
    with torch.no_grad():
        if taps is not None:
            return dit._forward(lat, control, text, cos, sin, attn_impl=attn_impl, mods=mods,
                                taps=taps)
        return dit(lat, control, text, cos, sin, mods=mods, attn_impl=attn_impl)


@pytest.mark.parametrize("attn_impl", ["plain", "fused", "auto"])
def test_dit_forward_matches_the_reference(models, attn_impl):
    """The DiT with its branch on each path serving may take ("auto" is
    "plain" on the CPU; "fused" runs the kernels' plain versions), against
    the reference's whole forward."""
    dit = models[0]
    attn_impl = T.resolve_attn_impl(attn_impl, dit.cfg.head_dim, torch.device("cpu"))
    assert T.to_attn_layout(dit, attn_impl) is dit and dit.rope_layout == "interleaved"
    T.check_attn_layout(dit, attn_impl)    # both paths read the checkpoint's order
    lat, control, text = _dit_inputs()
    hints = dit.vace_hints
    v = _forward(dit, lat, control, text, 0.7, attn_impl)
    ref = R.velocity(DIT, SEED, [dict(latents=lat, control=control, text=text, sigma=0.7)],
                     "cpu")[0]
    assert v.shape == lat.shape
    assert _rel(v, ref) < 1e-4
    assert dit.vace_hints - hints == 2
    # the branch matters: without its hints the velocity moves
    silent = copy.deepcopy(dit)
    for b in silent.vace_blocks:
        b.proj_out.weight.zero_()
        b.proj_out.bias.zero_()
    assert _rel(_forward(silent, lat, control, text, 0.7, attn_impl), ref) > 1e-2


def test_the_judged_parts_of_a_forward(models):
    """The benchmark's judgement (``wan_vace.stage_gaps`` and
    ``glue_ulps``) on the program's own taps: every part within float32
    rounding, and a planted fault (a hint added twice) read by the glue."""
    dit = models[0]
    lat, control, text = _dit_inputs(frames=3, grid=(3, 2), seed=1)
    taps = {"blocks": {0: {}, 1: {}}, "vace": {0: {}, 1: {}}}
    v = _forward(dit, lat, control, text, 0.4, "fused", taps)
    job = dict(latents=lat, control=control, text=text, sigma=0.4, v=v, first=taps["first"],
               last=taps["last"], blocks=taps["blocks"], vace=taps["vace"])
    gaps = R.stage_gaps(DIT, SEED, [job], "cpu")[0]
    stages = {s for s, _, _ in gaps}
    assert {"embed", "mod.0", "self.0", "cross.1", "ffn.1", "proj_in", "hint.v1", "head",
            "mod.v0", "self.v1"} <= stages
    assert max(g for _, g, _ in gaps) < 1e-4
    assert R.glue_ulps(job, DIT["vace_layers"]) < 1e-3
    job["blocks"][0]["hinted"] = job["blocks"][0]["hinted"] + job["vace"][0]["hint"]
    assert R.glue_ulps(job, DIT["vace_layers"]) > 100


def test_umt5_matches_the_reference(models):
    """The port's T5 with a relative bias in every layer, run as the
    pipeline runs it (the 512 padded ids under the attention mask, rows
    past the prompt zero), against the reference."""
    text = models[1]
    assert not text.cfg.shared_pos and not hasattr(text, "rel_bias")
    assert all(tuple(layer.rel_bias.shape) == (32, 4) for layer in text.layers)
    pipe = WanVACEPipeline(dit=models[0], vae=models[2], text_encoder=text,
                           tokenize=byte_tokenize, device="cpu")
    prompts = ["the words 'Sale' and 'Open'", pipe.pipe_cfg.negative_prompt]
    got = pipe.encode_prompts(prompts[0], torch.float32)
    want = U.encode(TEXT, SEED, prompts, "cpu")
    for g, w, p in zip(got, want, prompts):
        n = len(p.encode("utf-8")) + 1
        assert g.shape == (1, 512, 32)
        assert _rel(g[:, :n], w[:, :n]) < 1e-5
        assert torch.equal(g[:, n:], torch.zeros_like(g[:, n:]))
        assert torch.equal(w[:, n:], torch.zeros_like(w[:, n:]))


def test_umt5_reference_matches_transformers(models):
    """The reference's equations against ``transformers``' UMT5 encoder on
    the port's weights carried over by the checkpoint key map."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.UMT5Config(vocab_size=300, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                                  num_heads=4, relative_attention_num_buckets=32,
                                  relative_attention_max_distance=128,
                                  feed_forward_proj="gated-gelu", dropout_rate=0.0,
                                  layer_norm_epsilon=1e-6)
    hf = transformers.UMT5EncoderModel(cfg).eval()
    sd = {k: (t if rows is None else t[rows]) for k, (t, rows) in key_map(models[1]).items()}
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {"encoder.embed_tokens.weight"}
    hf.encoder.embed_tokens.weight = hf.shared.weight
    prompt = "a sign that says 'Bakery'"
    ids = torch.as_tensor(canvas.t5_ids(prompt, 512))
    with torch.no_grad():
        out = hf(input_ids=ids, attention_mask=(ids > 0).long()).last_hidden_state
    want = U.encode(TEXT, SEED, [prompt], "cpu")[0]
    n = int((ids > 0).sum())
    assert _rel(out[:, :n], want[:, :n]) < 1e-5


@pytest.mark.parametrize("frames", [5, 9])
def test_clip_vae_matches_the_reference(models, frames):
    """The chunked, cached clip path against the reference's whole-clip
    form: 5 frames are two chunks, 9 three."""
    vae = models[2]
    video = torch.rand(1, frames, 32, 48, 3, generator=torch.Generator().manual_seed(frames))
    video = video * 2 - 1
    ref = W.build(VAE, SEED, "cpu")
    z = wan_encode_video(vae, video)
    assert z.shape == (1, 1 + (frames - 1) // 4, 4, 6, 16)
    assert _rel(z, WV.encode(ref, video)) < 1e-5
    out = wan_decode_video(vae, z)
    assert out.shape == video.shape
    assert _rel(out, WV.decode(ref, z)) < 1e-5
    with pytest.raises(ValueError):
        wan_encode_video(vae, video[:, :frames - 1])


def test_single_frame_vae_is_bitwise_the_code_before(models):
    """Qwen-Image's path: ``wan_encode`` / ``wan_decode`` of one image
    against a frozen copy of those functions as they were before the clip
    path, bitwise."""
    vae = models[2]
    img = torch.rand(1, 32, 48, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    z = wan_encode(vae, img)
    assert torch.equal(z, old_wan_encode(vae, img))
    assert torch.equal(wan_decode(vae, z), old_wan_decode(vae, z))


def test_tokens_masks_and_rope_by_hand():
    """Patches in (t, h, w) order with (C, 1, 2, 2) features and back, the
    mask's 8 x 8 blocks as channels with frames picked nearest-exact, and
    the (frame, row, column) ids and their (44, 42, 42) tables."""
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(1, 2, 4, 6, 3)
    toks = patchify(x, (1, 2, 2))
    assert toks.shape == (1, 12, 12)
    assert toks[0, 1].tolist() == [x[0, 0, r, c, ch].item() for ch in range(3)
                                   for r in (0, 1) for c in (2, 3)]
    head = toks.reshape(1, 12, 3, 4).transpose(2, 3).reshape(1, 12, 12)   # (ph, pw, C) order
    assert torch.equal(unpatchify(head, x.shape, (1, 2, 2)), x)
    mask = (torch.rand(17, 16, 24, generator=torch.Generator().manual_seed(0)) > 0.5).float()
    mc = mask_control(mask[None], 5)
    assert mc.shape == (1, 5, 2, 3, 64)
    assert [int(np.floor((j + 0.5) * 17 / 5)) for j in range(5)] == [1, 5, 8, 11, 15]
    assert torch.equal(mc[0, 2, 1, 2], mask[8, 8:16, 16:24].reshape(64))
    assert torch.equal(mc, R.mask_control(mask, 5))
    ids = rope_ids(2, 3, 4)
    assert ids[:5].tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 1, 0]]
    assert ids[12].tolist() == [1, 0, 0]
    dit_cfg = config_io.WanVACEConfig()
    assert dit_cfg.axes_dims_rope == (44, 42, 42) and dit_cfg.hidden_dim == 5120
    cos, _ = R.rope_tables((2, 3, 4), 128)
    port = T.rope_tables(ids, dit_cfg.axes_dims_rope, 10000)[0]
    assert np.allclose(port, cos.numpy())


def test_across_heads_attention_forms():
    """The kernels' plain versions against the plain composition: the
    statistic over every head of the token, RoPE on interleaved pairs, and
    keys of their own length for the cross-attention."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 9, 2, 128, generator=g) for _ in range(3))
    wq, wk = (1 + 0.1 * torch.randn(256, generator=g) for _ in range(2))
    cos, sin = (torch.as_tensor(t) for t in T.rope_tables(rope_ids(1, 3, 3), (44, 42, 42), 10000))
    fused = FA.attn_self(q, k, v, wq, wk, cos, sin)
    plain = T.wan_attention(q, k, v, wq, wk, "plain", rope=(cos, sin))
    assert _rel(fused, plain) < 1e-5
    kx, vx = k[:, :5] * 3.0, v[:, :5]
    fused = FA.attn_cross(q, kx, vx, wq, wk)
    assert fused.shape == q.shape
    assert _rel(fused, T.wan_attention(q, kx, vx, wq, wk, "plain")) < 1e-5
    # the statistic spans the heads: scaling one head alone moves the other's q'
    qn = FA.across_heads_prep(q, k, wq, wk)[0]
    q2 = q.clone()
    q2[..., 0, :] *= 4.0
    assert not torch.allclose(FA.across_heads_prep(q2, k, wq, wk)[0][..., 1, :], qn[..., 1, :])


def _checkpoint(folder, models):
    dit, text, vae = models
    for sub, model, c in (("transformer", dit, DIT), ("text_encoder", text, TEXT),
                          ("vae", vae, VAE)):
        os.makedirs(folder / sub, exist_ok=True)
        (folder / sub / "config.json").write_text(json.dumps(c))
        sd = {k: (t if rows is None else t[rows]).detach().clone()
              for k, (t, rows) in key_map(model).items()}
        save_file(sd, str(folder / sub / "diffusion_pytorch_model.safetensors"))
        yield sub, sd


def test_checkpoint_names_and_the_cli(models, tmp_path, monkeypatch):
    """The diffusers names, ``from_pretrained`` loading them back, and
    ``run_inference.main`` picking the Wan pipeline from the transformer's
    ``_class_name`` to edit a 5-frame clip of numbered PNGs."""
    from textflux_torch.cli import run_inference
    from textflux_torch.pipeline import wan_vace

    written = dict(_checkpoint(tmp_path / "ckpt", models))
    for k in ("patch_embedding.weight", "vace_patch_embedding.bias", "scale_shift_table",
              "condition_embedder.time_proj.weight", "condition_embedder.text_embedder.linear_2.bias",
              "blocks.2.attn1.to_k.bias", "blocks.0.attn1.norm_q.weight", "blocks.1.norm2.bias",
              "blocks.0.attn2.to_v.weight", "blocks.0.ffn.net.2.weight",
              "vace_blocks.0.proj_in.weight", "vace_blocks.1.proj_out.bias",
              "vace_blocks.1.scale_shift_table"):
        assert k in written["transformer"], k
    assert "vace_blocks.1.proj_in.weight" not in written["transformer"]
    assert tuple(written["transformer"]["blocks.0.scale_shift_table"].shape) == (1, 6, 256)
    assert "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight" in         written["text_encoder"]
    pipe = WanVACEPipeline.from_pretrained(str(tmp_path / "ckpt"), tokenize=byte_tokenize,
                                           dtype=torch.float32, device="cpu")
    for loaded, model in zip((pipe.dit, pipe.text_encoder, pipe.vae), models):
        want = model.state_dict()
        for name, t in loaded.state_dict().items():
            assert torch.equal(t.float(), want[name].float()), name

    monkeypatch.setattr(wan_vace, "load_umt5_tokenizer", lambda path: byte_tokenize)
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "clip")
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            tmp_path / "clip" / f"{i:03d}.png")
    mask = np.zeros((48, 64, 3), np.uint8)
    mask[8:40, 10:50] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    (tmp_path / "words.txt").write_text("Wan\n")
    run_inference.main(["--model", str(tmp_path / "ckpt"), "--image", str(tmp_path / "clip"),
                        "--mask", str(tmp_path / "mask.png"), "--words",
                        str(tmp_path / "words.txt"), "--steps", "2", "--device", "cpu",
                        "--output-dir", str(tmp_path / "out")])
    frames = sorted(os.listdir(tmp_path / "out" / "result_0001"))
    crops = sorted(os.listdir(tmp_path / "out" / "crop" / "crop_0001"))
    assert frames == crops == [f"{i:04d}.png" for i in range(5)]
    # the canvas: 64 wide, the strip (10 rows) and the frame (48) cut to 32 x 2
    assert Image.open(tmp_path / "out" / "result_0001" / "0000.png").size == (64, 32)


# ---------------------------------------------------------------------------
# the single-frame VAE as it was before the clip path (frozen copy)
# ---------------------------------------------------------------------------

def old_conv(p: nn.Module, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """A convolution in x's dtype: a 3-D one's last temporal tap, 'same'
    zero padding for odd kernels (none for the stride-2 one, padded by
    the caller)."""
    w = p.weight[:, :, -1] if p.weight.dim() == 5 else p.weight
    pad = 0 if stride != 1 else w.shape[-1] // 2
    return F.conv2d(x, w.to(x.dtype), p.bias.to(x.dtype), stride=stride, padding=pad)


def old_norm(p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    xf = F.normalize(x.float(), dim=1) * math.sqrt(x.shape[1])
    return (xf * p.scale.float()[:, None, None]).to(x.dtype)


def old_res(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = old_conv(p.conv1, silu(old_norm(p.norm1, x)))
    h = old_conv(p.conv2, silu(old_norm(p.norm2, h)))
    return (x if p.shortcut is None else old_conv(p.shortcut, x)) + h


def old_attn(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    b, c, hh, ww = x.shape
    qkv = old_conv(p.qkv, old_norm(p.norm, x)).reshape(b, 3 * c, hh * ww).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return x + old_conv(p.proj, o.transpose(1, 2).reshape(b, c, hh, ww))


def old_mid(p: MidBlock, x: torch.Tensor) -> torch.Tensor:
    return old_res(p.res2, old_attn(p.attn, old_res(p.res1, x)))


def old_resample(p: Resample, x: torch.Tensor) -> torch.Tensor:
    if p.mode.startswith("down"):
        return old_conv(p.conv, F.pad(x, (0, 1, 0, 1)), stride=2)
    return old_conv(p.conv, F.interpolate(x, scale_factor=2, mode="nearest"))


def old_stats(vae: WanVAE, like: torch.Tensor):
    cfg = vae.cfg
    mean = torch.tensor(cfg.latents_mean, dtype=torch.float32, device=like.device)
    std = torch.tensor(cfg.latents_std, dtype=torch.float32, device=like.device)
    return mean, std


def old_wan_encode(vae: WanVAE, images: torch.Tensor) -> torch.Tensor:
    """NHWC images in [-1, 1] -> the posterior's mean, normalised per
    channel: (B, H/8, W/8, 16) in the images' dtype."""
    p = vae.encoder
    x = old_conv(p.conv_in, images.permute(0, 3, 1, 2))
    for blk in p.down:
        x = old_resample(blk, x) if isinstance(blk, Resample) else old_res(blk, x)
    x = old_conv(p.conv_out, silu(old_norm(p.norm_out, old_mid(p.mid, x))))
    mu = old_conv(vae.quant_conv, x)[:, :vae.cfg.z_dim].permute(0, 2, 3, 1)
    mean, std = old_stats(vae, mu)
    return ((mu.float() - mean) / std).to(images.dtype)


def old_wan_decode(vae: WanVAE, latents: torch.Tensor) -> torch.Tensor:
    """Normalised NHWC latents -> NHWC images clamped to [-1, 1]."""
    mean, std = old_stats(vae, latents)
    z = (latents.float() * std + mean).to(latents.dtype).permute(0, 3, 1, 2)
    p = vae.decoder
    x = old_mid(p.mid, old_conv(p.conv_in, old_conv(vae.post_quant_conv, z)))
    for blk in p.up:
        for r in blk.resnets:
            x = old_res(r, x)
        if blk.up is not None:
            x = old_resample(blk.up, x)
    x = old_conv(p.conv_out, silu(old_norm(p.norm_out, x)))
    return torch.clamp(x, -1.0, 1.0).permute(0, 2, 3, 1)
