"""Read diffusers/transformers config.json files into the port's config
dataclasses (the port of ``textflux_tpu/io/config_io.py``: the same keys and
defaults; a directory without config.json gives the default config)."""

from __future__ import annotations

import json
import os
from typing import Optional

from textflux_torch.config import (CLIPTextConfig, FluxConfig, QwenImageConfig, QwenTextConfig,
                                   T5Config, VAEConfig, WanVACEConfig, WanVAEConfig)


def _load(path: str) -> Optional[dict]:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return json.load(f)


def flux_config_from(path: str) -> FluxConfig:
    c = _load(path)
    if c is None:
        return FluxConfig()
    return FluxConfig(
        in_channels=c.get("in_channels", 384),
        out_channels=c.get("out_channels") or c.get("in_channels", 64),
        num_double_layers=c.get("num_layers", 19),
        num_single_layers=c.get("num_single_layers", 38),
        num_heads=c.get("num_attention_heads", 24),
        head_dim=c.get("attention_head_dim", 128),
        joint_dim=c.get("joint_attention_dim", 4096),
        pooled_dim=c.get("pooled_projection_dim", 768),
        guidance_embeds=c.get("guidance_embeds", True),
        axes_dims_rope=tuple(c.get("axes_dims_rope", (16, 56, 56))),
    )


def vae_config_from(path: str) -> VAEConfig:
    c = _load(path)
    if c is None:
        return VAEConfig()
    return VAEConfig(
        in_channels=c.get("in_channels", 3),
        out_channels=c.get("out_channels", 3),
        block_out_channels=tuple(c.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=c.get("layers_per_block", 2),
        latent_channels=c.get("latent_channels", 16),
        norm_num_groups=c.get("norm_num_groups", 32),
        scaling_factor=c.get("scaling_factor", 0.3611),
        shift_factor=c.get("shift_factor", 0.1159) or 0.0,
    )


def clip_config_from(path: str) -> CLIPTextConfig:
    c = _load(path)
    if c is None:
        return CLIPTextConfig()
    return CLIPTextConfig(
        vocab_size=c.get("vocab_size", 49408),
        hidden_dim=c.get("hidden_size", 768),
        num_layers=c.get("num_hidden_layers", 12),
        num_heads=c.get("num_attention_heads", 12),
        mlp_dim=c.get("intermediate_size", 3072),
        max_positions=c.get("max_position_embeddings", 77),
        layer_norm_eps=c.get("layer_norm_eps", 1e-5),
        eos_token_id=c.get("eos_token_id", 49407),
    )


def t5_config_from(path: str) -> T5Config:
    c = _load(path)
    if c is None:
        return T5Config()
    return T5Config(
        vocab_size=c.get("vocab_size", 32128),
        d_model=c.get("d_model", 4096),
        d_kv=c.get("d_kv", 64),
        d_ff=c.get("d_ff", 10240),
        num_layers=c.get("num_layers", 24),
        num_heads=c.get("num_heads", 64),
        relative_attention_num_buckets=c.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=c.get("relative_attention_max_distance", 128),
        # UMT5 gives every layer its own relative-position bias
        shared_pos=c.get("model_type") != "umt5",
    )


def transformer_class(path: str) -> str:
    """The ``_class_name`` of a transformer directory's config.json
    (FLUX's when it has none): which pipeline a checkpoint is for."""
    c = _load(path)
    return (c or {}).get("_class_name", "FluxTransformer2DModel")


def qwen_image_config_from(path: str) -> QwenImageConfig:
    """diffusers ``QwenImageTransformer2DModel`` config.json: the packed
    channels are ``out_channels`` x ``patch_size``^2."""
    c = _load(path)
    if c is None:
        return QwenImageConfig()
    if c.get("guidance_embeds"):
        raise ValueError("a Qwen-Image transformer with guidance embeddings is not supported")
    patch = c.get("patch_size", 2)
    return QwenImageConfig(
        in_channels=c.get("in_channels", 64),
        out_channels=c.get("out_channels", 16) * patch * patch,
        num_double_layers=c.get("num_layers", 60),
        num_heads=c.get("num_attention_heads", 24),
        head_dim=c.get("attention_head_dim", 128),
        joint_dim=c.get("joint_attention_dim", 3584),
        axes_dims_rope=tuple(c.get("axes_dims_rope", (16, 56, 56))),
    )


def qwen_text_config_from(path: str) -> QwenTextConfig:
    """transformers ``Qwen2_5_VLForConditionalGeneration`` config.json: its
    language model's keys (under ``text_config`` where the file nests them)."""
    c = _load(path)
    if c is None:
        return QwenTextConfig()
    c = dict(c, **c.get("text_config", {}))
    return QwenTextConfig(
        vocab_size=c.get("vocab_size", 152064),
        hidden_dim=c.get("hidden_size", 3584),
        num_layers=c.get("num_hidden_layers", 28),
        num_heads=c.get("num_attention_heads", 28),
        num_kv_heads=c.get("num_key_value_heads", 4),
        mlp_dim=c.get("intermediate_size", 18944),
        rms_norm_eps=c.get("rms_norm_eps", 1e-6),
        rope_theta=c.get("rope_theta", 1000000.0),
    )


def wan_vae_config_from(path: str) -> WanVAEConfig:
    """diffusers ``AutoencoderKLQwenImage`` config.json (the Wan-2.1 VAE)."""
    c = _load(path)
    if c is None:
        return WanVAEConfig()
    if c.get("attn_scales"):
        raise ValueError("attention inside the VAE's levels (attn_scales) is not supported")
    defaults = WanVAEConfig()
    return WanVAEConfig(
        base_dim=c.get("base_dim", 96),
        z_dim=c.get("z_dim", 16),
        dim_mult=tuple(c.get("dim_mult", (1, 2, 4, 4))),
        num_res_blocks=c.get("num_res_blocks", 2),
        latents_mean=tuple(c.get("latents_mean", defaults.latents_mean)),
        latents_std=tuple(c.get("latents_std", defaults.latents_std)),
    )


def wan_vace_config_from(path: str) -> WanVACEConfig:
    """diffusers ``WanVACETransformer3DModel`` config.json."""
    c = _load(path)
    if c is None:
        return WanVACEConfig()
    if c.get("qk_norm", "rms_norm_across_heads") != "rms_norm_across_heads":
        raise ValueError(f"q/k norm {c['qk_norm']!r} is not supported: Wan's is "
                         "'rms_norm_across_heads'")
    if c.get("image_dim") or c.get("added_kv_proj_dim") or not c.get("cross_attn_norm", True):
        raise ValueError("an image-conditioned Wan transformer, or one without the cross-"
                         "attention norm, is not supported")
    return WanVACEConfig(
        in_channels=c.get("in_channels", 16),
        out_channels=c.get("out_channels", 16),
        vace_in_channels=c.get("vace_in_channels", 96),
        num_layers=c.get("num_layers", 40),
        vace_layers=tuple(c.get("vace_layers", (0, 5, 10, 15, 20, 25, 30, 35))),
        num_heads=c.get("num_attention_heads", 40),
        head_dim=c.get("attention_head_dim", 128),
        ffn_dim=c.get("ffn_dim", 13824),
        text_dim=c.get("text_dim", 4096),
        patch_size=tuple(c.get("patch_size", (1, 2, 2))),
        freq_dim=c.get("freq_dim", 256),
        eps=c.get("eps", 1e-6),
    )
