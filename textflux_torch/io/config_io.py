"""Read diffusers/transformers config.json files into the port's config
dataclasses (the port of ``textflux_tpu/io/config_io.py``: the same keys and
defaults; a directory without config.json gives the default config)."""

from __future__ import annotations

import json
import os
from typing import Optional

from textflux_torch.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig


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
    )
