"""Model / pipeline configuration dataclasses.

The port's own copy of ``textflux_tpu/config.py``: the same fields, defaults
and canonical constructors. Shapes mirror the FLUX.1-Fill-dev checkpoint and
the stock FLUX VAE / CLIP-L / T5-XXL configs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """MM-DiT (double-stream + single-stream) transformer config."""

    in_channels: int = 384          # 64 packed latents + 320 packed cond (fill model)
    out_channels: int = 64
    num_double_layers: int = 19
    num_single_layers: int = 38
    num_heads: int = 24
    head_dim: int = 128
    joint_dim: int = 4096           # T5 sequence feature dim
    pooled_dim: int = 768           # CLIP pooled feature dim
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: int = 10000
    mlp_ratio: float = 4.0
    time_embed_channels: int = 256

    @property
    def hidden_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """KL autoencoder (FLUX VAE: 16 latent channels, 8x spatial, no quant convs)."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 16
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP-L/14 text encoder (pooled embedding provider)."""

    vocab_size: int = 49408
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    # CLIP uses the "quick gelu" activation x * sigmoid(1.702 x)
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5 v1.1 encoder (XXL for FLUX: gated-gelu, relative attention bias)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end fill pipeline configuration (the reference's defaults)."""

    num_inference_steps: int = 30
    guidance_scale: float = 30.0
    max_sequence_length: int = 512  # T5 tokens
    clip_sequence_length: int = 77
    # dynamic-shift Euler schedule knobs (scheduler_config of FLUX.1-Fill-dev)
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15
    # AMO overshoot sampler knobs
    overshoot_c: float = 2.0
    sampler: str = "euler"          # "euler" | "overshoot" | "overshoot_spatial"


# ---------------------------------------------------------------------------
# Canonical configs
# ---------------------------------------------------------------------------

def flux_fill_config() -> FluxConfig:
    """The full-size FLUX.1-Fill config used by every TextFlux variant."""
    return FluxConfig()


def flux_vae_config() -> VAEConfig:
    """The FLUX VAE (16 latent channels, 8x spatial)."""
    return VAEConfig()


def clip_l_config() -> CLIPTextConfig:
    """CLIP-L/14 text encoder."""
    return CLIPTextConfig()


def t5_xxl_config() -> T5Config:
    """T5 v1.1 XXL encoder."""
    return T5Config()
