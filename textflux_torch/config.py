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
    # one relative-position bias for every layer (T5 v1.1), or one per layer
    # (UMT5, Wan's ``shared_pos=False``)
    shared_pos: bool = True


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    """Qwen-Image's MM-DiT (``QwenImageTransformer2DModel``): FLUX's
    double-stream block 60 times and no single-stream block, an RMSNorm on
    the text before its projection, and the timestep alone as the
    modulation's condition (no guidance embedding, no pooled vector).
    ``in_channels`` and ``out_channels`` are the packed 2x2 patches of the
    16 latent channels (the config's ``patch_size`` x ``out_channels``)."""

    in_channels: int = 64
    out_channels: int = 64
    num_double_layers: int = 60
    num_heads: int = 24
    head_dim: int = 128
    joint_dim: int = 3584           # the Qwen2.5-VL text width
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
class QwenTextConfig:
    """The language model of Qwen2.5-VL-7B-Instruct used as a text encoder:
    pre-RMSNorm decoder layers with causal grouped-query attention (q/k/v
    bias, no o bias), rotate-half RoPE and a SwiGLU MLP."""

    vocab_size: int = 152064
    hidden_dim: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    mlp_dim: int = 18944
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


# Qwen-Image's published per-channel latent statistics (vae/config.json)
WAN_LATENTS_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
                    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN_LATENTS_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
                   3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """The Wan-2.1 VAE (``AutoencoderKLQwenImage``) on single images: 8x
    spatial, 16 latent channels normalised per channel."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    latents_mean: Tuple[float, ...] = WAN_LATENTS_MEAN
    latents_std: Tuple[float, ...] = WAN_LATENTS_STD

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)


@dataclasses.dataclass(frozen=True)
class QwenPipelineConfig:
    """Qwen-Image's scheduler (scheduler/scheduler_config.json: exponential
    dynamic shift between (256, 0.5) and (8192, 0.9), stretched to a last
    sigma of 0.02) and its pipeline defaults: true classifier-free guidance
    at 4.0 against the negative prompt " "."""

    num_inference_steps: int = 30
    true_cfg_scale: float = 4.0
    negative_prompt: str = " "
    base_image_seq_len: int = 256
    max_image_seq_len: int = 8192
    base_shift: float = 0.5
    max_shift: float = 0.9
    shift_terminal: float = 0.02


@dataclasses.dataclass(frozen=True)
class WanVACEConfig:
    """Wan2.1-VACE's DiT (diffusers' ``WanVACETransformer3DModel``): 3-D
    patches (1, 2, 2) of the 16 latent channels, blocks of self-attention
    (q/k RMSNorm across heads, 3-axis interleaved RoPE), cross-attention to
    the text and a GELU-tanh FFN under AdaLN modulation from the timestep
    alone; the VACE branch of blocks of the same kind over the control
    (``vace_in_channels``: inactive and reactive latents and the 64 mask
    channels), whose hints join the main stream after ``vace_layers``."""

    in_channels: int = 16
    out_channels: int = 16
    vace_in_channels: int = 96
    num_layers: int = 40
    vace_layers: Tuple[int, ...] = (0, 5, 10, 15, 20, 25, 30, 35)
    num_heads: int = 40
    head_dim: int = 128
    ffn_dim: int = 13824
    text_dim: int = 4096
    text_len: int = 512
    patch_size: Tuple[int, ...] = (1, 2, 2)
    freq_dim: int = 256
    eps: float = 1e-6
    rope_theta: int = 10000

    @property
    def hidden_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def axes_dims_rope(self) -> Tuple[int, ...]:
        """The head's rotary split over (frame, row, column): Wan's
        (D - 4 (D // 6), 2 (D // 6), 2 (D // 6)), (44, 42, 42) at 128."""
        d = self.head_dim
        return (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))

    @property
    def patch_dim(self) -> int:
        return self.patch_size[0] * self.patch_size[1] * self.patch_size[2]


@dataclasses.dataclass(frozen=True)
class WanPipelineConfig:
    """Wan2.1-VACE serving defaults: flow-matching Euler over the static
    shift sigma' = shift sigma / (1 + (shift - 1) sigma), true CFG against
    the negative prompt, the text padded to ``text_len``."""

    num_inference_steps: int = 30
    guidance_scale: float = 5.0
    flow_shift: float = 5.0
    # a fixed English stand-in for Wan's default negative prompt
    negative_prompt: str = ("bright colors, overexposed, static, blurred details, subtitles, "
                            "worst quality, low quality, ugly, deformed, still picture")


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
