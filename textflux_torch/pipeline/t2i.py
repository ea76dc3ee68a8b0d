"""Text-to-image pipeline (FluxPipeline counterpart).

The port of ``textflux_tpu/pipeline/t2i.py``. The reference ships a
modified `FluxPipeline` beside the fill pipeline; TextFlux itself serves
fill, but the t2i path runs the same transformer on 64-channel inputs (no
conditioning concat, ``FluxConfig(in_channels=64)``, e.g. FLUX.1-dev).
Useful for base-model sanity checks and non-fill FLUX checkpoints.

Noise: drawn from one ``torch.Generator`` seeded by ``seed`` (the initial
latents, then each overshoot step's draw), unless the caller hands the
draws in through ``noise=`` ("latents" (B, T_img, 4*latent_channels) and
"steps", one (B, T, 4*latent_channels) draw per step), as
``FillPipeline.__call__`` takes them.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from textflux_torch.config import PipelineConfig
from textflux_torch.pipeline import image_processor as improc
from textflux_torch.pipeline.fill import FillPipeline, _check_noise


class Text2ImagePipeline:
    """Minimal FLUX t2i: packed-noise tokens -> denoise loop -> VAE decode."""

    def __init__(self, *, flux, vae, clip=None, t5=None, clip_tokenize=None,
                 t5_tokenize=None, pipe_cfg: PipelineConfig = PipelineConfig(guidance_scale=3.5),
                 attn_impl: str = "auto", device="cuda"):
        # reuse the fill pipeline's stages with no cond tokens
        self._fill = FillPipeline(
            flux=flux, vae=vae, clip=clip, t5=t5, clip_tokenize=clip_tokenize,
            t5_tokenize=t5_tokenize, pipe_cfg=pipe_cfg, attn_impl=attn_impl, device=device)

    @torch.inference_mode()
    def __call__(self, *, prompt: Optional[str] = None, prompt_2: Optional[str] = None,
                 height: int = 512, width: int = 512,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None, seed: int = 0,
                 sampler: Optional[str] = None, overshoot_c: Optional[float] = None,
                 seq_pad_multiple: Optional[int] = None, dtype=torch.bfloat16,
                 text_embeds=None, output_type: str = "pil",
                 noise: Optional[Mapping[str, object]] = None):
        f = self._fill
        steps = num_inference_steps or f.pipe_cfg.num_inference_steps
        guidance_scale, sampler, overshoot_c = f._sampling(guidance_scale, sampler, overshoot_c)
        noise = _check_noise(noise)
        width, height = improc.snap_to_multiple(width, height, improc.PIXEL_MULTIPLE)
        dev = f.device

        if text_embeds is None:
            prompt_2 = prompt_2 or prompt
            pooled, txt = f.encode_prompts(prompt, prompt_2, dtype)
        else:
            pooled, txt = (torch.as_tensor(np.asarray(t), device=dev).to(dtype)
                           for t in text_embeds)

        b = pooled.shape[0]
        lat_h, lat_w = height // f.vae_cfg.spatial_factor, width // f.vae_cfg.spatial_factor
        t_img = (lat_h // 2) * (lat_w // 2)
        channels = f.vae_cfg.latent_channels * 4

        generator = torch.Generator(device=dev).manual_seed(seed)
        latents = noise.get("latents")
        if latents is None:
            latents = torch.randn((b, t_img, channels), generator=generator, device=dev,
                                  dtype=torch.float32)
        latents = torch.as_tensor(latents, device=dev).to(dtype)
        cond = torch.zeros((b, t_img, 0), dtype=dtype, device=dev)   # no conditioning

        # the denoise tail is the FILL pipeline's, not a re-implementation:
        # in the JAX package an earlier local copy drifted from it
        latents = f._run_denoise(
            latents, cond, txt, pooled,
            t_img=t_img, lat_h=lat_h, lat_w=lat_w, steps=steps,
            guidance_scale=guidance_scale, sampler=sampler, overshoot_c=overshoot_c,
            seq_pad_multiple=seq_pad_multiple, step_noise=noise.get("steps"),
            generator=generator)
        if output_type == "latent":
            return latents
        images_np = f._decode(latents, lat_h, lat_w).float().cpu().numpy()
        return images_np if output_type == "np" else improc.postprocess_image(images_np)
