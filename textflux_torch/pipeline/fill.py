"""End-to-end FLUX-Fill inpainting pipeline.

The port of ``textflux_tpu/pipeline/fill.py::FillPipeline`` (single-image
``__call__``; batched generation, serving sharding and checkpoint loading are
not ported yet). Stages:

  1. text encode   — CLIP pooled + T5 sequence embeddings
  2. conditioning  — VAE-encode the masked image, pack latents + the 8x8 -> 2x2
                     mask rearrangement into the cond tokens
  3. denoise       — a loop over the sigma schedule; the MM-DiT consumes
                     [noise tokens | cond tokens] each step
  4. decode        — unpack + VAE decode

Noise: the JAX package draws with ``jax.random``, whose streams PyTorch
cannot reproduce. Here every draw comes from one ``torch.Generator`` seeded
by ``seed``, unless the caller hands the draws in through ``noise=``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from textflux_torch.config import PipelineConfig
from textflux_torch.device import resolve_device
from textflux_torch.models import transformer
from textflux_torch.models.clip import CLIPTextModel, clip_encode
from textflux_torch.models.t5 import T5Encoder, t5_encode
from textflux_torch.models.transformer import FluxTransformer, flux_apply
from textflux_torch.models.vae import FluxVAE, vae_decode, vae_encode
from textflux_torch.ops import packing, samplers
from textflux_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
from textflux_torch.ops.rope import rope_tables, rope_tables_half
from textflux_torch.pipeline import image_processor as improc
from textflux_torch.pipeline.prompts import build_prompts

SAMPLERS = ("euler", "overshoot", "overshoot_spatial")


class FillPipeline:
    """Scene-text inpainting: glyph-conditioned FLUX fill."""

    def __init__(
        self,
        *,
        flux: FluxTransformer,
        vae: FluxVAE,
        clip: Optional[CLIPTextModel] = None,
        t5: Optional[T5Encoder] = None,
        clip_tokenize: Optional[Callable[[str], np.ndarray]] = None,
        t5_tokenize: Optional[Callable[[str], np.ndarray]] = None,
        pipe_cfg: PipelineConfig = PipelineConfig(),
        attn_impl: str = "auto",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.flux, self.vae, self.clip, self.t5 = (
            None if m is None else m.to(self.device) for m in (flux, vae, clip, t5))
        self.flux_cfg, self.vae_cfg = flux.cfg, vae.cfg
        self.clip_tokenize = clip_tokenize
        self.t5_tokenize = t5_tokenize
        self.pipe_cfg = pipe_cfg
        if attn_impl == "auto":
            # the Hopper kernel takes head_dim in SUPPORTED_HEAD_DIMS; the CPU
            # runs the plain path unless asked for the fused one
            fused_ok = self.flux_cfg.head_dim in SUPPORTED_HEAD_DIMS
            attn_impl = "fused" if self.device.type == "cuda" and fused_ok else "plain"
        if attn_impl not in transformer.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be 'auto' or one of {transformer.ATTN_IMPLS}")
        self.attn_impl = attn_impl
        if attn_impl == "fused" and self.flux.rope_layout == "interleaved":
            # fold the rotate-half permutation into the q/k weights once
            # (in place, see half_permute_flux_params)
            transformer.half_permute_flux_params(self.flux)
        self.last_joint_seq = None   # joint sequence length of the last denoise

    def _rope_tables(self, ids):
        fn = rope_tables_half if self.attn_impl == "fused" else rope_tables
        return fn(ids, self.flux_cfg.axes_dims_rope, self.flux_cfg.rope_theta)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def _prepare_cond(self, image, mask, *, vae_noise, generator):
        """Mask out the edit region, VAE-encode, pack; the mask folds
        s x s -> s*s*4 channels."""
        masked = image * (1.0 - mask[..., None])
        z = vae_encode(self.vae, masked, noise=vae_noise, generator=generator)
        img_tokens = packing.pack_latents(z)
        mask_tokens = packing.pack_mask(mask.to(z.dtype), self.vae_cfg.spatial_factor)
        return torch.cat([img_tokens, mask_tokens], dim=-1)

    def _denoise_step(self, lat, cond, txt, pooled, guidance, cos, sin, mods, sigma,
                      sigma_next, *, sampler, overshoot_c, kv_len, noise, generator):
        """One step: the DiT's velocity, then the sampler update."""
        b = lat.shape[0]
        v = flux_apply(self.flux, torch.cat([lat, cond], dim=-1), txt, pooled,
                       torch.full((b,), float(sigma), dtype=lat.dtype, device=lat.device),
                       guidance, cos, sin, attn_impl=self.attn_impl, kv_len=kv_len,
                       mods=mods)
        if sampler == "overshoot":
            return samplers.overshoot_step(lat, v, sigma, sigma_next, noise,
                                           generator=generator, c=overshoot_c)
        if sampler == "overshoot_spatial":
            # per-token overshoot weighted by mask occupancy (the packed mask
            # is the tail of the cond features)
            c_map = overshoot_c * torch.mean(
                cond[..., self.vae_cfg.latent_channels * 4:].float(), dim=-1)
            return samplers.overshoot_step_spatial(lat, v, sigma, sigma_next, c_map, noise,
                                                   generator=generator)
        return samplers.euler_step(lat, v, sigma, sigma_next)

    def _run_denoise(self, latents, cond, txt, pooled, *, t_img: int, lat_h: int,
                     lat_w: int, steps: int, guidance_scale: float, sampler: str,
                     overshoot_c: float, seq_pad_multiple, step_noise, generator):
        """Sequence-bucket padding (masked kv), RoPE tables, the dynamic-shift
        schedule, the denoise loop and unpadding."""
        cfgp = self.pipe_cfg
        dev = latents.device
        t_txt = txt.shape[1]
        ids = np.concatenate([packing.text_ids(t_txt),
                              packing.latent_image_ids(lat_h, lat_w)], axis=0)

        # optional sequence bucketing: pad image tokens to a multiple, with
        # the padded keys masked
        kv_len = None
        t_pad = t_img
        if seq_pad_multiple:
            t_pad = -(-t_img // seq_pad_multiple) * seq_pad_multiple
            if t_pad != t_img:
                pad = t_pad - t_img
                latents = torch.nn.functional.pad(latents, (0, 0, 0, pad))
                cond = torch.nn.functional.pad(cond, (0, 0, 0, pad))
                ids = np.concatenate([ids, np.tile(ids[-1:], (pad, 1))], axis=0)
                kv_len = t_txt + t_img
        self.last_joint_seq = len(ids)

        cos, sin = (torch.as_tensor(t, device=dev) for t in self._rope_tables(ids))
        sigmas = samplers.make_schedule(
            steps, t_img,
            base_seq_len=cfgp.base_image_seq_len, max_seq_len=cfgp.max_image_seq_len,
            base_shift=cfgp.base_shift, max_shift=cfgp.max_shift,
        )
        b = latents.shape[0]
        guidance = (torch.full((b,), guidance_scale, dtype=torch.float32, device=dev)
                    if self.flux_cfg.guidance_embeds else None)

        # every step's AdaLN modulation vectors in one batched matmul over
        # (steps*B) rows: the modulation weights are read once per image
        sig = torch.as_tensor(sigmas[:-1], device=dev).to(latents.dtype)
        vec_all = transformer.flux_vec(
            self.flux, sig.repeat_interleave(b),
            None if guidance is None else guidance.repeat(steps),
            pooled.repeat(steps, 1), latents.dtype)
        mods_all = transformer.flux_mods(self.flux, vec_all)

        def step_mods(i):
            rows = slice(i * b, (i + 1) * b)
            return {"double": [(im[rows], tm[rows]) for im, tm in mods_all["double"]],
                    "single": [m[rows] for m in mods_all["single"]],
                    "final": mods_all["final"][rows]}

        for i in range(steps):
            noise = None
            if step_noise is not None:
                noise = torch.as_tensor(step_noise[i], device=dev)
            latents = self._denoise_step(
                latents, cond, txt, pooled, guidance, cos, sin, step_mods(i),
                sigmas[i], sigmas[i + 1], sampler=sampler, overshoot_c=overshoot_c,
                kv_len=kv_len, noise=noise, generator=generator)
        return latents[:, :t_img] if t_pad != t_img else latents

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompts(self, prompt: str, prompt_2: str, dtype=torch.bfloat16):
        if self.clip is None or self.t5 is None:
            raise ValueError("pipeline was built without text encoders")
        if self.clip_tokenize is None or self.t5_tokenize is None:
            raise ValueError("pipeline was built without tokenizers")
        clip_ids = torch.as_tensor(np.asarray(self.clip_tokenize(prompt)), device=self.device)
        t5_ids = torch.as_tensor(np.asarray(self.t5_tokenize(prompt_2)), device=self.device)
        _, pooled = clip_encode(self.clip, clip_ids, dtype=dtype)
        txt = t5_encode(self.t5, t5_ids, dtype=dtype)
        return pooled, txt

    @torch.inference_mode()
    def __call__(
        self,
        *,
        image,
        mask_image,
        words: Optional[Sequence[str]] = None,
        prompt: Optional[str] = None,
        prompt_2: Optional[str] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        seed: int = 42,
        sampler: Optional[str] = None,
        overshoot_c: Optional[float] = None,
        dtype=torch.bfloat16,
        text_embeds=None,
        output_type: str = "pil",
        seq_pad_multiple: Optional[int] = None,
        noise: Optional[Mapping[str, object]] = None,
    ):
        """Run glyph-conditioned inpainting.

        Args:
          image / mask_image: PIL or numpy; the pre-concatenated conditioning
            canvas (glyph strip/canvas already stitched on) and its mask.
          words: render words; builds the two prompt templates automatically.
          prompt / prompt_2: override the CLIP / T5 prompts directly.
          text_embeds: optional precomputed (pooled, txt) tuple, bypassing the
            text encoders.
          output_type: "pil" | "np" | "latent".
          noise: optional draws to use instead of the seeded generator, for
            holding this port against another implementation's random
            streams: "latents" (B, T_img, 4*latent_channels), "vae" (the VAE
            posterior eps, (B, h, w, latent_channels)) and "steps" (one
            (B, T, 4*latent_channels) draw per overshoot step). Missing keys
            are drawn from the generator.
        """
        cfgp = self.pipe_cfg
        steps = num_inference_steps or cfgp.num_inference_steps
        guidance_scale = cfgp.guidance_scale if guidance_scale is None else guidance_scale
        sampler = sampler or cfgp.sampler
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        overshoot_c = cfgp.overshoot_c if overshoot_c is None else overshoot_c
        noise = dict(noise or {})
        unknown = set(noise) - {"latents", "vae", "steps"}
        if unknown:
            raise ValueError(f"unknown noise keys {sorted(unknown)}")
        dev = self.device

        pil = improc.to_pil(image)
        w0, h0 = pil.size
        # latent grid must be even for 2x2 packing => 16-pixel granularity
        width = ((width or w0) // 16) * 16
        height = ((height or h0) // 16) * 16

        img = torch.as_tensor(improc.preprocess_image(image, height, width), device=dev).to(dtype)
        mask = torch.as_tensor(improc.preprocess_mask(mask_image, height, width),
                               device=dev).to(dtype)

        if text_embeds is None:
            if prompt is None or prompt_2 is None:
                if words is None:
                    if prompt is not None or prompt_2 is not None:
                        # one prompt given, no words to derive the other from
                        raise ValueError(
                            "provide both prompt and prompt_2, or words to "
                            "derive the missing one from")
                    raise ValueError("provide words, prompts, or text_embeds")
                # derive only the MISSING prompt(s): an explicit override
                # must never be silently replaced by the words template
                auto_p, auto_p2 = build_prompts(words)
                prompt = prompt if prompt is not None else auto_p
                prompt_2 = prompt_2 if prompt_2 is not None else auto_p2
            pooled, txt = self.encode_prompts(prompt, prompt_2, dtype)
        else:
            pooled, txt = (torch.as_tensor(t, device=dev).to(dtype) for t in text_embeds)

        b = img.shape[0]
        lat_h = height // self.vae_cfg.spatial_factor
        lat_w = width // self.vae_cfg.spatial_factor
        t_img = (lat_h // 2) * (lat_w // 2)

        generator = torch.Generator(device=dev).manual_seed(seed)

        def given(key):
            x = noise.get(key)
            return None if x is None else torch.as_tensor(x, device=dev)

        cond = self._prepare_cond(img, mask, vae_noise=given("vae"), generator=generator)
        latents = given("latents")
        if latents is None:
            latents = torch.randn((b, t_img, self.vae_cfg.latent_channels * 4),
                                  generator=generator, device=dev, dtype=torch.float32)
        latents = latents.to(dtype)

        latents = self._run_denoise(
            latents, cond, txt, pooled,
            t_img=t_img, lat_h=lat_h, lat_w=lat_w, steps=steps,
            guidance_scale=guidance_scale, sampler=sampler,
            overshoot_c=overshoot_c, seq_pad_multiple=seq_pad_multiple,
            step_noise=noise.get("steps"), generator=generator)

        if output_type == "latent":
            return latents
        z = packing.unpack_latents(latents, lat_h, lat_w)
        images = vae_decode(self.vae, z)
        images_np = images.float().cpu().numpy()
        if output_type == "np":
            return images_np
        return improc.postprocess_image(images_np)
