"""End-to-end FLUX-Fill inpainting pipeline.

The port of ``textflux_tpu/pipeline/fill.py::FillPipeline``: single-image
``__call__``, batched ``generate_batch``, ``from_pretrained`` from a
diffusers-layout checkpoint (with a LoRA folded in at load, and quantised
serving: ``quantize`` / ``quantize_t5``, the DiT and T5 quantised as they
stream in), the staged residency of ``defer_transformer``, and multi-GPU
serving over a ``parallel.partitioning`` mesh (``shard_for_serving``,
``from_pretrained(mesh=)``): the DiT tensor-parallel over the tensor axis,
batches data-parallel over (data, fsdp), VAE, CLIP and T5 whole on every
rank. Stages:

  1. text encode   — CLIP pooled + T5 sequence embeddings
  2. conditioning  — VAE-encode the masked image (tiled above a 160x160 latent
                     area), pack latents + the 8x8 -> 2x2 mask rearrangement
                     into the cond tokens
  3. denoise       — a loop over the sigma schedule; the MM-DiT consumes
                     [noise tokens | cond tokens] each step
  4. decode        — unpack + VAE decode (tiled above the same area)

Noise: the JAX package draws with ``jax.random``, whose streams PyTorch
cannot reproduce. Here every draw of a sample comes from one
``torch.Generator`` seeded by its seed, unless the caller hands the draws in
through ``noise=``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from textflux_torch.config import FluxConfig, PipelineConfig
from textflux_torch.device import resolve_device
from textflux_torch.models import transformer
from textflux_torch.models.clip import CLIPTextModel, clip_encode
from textflux_torch.models.t5 import T5Encoder, t5_encode
from textflux_torch.models.transformer import FluxTransformer, flux_apply
from textflux_torch.models.vae import (FluxVAE, vae_decode, vae_decode_tiled, vae_encode,
                                       vae_encode_tiled)
from textflux_torch.ops import packing, samplers
from textflux_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
from textflux_torch.ops.rope import rope_tables, rope_tables_half
from textflux_torch.pipeline import image_processor as improc
from textflux_torch.pipeline.prompts import GENERIC_TEMPLATE, build_prompts, words_prompt

SAMPLERS = ("euler", "overshoot", "overshoot_spatial")
NOISE_KEYS = ("latents", "vae", "steps")
# beyond this latent area the VAE mid-block attention (quadratic) and the
# decoder activations dominate memory: encode and decode in tiles
VAE_TILE_THRESHOLD = 160 * 160
VAE_TILE = 128


def _check_noise(noise) -> dict:
    noise = dict(noise or {})
    unknown = set(noise) - set(NOISE_KEYS)
    if unknown:
        raise ValueError(f"unknown noise keys {sorted(unknown)}")
    return noise


class FillPipeline:
    """Scene-text inpainting: glyph-conditioned FLUX fill."""

    def __init__(
        self,
        *,
        flux: Optional[FluxTransformer],
        vae: FluxVAE,
        clip: Optional[CLIPTextModel] = None,
        t5: Optional[T5Encoder] = None,
        clip_tokenize: Optional[Callable[[str], np.ndarray]] = None,
        t5_tokenize: Optional[Callable[[str], np.ndarray]] = None,
        pipe_cfg: PipelineConfig = PipelineConfig(),
        attn_impl: str = "auto",
        device="cuda",
        flux_cfg: Optional[FluxConfig] = None,
        mesh=None,
    ):
        """`flux` may be None when `flux_cfg` is given: a DiT deferred to
        ``load_transformer`` (staged residency). `mesh`: the
        ``parallel.partitioning.Mesh`` this rank serves on (`flux` then holds
        the rank's shard when the mesh has a tensor axis; ``device`` is the
        mesh's), or None."""
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.flux, self.vae, self.clip, self.t5 = (
            None if m is None else m.to(self.device) for m in (flux, vae, clip, t5))
        if flux is None and flux_cfg is None:
            raise ValueError("pass flux, or flux_cfg for a DiT loaded later")
        self.flux_cfg, self.vae_cfg = (flux.cfg if flux is not None else flux_cfg), vae.cfg
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
        self.load_stats = {}         # from_pretrained: seconds and bytes by component
        if attn_impl == "fused" and self.flux is not None and self.flux.rope_layout == "interleaved":
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
        s x s -> s*s*4 channels. Above VAE_TILE_THRESHOLD the encode is
        tiled, and `vae_noise` (when given) holds one draw per tile."""
        masked = image * (1.0 - mask[..., None])
        f = self.vae_cfg.spatial_factor
        if (image.shape[1] // f) * (image.shape[2] // f) > VAE_TILE_THRESHOLD:
            z = vae_encode_tiled(self.vae, masked, noise=vae_noise, generator=generator,
                                 tile=VAE_TILE)
        else:
            z = vae_encode(self.vae, masked, noise=vae_noise, generator=generator)
        img_tokens = packing.pack_latents(z)
        mask_tokens = packing.pack_mask(mask.to(z.dtype), self.vae_cfg.spatial_factor)
        return torch.cat([img_tokens, mask_tokens], dim=-1)

    def _decode(self, latents, lat_h: int, lat_w: int):
        z = packing.unpack_latents(latents, lat_h, lat_w)
        if lat_h * lat_w > VAE_TILE_THRESHOLD:
            return vae_decode_tiled(self.vae, z, tile=VAE_TILE)
        return vae_decode(self.vae, z)

    def _denoise_step(self, lat, cond, txt, pooled, guidance, cos, sin, mods, sigma,
                      sigma_next, *, sampler, overshoot_c, kv_len, noise, generator):
        """One step: the DiT's velocity, then the sampler update. `generator`
        is one generator, or one per sample (each draws that sample's rows
        of the step noise, as a single-sample call would)."""
        b = lat.shape[0]
        if sampler != "euler" and noise is None and isinstance(generator, (list, tuple)):
            noise = torch.cat([torch.randn((1,) + tuple(lat.shape[1:]), generator=g,
                                           device=lat.device, dtype=torch.float32)
                               for g in generator])
        v = flux_apply(self.flux, torch.cat([lat, cond], dim=-1), txt, pooled,
                       torch.full((b,), float(sigma), dtype=lat.dtype, device=lat.device),
                       guidance, cos, sin, attn_impl=self.attn_impl, kv_len=kv_len,
                       mods=mods, mesh=self.mesh)
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
        """Shared tail of __call__ and generate_batch: sequence-bucket padding
        (masked kv), RoPE tables, the dynamic-shift schedule, the denoise
        loop and unpadding."""
        if self.flux is None:
            raise ValueError("the DiT is not loaded: call load_transformer() first")
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
        mods_all = transformer.flux_mods(self.flux, vec_all, mesh=self.mesh)

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

    def _initial_draws(self, img, mask, noise, generator, t_img: int, dtype):
        """Cond tokens and initial latents, in __call__'s draw order: the VAE
        posterior, then the latents (each from `noise` when given)."""
        dev = self.device

        def given(key):
            x = noise.get(key)
            if isinstance(x, (list, tuple)):   # per-tile VAE draws
                return [torch.as_tensor(t, device=dev) for t in x]
            return None if x is None else torch.as_tensor(x, device=dev)

        cond = self._prepare_cond(img, mask, vae_noise=given("vae"), generator=generator)
        latents = given("latents")
        if latents is None:
            latents = torch.randn((img.shape[0], t_img, self.vae_cfg.latent_channels * 4),
                                  generator=generator, device=dev, dtype=torch.float32)
        return cond, latents.to(dtype)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompts(self, prompt: str, prompt_2: str, dtype=torch.bfloat16):
        if self.clip is None or self.t5 is None:
            raise ValueError("pipeline was built without text encoders")
        if self.clip_tokenize is None or self.t5_tokenize is None:
            raise ValueError("pipeline was built without tokenizers")
        return self._encode_ids(self.clip_tokenize(prompt), self.t5_tokenize(prompt_2), dtype)

    def _encode_ids(self, clip_ids, t5_ids, dtype):
        clip_ids = torch.as_tensor(np.asarray(clip_ids), device=self.device)
        t5_ids = torch.as_tensor(np.asarray(t5_ids), device=self.device)
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
            posterior eps, (B, h, w, latent_channels), or a list of per-tile
            draws when the encode is tiled) and "steps" (one
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
        noise = _check_noise(noise)
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
        cond, latents = self._initial_draws(img, mask, noise, generator, t_img, dtype)

        latents = self._run_denoise(
            latents, cond, txt, pooled,
            t_img=t_img, lat_h=lat_h, lat_w=lat_w, steps=steps,
            guidance_scale=guidance_scale, sampler=sampler,
            overshoot_c=overshoot_c, seq_pad_multiple=seq_pad_multiple,
            step_noise=noise.get("steps"), generator=generator)

        if output_type == "latent":
            return latents
        images_np = self._decode(latents, lat_h, lat_w).float().cpu().numpy()
        if output_type == "np":
            return images_np
        return improc.postprocess_image(images_np)

    # ------------------------------------------------------------------
    # batched generation
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_batch_prompts(self, words_list, dtype=torch.bfloat16):
        """(pooled, txt) embeddings for a batch of render-word lists, with
        generate_batch's templates (the shared generic CLIP prompt, a T5
        word prompt per sample). Staged residency: call for every batch
        while the text encoders are resident, then release_text_encoders()."""
        if self.clip is None or self.t5 is None:
            raise ValueError("text encoders were released or never loaded")
        # one CLIP row for the shared prompt: the same pooled vector as a
        # single-item call's (a batch of rows may take other cuBLAS splits)
        t5_ids = np.concatenate([self.t5_tokenize(words_prompt(w)) for w in words_list])
        pooled, txt = self._encode_ids(self.clip_tokenize(GENERIC_TEMPLATE), t5_ids, dtype)
        return pooled.expand(len(words_list), -1).contiguous(), txt

    @torch.inference_mode()
    def generate_batch(
        self,
        images,
        masks,
        words_list,
        *,
        height: int,
        width: int,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        seed: int = 42,
        seeds: Optional[Sequence[int]] = None,
        sampler: Optional[str] = None,
        overshoot_c: Optional[float] = None,
        dtype=torch.bfloat16,
        seq_pad_multiple: Optional[int] = None,
        text_embeds=None,
        noise: Optional[Sequence[Optional[Mapping[str, object]]]] = None,
    ) -> List:
        """Batched generation: all samples share one (height, width) bucket;
        T5 prompts differ per sample, CLIP uses the shared generic template.

        RNG is per sample: sample i consumes exactly the draws of a
        single-item __call__ with seed ``seeds[i]`` (default: ``seed`` for
        every sample), from a generator of its own, so the batched output
        is the per-item output. `noise`: one __call__-style dict per sample
        (or None), handing in that sample's draws.

        On a mesh the batch shards over (data, fsdp): a ragged batch is
        padded to a multiple of the shards by repeating its last sample
        (image, mask, words, seed, noise, embeddings), each data rank
        generates its contiguous slice (the tensor ranks of a data group the
        same slice, together), and the images are all-gathered over the data
        axis, so that every rank returns the whole batch, padding dropped."""
        cfgp = self.pipe_cfg
        steps = num_inference_steps or cfgp.num_inference_steps
        guidance_scale = cfgp.guidance_scale if guidance_scale is None else guidance_scale
        sampler = sampler or cfgp.sampler
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        overshoot_c = cfgp.overshoot_c if overshoot_c is None else overshoot_c
        width, height = (width // 16) * 16, (height // 16) * 16

        b = len(images)
        seeds = [int(x) for x in (seeds if seeds is not None else [seed] * b)]
        noise = [_check_noise(x) for x in (noise if noise is not None else [None] * b)]
        if not len(seeds) == len(masks) == len(words_list) == len(noise) == b:
            raise ValueError(f"{b} images, {len(masks)} masks, {len(words_list)} word "
                             f"lists, {len(seeds)} seeds, {len(noise)} noise entries")
        kw = dict(height=height, width=width, steps=steps, guidance_scale=guidance_scale,
                  sampler=sampler, overshoot_c=overshoot_c, dtype=dtype,
                  seq_pad_multiple=seq_pad_multiple)
        mesh = self.mesh
        if mesh is None or mesh.batch_shards == 1:
            out = self._generate(images, masks, words_list, seeds, noise, text_embeds, **kw)
            return improc.postprocess_image(out.cpu().numpy())

        from textflux_torch.parallel import partitioning as PT

        shards = mesh.batch_shards
        n = b + (-b) % shards

        def padded(xs):
            xs = list(xs)
            return xs + xs[-1:] * (n - b)

        images, masks, words_list, seeds, noise = map(
            padded, (images, masks, words_list, seeds, noise))
        if text_embeds is not None:
            text_embeds = tuple(torch.cat([t] + [t[-1:]] * (n - b))
                                for t in (torch.as_tensor(x) for x in text_embeds))
        part = slice(mesh.batch_rank * n // shards, (mesh.batch_rank + 1) * n // shards)
        out = self._generate(
            images[part], masks[part], words_list[part], seeds[part], noise[part],
            None if text_embeds is None else tuple(t[part] for t in text_embeds), **kw)
        return improc.postprocess_image(PT.all_gather_batch(out, mesh)[:b].cpu().numpy())

    def _generate(self, images, masks, words_list, seeds, noise, text_embeds, *, height: int,
                  width: int, steps: int, guidance_scale: float, sampler: str, overshoot_c,
                  dtype, seq_pad_multiple) -> torch.Tensor:
        """generate_batch on this rank's samples: the decoded images, float32
        (B, H, W, 3) on the device, before ``postprocess_image``."""
        dev = self.device
        b = len(images)
        img = torch.as_tensor(np.concatenate(
            [improc.preprocess_image(im, height, width) for im in images]), device=dev).to(dtype)
        mask = torch.as_tensor(np.concatenate(
            [improc.preprocess_mask(m, height, width) for m in masks]), device=dev).to(dtype)
        if text_embeds is not None:
            # staged residency: embeddings computed while the encoders were
            # resident (encode_batch_prompts)
            pooled, txt = (torch.as_tensor(t, device=dev).to(dtype) for t in text_embeds)
        else:
            pooled, txt = self.encode_batch_prompts(words_list, dtype)

        lat_h = height // self.vae_cfg.spatial_factor
        lat_w = width // self.vae_cfg.spatial_factor
        t_img = (lat_h // 2) * (lat_w // 2)

        generators = [torch.Generator(device=dev).manual_seed(x) for x in seeds]
        draws = [self._initial_draws(img[i:i + 1], mask[i:i + 1], noise[i], generators[i],
                                     t_img, dtype) for i in range(b)]
        cond = torch.cat([c for c, _ in draws])
        latents = torch.cat([lat for _, lat in draws])
        step_noise = None
        if any("steps" in x for x in noise):
            if not all("steps" in x for x in noise):
                raise ValueError("step noise was given for some samples only")
            step_noise = [torch.cat([torch.as_tensor(x["steps"][i], device=dev) for x in noise])
                          for i in range(steps)]

        latents = self._run_denoise(
            latents, cond, txt, pooled,
            t_img=t_img, lat_h=lat_h, lat_w=lat_w, steps=steps,
            guidance_scale=guidance_scale, sampler=sampler,
            overshoot_c=overshoot_c, seq_pad_multiple=seq_pad_multiple,
            step_noise=step_noise, generator=generators)
        # decoded per sample: cuDNN picks its convolution algorithms by
        # shape, so a batched decode's rows differ from a single-item call's
        return torch.cat([self._decode(latents[i:i + 1], lat_h, lat_w).float()
                          for i in range(b)])

    # ------------------------------------------------------------------
    # multi-GPU serving
    # ------------------------------------------------------------------

    def shard_for_serving(self, mesh, quantize: Union[bool, str] = False,
                          quantize_min_size: Optional[int] = None) -> None:
        """Serve over `mesh` (``parallel.partitioning.make_mesh``), the
        port of the JAX package's ``shard_for_serving``: with a tensor axis
        tp > 1 the DiT (whole on this rank) is permuted device-major
        (``tp_permute_flux_params``) and sliced to this rank's shard
        (``shard_module``), in place; batches shard over (data, fsdp); VAE,
        CLIP and T5 stay whole on every rank. ``quantize`` (False, True =
        "weight_only", or a mode of ``io.quantize``) quantises the DiT after
        the permutation (the order NF4 needs, its packed input rows cannot
        be permuted). A pipeline already permuted for another tp raises:
        reload the checkpoint."""
        from textflux_torch.io.quantize import check_mode, quantize_tree
        from textflux_torch.parallel import partitioning as PT

        PT.check_serving_mesh(mesh)
        if mesh.device.type != self.device.type or (
                None not in (mesh.device.index, self.device.index)
                and mesh.device.index != self.device.index):
            raise ValueError(f"the mesh's device {mesh.device} is not the pipeline's "
                             f"{self.device}")
        if self.flux is None:
            raise ValueError("the DiT is not loaded: call load_transformer() first")
        mode = (check_mode(quantize if isinstance(quantize, str) else "weight_only")
                if quantize else None)
        tp, flux = mesh.tensor, self.flux
        if flux.tp_layout not in (1, tp):
            raise ValueError(f"pipeline already tensor-permuted for tp={flux.tp_layout}; "
                             f"reload the checkpoint to serve at tp={tp}")
        if flux.tp_rank is not None:
            if flux.tp_rank != mesh.tensor_rank or mode:
                raise ValueError("the DiT already holds a shard: reload the checkpoint to "
                                 "shard or quantise it anew")
        elif tp > 1:
            if flux.tp_layout == 1:
                transformer.tp_permute_flux_params(flux, tp)
            PT.shard_module(flux, PT.flux_param_specs(self.flux_cfg), mesh, quantize=mode,
                            min_size=quantize_min_size)
        elif mode:
            quantize_tree(flux, mode=mode, min_size=quantize_min_size)
        self.mesh = mesh

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        base_path: str,
        *,
        transformer_path: Optional[str] = None,
        lora_path: Optional[str] = None,
        lora_scale: float = 1.0,
        dtype=torch.bfloat16,
        quantize: Union[bool, str] = False,
        quantize_t5: Optional[bool] = None,
        defer_transformer: bool = False,
        mesh=None,
        pipe_cfg: PipelineConfig = PipelineConfig(),
        attn_impl: str = "auto",
        device="cuda",
    ) -> "FillPipeline":
        """Load from a diffusers-layout checkpoint directory (subfolders:
        transformer/ vae/ text_encoder/ text_encoder_2/ tokenizer*/), onto
        `device`, with `lora_path` (a peft LoRA file or directory) folded
        into the DiT at `lora_scale` as it loads.

        ``defer_transformer=True`` (staged residency) loads everything but
        the DiT: encode the prompts, ``release_text_encoders()``, then
        ``load_transformer()``, so the T5 encoder and the DiT never sit on
        the device together.

        ``quantize``: False, True (= "weight_only") or a mode of
        ``io.quantize`` ("weight_only", "w8a8", "nf4", "mixed"): the DiT's
        linears are quantised as its checkpoint streams in (after the LoRA
        fold), so the device never holds the full-precision DiT.
        ``quantize_t5`` (default: ``bool(quantize)``) stores T5 int8
        weight-only the same way. A quantised model stays quantised on the
        device.

        ``mesh`` (``parallel.partitioning.make_mesh``; every rank calls this
        with the same arguments): the pipeline serves on the mesh's device
        (``device`` is not read), and with a tensor axis tp > 1 each rank
        loads only its shard of the DiT, permuted device-major and (with
        ``quantize``) quantised on the way in (``io.params.load_flux_shard``;
        a LoRA folds into each whole tensor before the slice); deferred too.
        VAE, CLIP and T5 load whole on every rank.

        ``load_stats`` records each component's load seconds, checkpoint
        bytes and ``device_bytes``, what its module holds on the device
        (the quantised bytes of a quantised component; a rank's shard of
        a tensor-parallel DiT)."""
        from textflux_torch.io.config_io import (clip_config_from, flux_config_from,
                                                 t5_config_from, vae_config_from)
        from textflux_torch.io.lora import load_folded_flux_transformer, resolve_lora_path
        from textflux_torch.io.params import (checkpoint_bytes, load_checkpoint_dir,
                                              load_flux_transformer)
        from textflux_torch.io.quantize import check_mode, quantized_bytes
        from textflux_torch.pipeline.tokenizers import load_tokenizers

        flux_mode = check_mode(quantize if isinstance(quantize, str) else "weight_only") \
            if quantize else None
        t5_mode = "weight_only" if (bool(quantize) if quantize_t5 is None else quantize_t5) \
            else None
        if mesh is not None:
            from textflux_torch.parallel.partitioning import check_serving_mesh

            check_serving_mesh(mesh)
            device = mesh.device
        dev = resolve_device(device)
        t_path = transformer_path or os.path.join(base_path, "transformer")
        flux_cfg = flux_config_from(t_path)
        stats = {}

        def timed(name, paths, fn):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stats[name] = dict(seconds=time.perf_counter() - t0,
                               bytes=sum(checkpoint_bytes(p) for p in paths),
                               device_bytes=quantized_bytes(out))
            return out

        def load_flux():
            if lora_path is None:
                return timed("transformer", [t_path], lambda: load_flux_transformer(
                    t_path, flux_cfg, dtype=dtype, device=dev, quantize=flux_mode, mesh=mesh))
            return timed("transformer", [t_path, resolve_lora_path(lora_path)],
                         lambda: load_folded_flux_transformer(
                             t_path, lora_path, flux_cfg, scale=lora_scale, dtype=dtype,
                             device=dev, quantize=flux_mode, mesh=mesh))

        flux = None if defer_transformer else load_flux()
        parts = {}
        for name, sub, cfg_from, mode in (("vae", "vae", vae_config_from, None),
                                          ("clip", "text_encoder", clip_config_from, None),
                                          ("t5", "text_encoder_2", t5_config_from, t5_mode)):
            path = os.path.join(base_path, sub)
            parts[name] = timed(name, [path], lambda: load_checkpoint_dir(
                path, cfg_from(path), dtype=dtype, device=dev, quantize=mode))
        clip_tok, t5_tok = load_tokenizers(base_path,
                                           max_t5_length=pipe_cfg.max_sequence_length)
        pipe = cls(flux=flux, flux_cfg=flux_cfg, **parts, clip_tokenize=clip_tok,
                   t5_tokenize=t5_tok, pipe_cfg=pipe_cfg, attn_impl=attn_impl, device=dev,
                   mesh=mesh)
        pipe.load_stats = stats
        if defer_transformer:
            pipe._deferred_flux = load_flux
        return pipe

    def release_text_encoders(self) -> None:
        """Drop the text encoders (the staged-residency phase boundary: all
        prompts are encoded, the DiT loads next); their device memory goes
        back to the caching allocator for the DiT to reuse."""
        self.clip = None
        self.t5 = None

    def load_transformer(self) -> None:
        """Load the DiT deferred by from_pretrained(defer_transformer=True)
        (this rank's shard on a mesh with a tensor axis), half-permuting it
        for the fused attention path."""
        if self.flux is not None:
            return
        if not hasattr(self, "_deferred_flux"):
            raise ValueError("pipeline was not built with defer_transformer=True")
        flux = self._deferred_flux()
        if self.attn_impl == "fused":
            transformer.half_permute_flux_params(flux)
        self.flux = flux
