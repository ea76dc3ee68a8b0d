"""Qwen-Image inpainting of the TextFlux canvas, with true classifier-free guidance.

``QwenImagePipeline`` is ``FillPipeline``'s counterpart for Qwen-Image (the
Qwen-Image DiT, the Qwen2.5-VL language model as text encoder, the Wan
VAE) and takes the same call from ``cli.run_inference.run``: the canvas
(glyph strip and scene) and its mask, the prompts, the steps, the guidance
and the seed. Qwen-Image has no Fill variant, so the masked region is
inpainted as diffusers' Qwen-Image and FLUX inpaint pipelines do it, at
strength 1. Stages:

  1. text encode  — the words prompt (``prompt_2``, the T5 template of the
                    FLUX pipeline) inside Qwen-Image's chat template, and
                    the negative prompt " ", each encoded alone at its own
                    length; the system prefix's tokens are dropped
  2. image        — the Wan VAE's normalised posterior mean z0 of the whole
                    canvas, packed into 2x2 tokens; the canvas mask at
                    latent resolution (its top-left pixel of each 8 x 8),
                    packed the same way
  3. denoise      — per step two DiT forwards (the prompt's and the
                    negative's velocity), their true-CFG combination with
                    its norm rescale (``samplers.true_cfg``), the Euler
                    step, and the blend (``samplers.mask_blend``): the
                    unmasked tokens take z0 noised to the next sigma with
                    the initial draw
  4. decode       — the Wan VAE decode, clamped

The schedule is ``samplers.make_terminal_schedule`` (exponential shift over
the packed image length, stretched to a last sigma of 0.02). Every step's
modulation vectors come from the timestep alone, so one ``flux_mods`` per
image serves both forwards of every step.

Texts of any length share the DiT's CUDA graphs: each is padded with zeros
to its bucket (``models.qwen_image.text_bucket``) after the image tokens,
and the attention masks the padding by its key length, an int32 device
tensor the graph takes as an input; ``text_tokens`` counts the real and the
padded text tokens the DiT was given.

Draws: one ``torch.Generator`` seeded by the request's seed draws the
initial latents (B, T_img, 64) in float32, rounded to bf16; they are also
the blend's noise. The encode takes the posterior's mean and draws nothing.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from textflux_torch.config import QwenPipelineConfig
from textflux_torch.device import resolve_device
from textflux_torch.models import transformer
from textflux_torch.models.qwen_image import (QwenImageTransformer, model_timesteps, qwen_apply,
                                              qwen_vec, rope_ids, text_bucket)
from textflux_torch.models.qwen_text import QwenTextEncoder, qwen_encode
from textflux_torch.models.vae_wan import WanVAE, wan_decode, wan_encode
from textflux_torch.ops import packing, samplers
from textflux_torch.pipeline import image_processor as improc
from textflux_torch.pipeline.fill import timed_load
from textflux_torch.pipeline.prompts import QWEN_MAX_TOKENS, QWEN_PREFIX, QWEN_TEMPLATE
from textflux_torch.utils.tracking import span


class QwenImagePipeline:
    """Scene-text inpainting with Qwen-Image (module docstring).

    `tokenize` maps a string to (1, L) token ids; `template_drop` is the
    number of leading ids of the templated prompt that the embedding drops
    (the system prefix's)."""

    def __init__(self, *, dit: QwenImageTransformer, vae: WanVAE, text_encoder: QwenTextEncoder,
                 tokenize: Callable[[str], np.ndarray], template_drop: int,
                 pipe_cfg: QwenPipelineConfig = QwenPipelineConfig(), attn_impl: str = "auto",
                 device="cuda"):
        self.device = resolve_device(device)
        self.dit, self.vae, self.text_encoder = (m.to(self.device)
                                                 for m in (dit, vae, text_encoder))
        self.dit_cfg, self.vae_cfg = dit.cfg, vae.cfg
        self.tokenize = tokenize
        self.template_drop = int(template_drop)
        self.pipe_cfg = pipe_cfg
        self.attn_impl = transformer.resolve_attn_impl(attn_impl, self.dit_cfg.head_dim,
                                                       self.device)
        transformer.to_attn_layout(self.dit, self.attn_impl)
        self.text_tokens = {"real": 0, "padded": 0}
        self.load_stats = {}

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompts(self, prompt: str, dtype=torch.bfloat16):
        """(positive, negative) embeddings, (1, L, hidden) each at its own
        length: `prompt`'s and the configuration's negative prompt's."""
        return tuple(self._encode(p, dtype) for p in (prompt, self.pipe_cfg.negative_prompt))

    def _encode(self, prompt: str, dtype):
        with span("text.qwen"):
            ids = np.asarray(self.tokenize(QWEN_TEMPLATE.format(prompt)))
            ids = ids[:, :self.template_drop + QWEN_MAX_TOKENS]
            ids = torch.as_tensor(ids, device=self.device, dtype=torch.long)
            return qwen_encode(self.text_encoder, ids, dtype=dtype)[:, self.template_drop:]

    def _prepare_image(self, image, mask):
        """(z0, mask) tokens: the canvas's normalised posterior mean and the
        mask at latent resolution, both packed (B, T_img, 4 * 16)."""
        f = self.vae_cfg.spatial_factor
        with span("vae.encode", vae="wan"):
            z0 = packing.pack_latents(wan_encode(self.vae, image))
            m = mask[:, ::f, ::f, None].expand(-1, -1, -1, self.vae_cfg.z_dim)
            return z0, packing.pack_latents(m.to(z0.dtype))

    def _decode(self, latents, lat_h: int, lat_w: int):
        with span("vae.decode", vae="wan"):
            return wan_decode(self.vae, packing.unpack_latents(latents, lat_h, lat_w))

    def _padded_text(self, txt):
        """(`txt` zero-padded to its bucket, its length, the bucket), the
        two lengths counted in ``text_tokens``."""
        n = txt.shape[1]
        bucket = text_bucket(n)
        self.text_tokens["real"] += n
        self.text_tokens["padded"] += bucket - n
        return torch.nn.functional.pad(txt, (0, 0, 0, bucket - n)), n, bucket

    def _guidance(self, v_cond, v_uncond, scale: float):
        with span("fill.guidance"):
            return samplers.true_cfg(v_cond, v_uncond, scale)

    def _blend(self, lat, mask, z0, noise, sigma_next):
        with span("sampler.blend"):
            return samplers.mask_blend(lat, mask, z0, noise, sigma_next)

    def _denoise_step(self, lat, texts, mods, sigma, sigma_next, *, cfg_scale: float, mask, z0,
                      noise, step: int = 0):
        """One step (number `step`): the velocity of each text (the prompt's,
        then the negative's; each (txt, cos, sin, kv_len)), their true-CFG
        combination, the Euler update and the blend."""
        with span("fill.denoise_step", step=step):
            v_cond, v_uncond = (qwen_apply(self.dit, lat, txt, cos, sin, mods=mods,
                                           attn_impl=self.attn_impl, kv_len=kv_len)
                                for txt, cos, sin, kv_len in texts)
            v = self._guidance(v_cond, v_uncond, cfg_scale)
            with span("sampler.update"):
                lat = samplers.euler_step(lat, v, sigma, sigma_next)
            return self._blend(lat, mask, z0, noise, sigma_next)

    def _texts(self, txt_pos, txt_neg, grid_h: int, grid_w: int):
        """Per text: (padded embedding, RoPE cos, sin, key length)."""
        out = []
        t_img = grid_h * grid_w
        for txt in (txt_pos, txt_neg):
            padded, n, bucket = self._padded_text(txt)
            cos, sin = transformer.model_rope_tables(self.dit, rope_ids(grid_h, grid_w, bucket),
                                                     self.device)
            kv_len = torch.full((txt.shape[0],), t_img + n, dtype=torch.int32, device=self.device)
            out.append((padded, cos, sin, kv_len))
        return out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, *, image, mask_image, prompt: Optional[str] = None,
                 prompt_2: Optional[str] = None, height: Optional[int] = None,
                 width: Optional[int] = None, num_inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None, seed: int = 42,
                 sampler: Optional[str] = None, overshoot_c: Optional[float] = None,
                 text_embeds=None):
        """Inpaint the canvas `image` under `mask_image` (white: repaint),
        in bf16; a list of one PIL image. ``cli.run_inference.run``'s call
        of ``FillPipeline``: the prompt is `prompt_2` (the words template),
        else `prompt`; `guidance_scale` is the true-CFG scale (default 4.0);
        `text_embeds` an optional (positive, negative) pair of embeddings.
        The sampler is Euler; `overshoot_c` is not read."""
        cfgp = self.pipe_cfg
        steps = num_inference_steps or cfgp.num_inference_steps
        dtype = torch.bfloat16
        with span("fill.call", steps=steps) as call:
            if (sampler or "euler") != "euler":
                raise ValueError(f"the Qwen-Image pipeline samples with Euler, not {sampler!r}")
            scale = cfgp.true_cfg_scale if guidance_scale is None else float(guidance_scale)
            dev = self.device
            img, mask, height, width = improc.canvas(image, mask_image, height, width,
                                                     device=dev, dtype=dtype)
            call.set(height=height, width=width)
            if text_embeds is None:
                text = prompt_2 or prompt
                if text is None:
                    raise ValueError("provide a prompt or text_embeds")
                txt_pos, txt_neg = self.encode_prompts(text, dtype)
            else:
                txt_pos, txt_neg = (torch.as_tensor(t, device=dev).to(dtype)
                                    for t in text_embeds)

            f = self.vae_cfg.spatial_factor
            lat_h, lat_w = height // f, width // f
            grid_h, grid_w = lat_h // 2, lat_w // 2
            t_img = grid_h * grid_w
            generator = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn((img.shape[0], t_img, 4 * self.vae_cfg.z_dim), generator=generator,
                                device=dev, dtype=torch.float32).to(dtype)
            z0, mask_tokens = self._prepare_image(img, mask)

            with span("fill.schedule"):
                sigmas = samplers.make_terminal_schedule(
                    steps, t_img, base_seq_len=cfgp.base_image_seq_len,
                    max_seq_len=cfgp.max_image_seq_len, base_shift=cfgp.base_shift,
                    max_shift=cfgp.max_shift, shift_terminal=cfgp.shift_terminal)
                texts = self._texts(txt_pos, txt_neg, grid_h, grid_w)
                b = img.shape[0]
                ts = model_timesteps(sigmas[:-1], dtype, dev)
                mods_all = transformer.flux_mods(
                    self.dit, qwen_vec(self.dit, ts.repeat_interleave(b), dtype))

            latents = noise
            for i in range(steps):
                latents = self._denoise_step(latents, texts, transformer.step_mods(mods_all, i, b),
                                             sigmas[i], sigmas[i + 1], cfg_scale=scale,
                                             mask=mask_tokens, z0=z0, noise=noise, step=i)
            call.set(joint=t_img + texts[0][0].shape[1])
            decoded = self._decode(latents, lat_h, lat_w)
            with span("fill.postprocess"):
                return improc.postprocess_image(decoded.float().cpu().numpy())

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, base_path: str, *, transformer_path: Optional[str] = None,
                        tokenize: Optional[Callable[[str], np.ndarray]] = None,
                        template_drop: Optional[int] = None, dtype=torch.bfloat16,
                        pipe_cfg: QwenPipelineConfig = QwenPipelineConfig(),
                        attn_impl: str = "auto", device="cuda") -> "QwenImagePipeline":
        """Load a diffusers-layout Qwen-Image checkpoint directory
        (transformer/ text_encoder/ vae/ tokenizer/) onto `device`. The
        tokenizer is ``transformers``' from tokenizer/ (dropping the
        template's 34-token system prefix) unless `tokenize` and
        `template_drop` are given."""
        from textflux_torch.io.config_io import (qwen_image_config_from, qwen_text_config_from,
                                                 wan_vae_config_from)
        from textflux_torch.io.params import load_checkpoint_dir

        dev = resolve_device(device)
        if tokenize is None:
            tokenize, template_drop = load_qwen_tokenizer(os.path.join(base_path, "tokenizer"))
        elif template_drop is None:
            raise ValueError("a tokenize function needs its template_drop")
        stats, parts = {}, {}
        t_path = transformer_path or os.path.join(base_path, "transformer")
        for name, path, cfg_from in (("dit", t_path, qwen_image_config_from),
                                     ("text_encoder", os.path.join(base_path, "text_encoder"),
                                      qwen_text_config_from),
                                     ("vae", os.path.join(base_path, "vae"), wan_vae_config_from)):
            parts[name] = timed_load(stats, name, [path], lambda: load_checkpoint_dir(
                path, cfg_from(path), dtype=dtype, device=dev), dev)
        pipe = cls(**parts, tokenize=tokenize, template_drop=template_drop, pipe_cfg=pipe_cfg,
                   attn_impl=attn_impl, device=dev)
        pipe.load_stats = stats
        return pipe


def load_qwen_tokenizer(path: str):
    """(tokenize, template_drop) from a Qwen2 tokenizer directory
    (``transformers``, imported here only): ids (1, L) int64, and the number
    of tokens of the chat template's system prefix."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def tokenize(text: str) -> np.ndarray:
        return np.asarray(tok(text, return_tensors="np")["input_ids"], np.int64)

    return tokenize, int(tokenize(QWEN_PREFIX).shape[1])

