"""Wan2.1-VACE editing of the TextFlux canvas over a clip, with classifier-free guidance.

``WanVACEPipeline`` is ``FillPipeline``'s counterpart for Wan2.1-VACE (its
DiT with the VACE branch, UMT5-XXL as text encoder, the Wan VAE over
clips) and takes the call ``cli.run_inference.run`` makes for a clip: the
canvas of every frame (the glyph strip above the frame) and its mask, the
prompts, the steps, the guidance and the seed. VACE edits natively: the
masked region is generated under the control of the rest. Stages:

  1. text encode  — the words prompt (``prompt_2``, the T5 template of the
                    FLUX pipeline) and the negative prompt, each through
                    UMT5 over 512 padded ids with the attention mask, rows
                    past the prompt's own tokens set to zero (span
                    ``text.umt5``)
  2. control      — the Wan VAE's normalised posterior means of the clip
                    with the mask blacked out (inactive) and of the clip
                    inside the mask alone (reactive), two clip encodes
                    (spans ``vae.encode``, attribute ``frames``), and the
                    mask's 8 x 8 pixel blocks as 64 channels at latent
                    resolution, its frames picked by nearest-exact
                    interpolation: the 96-channel control
  3. denoise      — per step two DiT forwards (the prompt's and the
                    negative's velocity), their CFG combination
                    (``samplers.cfg``) and the Euler step; sigmas
                    linspace(1, 1/N, N) under the static shift
  4. decode       — the Wan VAE decode of the clip (span ``vae.decode``),
                    clamped

Every step's modulation vectors come from the timestep alone, so one
``wan_mods`` per clip serves both forwards of every step. ``tokens`` counts
the video tokens and the text keys each DiT forward was given
(``WanVACEPipeline.tokens``).

Draws: one ``torch.Generator`` seeded by the request's seed draws the
initial latents (B, 16, T', h, w) in float32 (the published layout), then
NTHWC and rounded to bf16. The encodes take the posterior's mean.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from textflux_torch.config import WanPipelineConfig
from textflux_torch.device import resolve_device
from textflux_torch.models import transformer
from textflux_torch.models.t5 import T5Encoder, t5_encode
from textflux_torch.models.vae_wan import (WanVAE, latent_frames, wan_decode_video,
                                           wan_encode_video)
from textflux_torch.models.wan import WanVACETransformer, rope_ids, step_mods, wan_mods, wan_temb
from textflux_torch.ops import samplers
from textflux_torch.pipeline import image_processor as improc
from textflux_torch.pipeline.fill import timed_load
from textflux_torch.utils.tracking import span

TEXT_LEN = 512
MASK_BLOCK = 8      # pixels per side of the mask's blocks: the VAE's spatial factor


def mask_control(mask: torch.Tensor, frames_out: int, f: int = MASK_BLOCK) -> torch.Tensor:
    """(B, T, H, W) pixel mask -> (B, T', H/f, W/f, f*f): each f x f block's
    pixels as channels (row-major within the block, diffusers'
    ``prepare_masks``), the frames picked by nearest-exact interpolation
    from T to T'."""
    b, t, h, w = mask.shape
    m = mask.reshape(b, t, h // f, f, w // f, f).permute(0, 1, 2, 4, 3, 5)
    m = m.reshape(b, t, h // f, w // f, f * f)
    idx = [min(int(np.floor((j + 0.5) * t / frames_out)), t - 1) for j in range(frames_out)]
    return m[:, idx]


class WanVACEPipeline:
    """Scene-text editing of a clip with Wan2.1-VACE (module docstring).

    `tokenize` maps a string to (1, L) token ids with its EOS, 0 being the
    padding id (a T5 tokenizer's)."""

    def __init__(self, *, dit: WanVACETransformer, vae: WanVAE, text_encoder: T5Encoder,
                 tokenize: Callable[[str], np.ndarray],
                 pipe_cfg: WanPipelineConfig = WanPipelineConfig(), attn_impl: str = "auto",
                 device="cuda"):
        self.device = resolve_device(device)
        self.dit, self.vae, self.text_encoder = (m.to(self.device)
                                                 for m in (dit, vae, text_encoder))
        self.dit_cfg, self.vae_cfg = dit.cfg, vae.cfg
        self.tokenize = tokenize
        self.pipe_cfg = pipe_cfg
        self.attn_impl = transformer.resolve_attn_impl(attn_impl, self.dit_cfg.head_dim,
                                                       self.device)
        transformer.to_attn_layout(self.dit, self.attn_impl)
        self.tokens = {"video": 0, "text_keys": 0, "forwards": 0}
        self.load_stats = {}

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompts(self, prompt: str, dtype=torch.bfloat16):
        """(positive, negative) embeddings, (1, 512, d_model) each, zero past
        each prompt's tokens: `prompt`'s and the configuration's negative
        prompt's."""
        return tuple(self._encode(p, dtype) for p in (prompt, self.pipe_cfg.negative_prompt))

    def _encode(self, prompt: str, dtype):
        with span("text.umt5"):
            ids = np.asarray(self.tokenize(prompt))[:, :TEXT_LEN]
            ids = np.pad(ids, ((0, 0), (0, TEXT_LEN - ids.shape[1])))
            ids = torch.as_tensor(ids, device=self.device, dtype=torch.long)
            keep = ids > 0
            out = t5_encode(self.text_encoder, ids, keep.long(), dtype=dtype)
            return out * keep[..., None].to(out.dtype)

    def _prepare_video(self, video, mask):
        """The control (B, T', h, w, 96): the inactive and the reactive
        clip's normalised latents and the mask's 64 channels."""
        m = mask[..., None].to(video.dtype)
        t = video.shape[1]
        lat = []
        for part in (video * (1.0 - m), video * m):
            with span("vae.encode", vae="wan", frames=t):
                lat.append(wan_encode_video(self.vae, part))
        return torch.cat(lat + [mask_control(mask.to(video.dtype), lat[0].shape[1])], -1)

    def _decode(self, latents):
        with span("vae.decode", vae="wan", frames=4 * (latents.shape[1] - 1) + 1):
            return wan_decode_video(self.vae, latents)

    def _guidance(self, v_cond, v_uncond, scale: float):
        with span("fill.guidance"):
            return samplers.cfg(v_cond, v_uncond, scale)

    def _denoise_step(self, lat, texts, mods, sigma, sigma_next, *, cfg_scale: float, control,
                      rope, step: int = 0):
        """One step (number `step`): the velocity of each text (the prompt's,
        then the negative's), their CFG combination and the Euler update."""
        with span("fill.denoise_step", step=step):
            v_cond, v_uncond = (self._velocity(lat, control, txt, rope, mods) for txt in texts)
            v = self._guidance(v_cond, v_uncond, cfg_scale)
            with span("sampler.update"):
                return samplers.euler_step(lat, v, sigma, sigma_next)

    def _velocity(self, lat, control, txt, rope, mods):
        p = self.dit_cfg.patch_size
        self.tokens["video"] += lat.shape[0] * (lat.shape[1] // p[0]) * (
            lat.shape[2] // p[1]) * (lat.shape[3] // p[2])
        self.tokens["text_keys"] += txt.shape[0] * txt.shape[1]
        self.tokens["forwards"] += 1
        return self.dit(lat, control, txt, *rope, mods=mods, attn_impl=self.attn_impl)

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
        """Edit the clip `image` (a list of 1 + 4k canvases, one a frame)
        under `mask_image` (one mask a frame; white: repaint), in bf16; a
        list of PIL frames. ``cli.run_inference.run``'s call of
        ``FillPipeline``: the prompt is `prompt_2` (the words template),
        else `prompt`; `guidance_scale` is the CFG scale (default 5.0);
        `text_embeds` an optional (positive, negative) pair of padded
        embeddings. The sampler is Euler; `overshoot_c` is not read."""
        cfgp = self.pipe_cfg
        steps = num_inference_steps or cfgp.num_inference_steps
        dtype = torch.bfloat16
        with span("fill.call", steps=steps) as call:
            if (sampler or "euler") != "euler":
                raise ValueError(f"the Wan2.1-VACE pipeline samples with Euler, not {sampler!r}")
            if not isinstance(image, (list, tuple)) or len(image) != len(mask_image):
                raise ValueError("a clip is a list of frames with one mask each")
            frames = len(image)
            t_lat = latent_frames(frames)
            scale = cfgp.guidance_scale if guidance_scale is None else float(guidance_scale)
            dev = self.device
            img, mask, height, width = improc.canvas(list(image), list(mask_image), height,
                                                     width, device=dev, dtype=dtype)
            call.set(height=height, width=width, frames=frames)
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
            z = self.vae_cfg.z_dim
            generator = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn((1, z, t_lat, lat_h, lat_w), generator=generator, device=dev,
                                dtype=torch.float32).permute(0, 2, 3, 4, 1).to(dtype)
            control = self._prepare_video(img[None], mask[None])

            with span("fill.schedule"):
                sigmas = samplers.make_schedule(steps, shift=cfgp.flow_shift,
                                                use_dynamic_shifting=False)
                p = self.dit_cfg.patch_size
                rope = transformer.model_rope_tables(
                    self.dit, rope_ids(t_lat // p[0], lat_h // p[1], lat_w // p[2]), dev)
                mods_all = wan_mods(self.dit, wan_temb(self.dit, sigmas[:-1], dtype, dev))

            latents = noise
            for i in range(steps):
                latents = self._denoise_step(latents, (txt_pos, txt_neg),
                                             step_mods(mods_all, i, 1), sigmas[i], sigmas[i + 1],
                                             cfg_scale=scale, control=control, rope=rope, step=i)
            decoded = self._decode(latents)
            with span("fill.postprocess"):
                return improc.postprocess_image(decoded[0].float().cpu().numpy())

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, base_path: str, *, transformer_path: Optional[str] = None,
                        tokenize: Optional[Callable[[str], np.ndarray]] = None,
                        dtype=torch.bfloat16, pipe_cfg: WanPipelineConfig = WanPipelineConfig(),
                        attn_impl: str = "auto", device="cuda") -> "WanVACEPipeline":
        """Load a diffusers-layout Wan2.1-VACE checkpoint directory
        (transformer/ text_encoder/ vae/ tokenizer/) onto `device`. The
        tokenizer is ``transformers``' from tokenizer/ unless `tokenize` is
        given."""
        from textflux_torch.io.config_io import (t5_config_from, wan_vace_config_from,
                                                 wan_vae_config_from)
        from textflux_torch.io.params import load_checkpoint_dir

        dev = resolve_device(device)
        if tokenize is None:
            tokenize = load_umt5_tokenizer(os.path.join(base_path, "tokenizer"))
        stats, parts = {}, {}
        t_path = transformer_path or os.path.join(base_path, "transformer")
        for name, path, cfg_from in (("dit", t_path, wan_vace_config_from),
                                     ("text_encoder", os.path.join(base_path, "text_encoder"),
                                      t5_config_from),
                                     ("vae", os.path.join(base_path, "vae"), wan_vae_config_from)):
            parts[name] = timed_load(stats, name, [path], lambda: load_checkpoint_dir(
                path, cfg_from(path), dtype=dtype, device=dev), dev)
        pipe = cls(**parts, tokenize=tokenize, pipe_cfg=pipe_cfg, attn_impl=attn_impl,
                   device=dev)
        pipe.load_stats = stats
        return pipe


def load_umt5_tokenizer(path: str):
    """tokenize from a T5 / UMT5 tokenizer directory (``transformers``,
    imported here only): ids (1, L) int64 with EOS, truncated at 512."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def tokenize(text: str) -> np.ndarray:
        return np.asarray(tok(text, truncation=True, max_length=TEXT_LEN,
                              return_tensors="np")["input_ids"], np.int64)

    return tokenize
