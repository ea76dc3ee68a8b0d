"""Qwen-Image's MM-DiT: FLUX's double-stream block, 60 deep, and nothing else.

``QwenImageTransformer`` holds diffusers' ``QwenImageTransformer2DModel``
in the layout of ``models.transformer.FluxTransformer``: the blocks are
that module's ``DoubleBlock`` under ``double_blocks.N`` (fused q|k|v per
stream, per-head q/k RMSNorm, joint attention, GELU-tanh MLPs, AdaLN
modulation chunked shift1, scale1, gate1, shift2, scale2, gate2), run by
the same ``double_block``; ``single_blocks`` is empty. What differs is
around the blocks:

* the text passes an RMSNorm (``txt_norm``) before ``txt_in``;
* the modulation's condition is the timestep alone: the timestep in the
  activation dtype, its sinusoid's angles scaled by 1000 after the
  frequencies (diffusers' ``Timesteps(scale=1000)``), then ``time_in``; no
  guidance embedding, no pooled vector. ``transformer.flux_mods`` computes
  every step's modulation vectors from it at once, as for FLUX;
* the RoPE ids are centred (``rope_ids``), and the joint sequence is
  [img | txt]: attention does not see the order, and with the text last a
  text padded to a bucket is masked by the attention's key length.

A serving call (CUDA, gradients off, modulation vectors given) runs from
the module's ``ForwardGraphs`` through FLUX's ``graph_call``. Its key holds
the inputs' shapes (the text's padded length, its bucket, among them) and
never the text's own length: that reaches the fused kernel as an int32
device tensor (``kv_len``), an input of the graph, so requests whose texts
differ in length but share a bucket replay one graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from textflux_torch.config import QwenImageConfig
from textflux_torch.models.layers import (MLP, dense, make_linear, ones_param, rms_norm, silu,
                                          timestep_embedding)
from textflux_torch.models.transformer import (DoubleBlock, _graphed, check_attn_layout,
                                               dit_init, graph_call, output_head)

TIMESTEP_SCALE = 1000.0
# text buckets: powers of two from this up, so a prompt's length moves its
# bucket only across a doubling
MIN_TEXT_BUCKET = 64


def text_bucket(n: int) -> int:
    """The padded length of a text of `n` tokens: the least power of two
    that holds it, at least MIN_TEXT_BUCKET."""
    return max(MIN_TEXT_BUCKET, 1 << max(0, int(n) - 1).bit_length())


def rope_ids(grid_h: int, grid_w: int, n_txt: int) -> np.ndarray:
    """(grid_h * grid_w + n_txt, 3) float64 RoPE ids of the joint sequence
    [img | txt] over a grid_h x grid_w grid of image tokens, as diffusers'
    ``QwenEmbedRope(scale_rope=True)`` places them: image token (r, c) at
    (0, r - (grid_h - grid_h // 2), c - (grid_w - grid_w // 2)), centred on
    the grid; text token j at (m + j) on every axis, m = max(grid_h // 2,
    grid_w // 2)."""
    rows = np.arange(grid_h) - (grid_h - grid_h // 2)
    cols = np.arange(grid_w) - (grid_w - grid_w // 2)
    img = np.zeros((grid_h, grid_w, 3), np.float64)
    img[..., 1] = rows[:, None]
    img[..., 2] = cols[None, :]
    m = max(grid_h // 2, grid_w // 2)
    txt = np.repeat((m + np.arange(n_txt, dtype=np.float64))[:, None], 3, axis=1)
    return np.concatenate([img.reshape(-1, 3), txt])


class QwenImageTransformer(nn.Module):
    """Qwen-Image DiT parameters, initialised with the JAX package's
    distributions from `generator` (default: seed 0 on `device`). The
    attributes ``rope_layout``, ``tp_layout`` and ``tp_rank`` mean what they
    mean on ``FluxTransformer`` (``transformer.half_permute_flux_params``
    permutes this module too); only tp = 1 is served."""

    def __init__(self, cfg: QwenImageConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dit_init(self, cfg, device, dtype, generator)
        d = cfg.hidden_dim
        self.img_in = make_linear(cfg.in_channels, d, **kw)
        self.txt_norm = ones_param(cfg.joint_dim, device=kw["device"], dtype=dtype)
        self.txt_in = make_linear(cfg.joint_dim, d, **kw)
        self.time_in = MLP(cfg.time_embed_channels, d, d, **kw)
        self.final_mod = make_linear(d, 2 * d, **kw)
        self.final_proj = make_linear(d, cfg.out_channels, **kw)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(cfg, **kw) for _ in range(cfg.num_double_layers))
        self.single_blocks = nn.ModuleList()

    def forward(self, img_tokens, txt_tokens, rope_cos, rope_sin, *, attn_impl: str,
                kv_len=None, mods) -> torch.Tensor:
        """The velocity (see ``qwen_apply``)."""
        args = dict(img_tokens=img_tokens, txt_tokens=txt_tokens, rope_cos=rope_cos,
                    rope_sin=rope_sin, attn_impl=attn_impl, kv_len=kv_len)
        if _graphed(img_tokens, remat=False, mods=mods, mesh=None):
            return graph_call(self, mods, **args)
        return self._forward(**args, mods=mods)

    def _forward(self, img_tokens, txt_tokens, rope_cos, rope_sin, *, attn_impl: str, kv_len,
                 mods):
        dtype = img_tokens.dtype
        if attn_impl != "fused" and kv_len is not None:
            lens = set(kv_len.tolist())
            if len(lens) != 1:
                raise ValueError(f"attn_impl={attn_impl!r} takes one key length for the "
                                 f"batch, got {sorted(lens)}")
            kv_len = lens.pop()
        img = dense(self.img_in, img_tokens)
        txt = dense(self.txt_in, rms_norm(txt_tokens.to(dtype), self.txt_norm, 1e-6))
        rope_cos, rope_sin = rope_cos.float(), rope_sin.float()
        for blk, m in zip(self.double_blocks, mods["double"]):
            txt, img = blk(txt, img, None, m, rope_cos, rope_sin, attn_impl, kv_len, None,
                           img_first=True)
        return output_head(self, img, mods["final"])


def qwen_vec(model: QwenImageTransformer, timestep: torch.Tensor, dtype=torch.bfloat16):
    """The modulation's condition (N, D) from the timestep (N,) (sigma in
    [0, 1], in the activation dtype): ``time_in`` of its sinusoid, whose
    angles are scaled by 1000."""
    emb = timestep_embedding(timestep.to(dtype), model.cfg.time_embed_channels,
                             scale=TIMESTEP_SCALE)
    return dense(model.time_in.fc2, silu(dense(model.time_in.fc1, emb.to(dtype))))


def model_timesteps(sigmas, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """The timesteps Qwen-Image's pipeline hands its DiT for float32
    sigmas: sigma * 1000 (the scheduler's float32 timesteps) in `dtype`,
    divided by 1000 in `dtype`."""
    t = torch.as_tensor(np.asarray(sigmas, np.float32) * np.float32(1000.0), device=device)
    return t.to(dtype) / 1000


def qwen_apply(model: QwenImageTransformer, img_tokens: torch.Tensor,
               txt_tokens: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor, *,
               mods, attn_impl: str = "plain", kv_len=None) -> torch.Tensor:
    """The flow velocity (B, T_img, out_channels) for packed image tokens
    (B, T_img, in_channels) and text embeddings (B, T_txt, joint_dim).

    rope_cos / rope_sin: (T_img + T_txt, head_dim) tables of ``rope_ids``
    (rotate-half ones for attn_impl="fused"). mods: ``transformer.flux_mods``
    of ``qwen_vec`` at this step. kv_len: None (no padding), or an int32
    (B,) tensor on the device of each sample's key length, T_img plus its
    text's own: the keys past it (the text's padding) are masked. A CUDA
    graph takes it as an input."""
    check_attn_layout(model, attn_impl)
    return model(img_tokens, txt_tokens, rope_cos, rope_sin, attn_impl=attn_impl, kv_len=kv_len,
                 mods=mods)
