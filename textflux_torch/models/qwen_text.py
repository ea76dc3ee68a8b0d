"""The language model of Qwen2.5-VL-7B-Instruct, run as Qwen-Image's text encoder.

From ``transformers``' ``Qwen2_5_VLTextModel`` (not imported here): token
embedding, then per layer a pre-RMSNorm (float32 variance, eps 1e-6)
causal grouped-query attention (q/k/v with bias, o without; 28 query heads
over 4 key/value heads of 128) with rotate-half RoPE at theta 1e6, and a
pre-RMSNorm SwiGLU MLP (down(silu(gate x) * up x)); the final RMSNorm's
output is the embedding. For a text prompt Qwen2.5-VL's M-RoPE gives its
three sections one position each, the token's index, so it is this
one-axis RoPE. The vision tower is not held: prompts are text alone.

Products run in the activation dtype, norms and the RoPE rotation in
float32, the attention's logits and softmax in float32 with the
probabilities rounded to v's dtype, as ``ops.attention.plain_attention``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from textflux_torch.config import QwenTextConfig
from textflux_torch.device import resolve_device
from textflux_torch.models.layers import dense, make_linear, ones_param, rms_norm, silu


class QwenTextLayer(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **kw):
        super().__init__()
        d, hd = cfg.hidden_dim, cfg.head_dim
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.attn_norm = ones_param(d, **pkw)
        self.q = make_linear(d, cfg.num_heads * hd, **kw)
        self.k = make_linear(d, cfg.num_kv_heads * hd, **kw)
        self.v = make_linear(d, cfg.num_kv_heads * hd, **kw)
        self.o = make_linear(cfg.num_heads * hd, d, bias=False, **kw)
        self.mlp_norm = ones_param(d, **pkw)
        self.gate = make_linear(d, cfg.mlp_dim, bias=False, **kw)
        self.up = make_linear(d, cfg.mlp_dim, bias=False, **kw)
        self.down = make_linear(cfg.mlp_dim, d, bias=False, **kw)


class QwenTextEncoder(nn.Module):
    """Qwen2.5 language-model parameters, initialised from `generator`
    (default: seed 0 on `device`)."""

    def __init__(self, cfg: QwenTextConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.hidden_dim, generator=generator, device=device,
                        dtype=dtype) * 0.02)
        self.layers = nn.ModuleList(QwenTextLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = ones_param(cfg.hidden_dim, device=device, dtype=dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float, device) -> tuple:
    """(cos, sin), float32 (S, head_dim): rotate-half tables of positions
    0..S-1, angles in float64."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    ang = torch.outer(torch.arange(seq_len, dtype=torch.float64), inv)
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on (B, S, H, D) in float32, cast back."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[None, :, None] + rotated * sin[None, :, None]).to(x.dtype)


def qwen_encode(model: QwenTextEncoder, input_ids: torch.Tensor, *,
                dtype=torch.bfloat16) -> torch.Tensor:
    """The final RMSNorm's output (B, S, hidden) over the causal model of
    `input_ids` (B, S), in `dtype`."""
    cfg = model.cfg
    b, s = input_ids.shape
    nh, nkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_norm_eps
    h = model.embed_tokens[input_ids].to(dtype)
    cos, sin = rope_tables(s, hd, cfg.rope_theta, h.device)
    causal = torch.full((s, s), float("-inf"), device=h.device).triu(1)
    for p in model.layers:
        y = rms_norm(h, p.attn_norm, eps)
        q = _rope(dense(p.q, y).reshape(b, s, nh, hd), cos, sin)
        k = _rope(dense(p.k, y).reshape(b, s, nkv, hd), cos, sin)
        v = dense(p.v, y).reshape(b, s, nkv, hd)
        # each key/value head serves nh / nkv query heads
        k, v = (t.repeat_interleave(nh // nkv, dim=2) for t in (k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
        probs = torch.softmax(logits + causal, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(h.dtype)
        h = h + dense(p.o, attn.reshape(b, s, -1))
        y = rms_norm(h, p.mlp_norm, eps)
        h = h + dense(p.down, silu(dense(p.gate, y)) * dense(p.up, y))
    return rms_norm(h, model.final_norm, eps)
