"""CLIP-L/14 text encoder — provides the pooled prompt embedding.

The port of ``textflux_tpu/models/clip.py``: token + learned position
embeddings, causal self-attention, quick-gelu MLPs, final LayerNorm, pooled
output at the first EOS token (or at argmax(input_ids) for legacy configs
with ``eos_token_id=2``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from textflux_torch.config import CLIPTextConfig
from textflux_torch.device import resolve_device
from textflux_torch.models.layers import dense, make_linear, quick_gelu


class AffineLayerNorm(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))


def _affine_ln(x: torch.Tensor, p: AffineLayerNorm, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p.scale.float() + p.bias.float()).to(x.dtype)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        d = cfg.hidden_dim
        nkw = {k: kw[k] for k in ("device", "dtype")}
        self.ln1 = AffineLayerNorm(d, **nkw)
        self.q = make_linear(d, d, **kw)
        self.k = make_linear(d, d, **kw)
        self.v = make_linear(d, d, **kw)
        self.o = make_linear(d, d, **kw)
        self.ln2 = AffineLayerNorm(d, **nkw)
        self.fc1 = make_linear(d, cfg.mlp_dim, **kw)
        self.fc2 = make_linear(cfg.mlp_dim, d, **kw)


class CLIPTextModel(nn.Module):
    """CLIP text-encoder parameters (the JAX package's init_clip_params
    distributions), initialised from `generator` (default: seed 0)."""

    def __init__(self, cfg: CLIPTextConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.token_embedding = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.hidden_dim, generator=generator, device=device,
                        dtype=dtype) * 0.02)
        self.position_embedding = nn.Parameter(
            torch.randn(cfg.max_positions, cfg.hidden_dim, generator=generator,
                        device=device, dtype=dtype) * 0.02)
        self.layers = nn.ModuleList(CLIPLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_ln = AffineLayerNorm(cfg.hidden_dim, device=device, dtype=dtype)


def clip_encode(clip: CLIPTextModel, input_ids: torch.Tensor, *, dtype=torch.float32):
    """Returns (last_hidden_state (B,S,D), pooled (B,D))."""
    cfg = clip.cfg
    b, s = input_ids.shape
    h = clip.token_embedding[input_ids].to(dtype)
    h = h + clip.position_embedding[:s].to(dtype)
    nh = cfg.num_heads
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=h.device))
    for p in clip.layers:
        y = _affine_ln(h, p.ln1, cfg.layer_norm_eps)
        q = dense(p.q, y).reshape(b, s, nh, -1)
        k = dense(p.k, y).reshape(b, s, nh, -1)
        v = dense(p.v, y).reshape(b, s, nh, -1)
        scale = 1.0 / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        logits = torch.where(causal[None, None], logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(h.dtype)
        h = h + dense(p.o, attn.reshape(b, s, -1))
        y = _affine_ln(h, p.ln2, cfg.layer_norm_eps)
        h = h + dense(p.fc2, quick_gelu(dense(p.fc1, y)))
    h = _affine_ln(h, clip.final_ln, cfg.layer_norm_eps)

    if cfg.eos_token_id == 2:
        # Legacy configs (the stock FLUX text_encoder ships eos_token_id=2,
        # the historically wrong value): the reference pools at
        # argmax(input_ids), the EOT position, because EOT=49407 is the
        # largest id in the CLIP vocab. Matching id == 2 would find nothing
        # and silently pool the BOS hidden state instead.
        eos_pos = torch.argmax(input_ids, dim=-1)
    else:
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=-1)
    pooled = h[torch.arange(b, device=h.device), eos_pos]
    return h, pooled
