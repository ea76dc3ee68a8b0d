"""T5 v1.1 encoder (XXL in production) — provides the sequence prompt embedding.

The port of ``textflux_tpu/models/t5.py``: pre-norm blocks with RMSNorm,
bias-free projections, unscaled attention logits plus a learned
relative-position bias (computed once, shared by all layers), and gated-GELU
MLPs.

UMT5 (Wan's text encoder) is the same encoder with one relative-position
bias per layer (``T5Config.shared_pos`` False): each layer then holds its
own ``rel_bias`` and adds its own bias to its logits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from textflux_torch.config import T5Config
from textflux_torch.device import resolve_device
from textflux_torch.models.layers import dense, gelu_tanh, make_linear, ones_param, rms_norm


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.attn_norm = ones_param(d, **pkw)
        self.q = make_linear(d, inner, bias=False, **kw)
        self.k = make_linear(d, inner, bias=False, **kw)
        self.v = make_linear(d, inner, bias=False, **kw)
        self.o = make_linear(inner, d, bias=False, **kw)
        self.mlp_norm = ones_param(d, **pkw)
        self.wi_0 = make_linear(d, cfg.d_ff, bias=False, **kw)
        self.wi_1 = make_linear(d, cfg.d_ff, bias=False, **kw)
        self.wo = make_linear(cfg.d_ff, d, bias=False, **kw)
        if not cfg.shared_pos:
            self.rel_bias = _rel_bias_param(cfg, **kw)


def _rel_bias_param(cfg: T5Config, *, device, dtype, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads,
                                    generator=generator, device=device, dtype=dtype) * 0.02)


class T5Encoder(nn.Module):
    """T5 encoder parameters (the JAX package's init_t5_params distributions),
    initialised from `generator` (default: seed 0)."""

    def __init__(self, cfg: T5Config, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.randn(cfg.vocab_size, cfg.d_model,
                                                  generator=generator, device=device,
                                                  dtype=dtype))
        if cfg.shared_pos:
            self.rel_bias = _rel_bias_param(cfg, **kw)
        self.layers = nn.ModuleList(T5Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = ones_param(cfg.d_model, device=device, dtype=dtype)


def relative_position_buckets(seq_len: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing, (S, S) int64."""
    pos = torch.arange(seq_len, device=device)
    rel = pos[None, :] - pos[:, None]           # memory - query
    nb = num_buckets // 2
    bucket = torch.where(rel > 0, nb, 0)
    rel = torch.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    # float32 throughout, as the JAX package computes it
    log_ratio = (torch.log(rel.float() / max_exact + 1e-9)
                 / torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32,
                                          device=device)))
    large = max_exact + (log_ratio * (nb - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return bucket + torch.where(is_small, rel, large.to(rel.dtype))


def t5_encode(t5: T5Encoder, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None, *,
              dtype=torch.float32) -> torch.Tensor:
    """Returns last_hidden_state (B, S, d_model)."""
    cfg = t5.cfg
    b, s = input_ids.shape
    h = t5.embedding[input_ids].to(dtype)
    buckets = relative_position_buckets(s, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance, h.device)
    keep = None if attention_mask is None else attention_mask[:, None, None, :].to(torch.bool)

    def bias_of(table):
        bias = table.float()[buckets].permute(2, 0, 1)[None]   # (1, H, S, S)
        return bias if keep is None else torch.where(keep, bias, torch.full_like(bias, -1e9))

    pos_bias = bias_of(t5.rel_bias) if cfg.shared_pos else None
    nh = cfg.num_heads
    for p in t5.layers:
        if not cfg.shared_pos:
            pos_bias = bias_of(p.rel_bias)
        y = rms_norm(h, p.attn_norm, cfg.layer_norm_eps)
        q = dense(p.q, y).reshape(b, s, nh, -1)
        k = dense(p.k, y).reshape(b, s, nh, -1)
        v = dense(p.v, y).reshape(b, s, nh, -1)
        # T5: no 1/sqrt(d) scaling; additive relative bias
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits + pos_bias, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(h.dtype)
        h = h + dense(p.o, attn.reshape(b, s, -1))
        y = rms_norm(h, p.mlp_norm, cfg.layer_norm_eps)
        h = h + dense(p.wo, gelu_tanh(dense(p.wi_0, y)) * dense(p.wi_1, y))
    return rms_norm(h, t5.final_norm, cfg.layer_norm_eps)
