"""FLUX-style MM-DiT: 19 double-stream + 38 single-stream blocks.

The port of ``textflux_tpu/models/transformer.py`` (tensor parallelism,
``tp > 1``, is not ported). Parameters live in ``FluxTransformer``, an
``nn.Module`` with one submodule per block (any linear of which may be an
``io.quantize.QuantLinear``); the forward pass is the plain
functions below, mirroring the JAX package's: fused q|k|v projections per
stream, a fused qkv+mlp-in projection (``linear1``) and attn-out+mlp-out
projection (``linear2``) in the single blocks, norms/AdaLN/softmax in float32,
matmuls in the activation dtype.

Attention paths (``attn_impl``):
  "plain": interleaved RoPE and ``ops.attention.plain_attention`` on the
           checkpoint's q/k feature order (the JAX package's "xla");
  "flash": the same RMSNorm and interleaved RoPE, then
           ``ops.attention.dot_product_attention(impl="flash")``: the Hopper
           flash kernels with their hand-written backward (the JAX
           package's "pallas"; the training path);
  "fused": q/k weights half-permuted once at load
           (``half_permute_flux_params``), rotate-half tables, and
           ``flash_attention_qk_norm_rope`` (the Hopper kernel on CUDA; the
           serving path, which has no backward).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from textflux_torch.config import FluxConfig
from textflux_torch.device import resolve_device
from textflux_torch.io.quantize import OUT_AXIS_KEYS
from textflux_torch.models.layers import (
    MLP,
    dense,
    gelu_tanh,
    layer_norm,
    make_linear,
    ones_param,
    rms_norm,
    silu,
    timestep_embedding,
)
from textflux_torch.ops.attention import dot_product_attention
from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope
from textflux_torch.ops.rope import apply_rope_bshd, half_permutation

ATTN_IMPLS = ("plain", "flash", "fused")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        d, m, hd = cfg.hidden_dim, cfg.mlp_dim, cfg.head_dim
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.img_mod = make_linear(d, 6 * d, **kw)
        self.txt_mod = make_linear(d, 6 * d, **kw)
        self.img_qkv = make_linear(d, 3 * d, **kw)
        self.txt_qkv = make_linear(d, 3 * d, **kw)
        self.img_q_scale = ones_param(hd, **pkw)
        self.img_k_scale = ones_param(hd, **pkw)
        self.txt_q_scale = ones_param(hd, **pkw)
        self.txt_k_scale = ones_param(hd, **pkw)
        self.img_proj = make_linear(d, d, **kw)
        self.txt_proj = make_linear(d, d, **kw)
        self.img_mlp = MLP(d, m, d, **kw)
        self.txt_mlp = MLP(d, m, d, **kw)


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        d, m, hd = cfg.hidden_dim, cfg.mlp_dim, cfg.head_dim
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.mod = make_linear(d, 3 * d, **kw)
        self.linear1 = make_linear(d, 3 * d + m, **kw)
        self.q_scale = ones_param(hd, **pkw)
        self.k_scale = ones_param(hd, **pkw)
        self.linear2 = make_linear(d + m, d, **kw)


class FluxTransformer(nn.Module):
    """MM-DiT parameters, initialised with the JAX package's distributions
    (``init_flux_params``) from `generator` (default: seed 0 on `device`).

    ``rope_layout`` records the q/k feature order: "interleaved" as built or
    loaded, "half" after ``half_permute_flux_params``."""

    def __init__(self, cfg: FluxConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, dtype=dtype, generator=generator)
        d = cfg.hidden_dim
        self.cfg = cfg
        self.rope_layout = "interleaved"
        self.img_in = make_linear(cfg.in_channels, d, **kw)
        self.txt_in = make_linear(cfg.joint_dim, d, **kw)
        self.time_in = MLP(cfg.time_embed_channels, d, d, **kw)
        self.vector_in = MLP(cfg.pooled_dim, d, d, **kw)
        self.guidance_in = (MLP(cfg.time_embed_channels, d, d, **kw)
                            if cfg.guidance_embeds else None)
        self.final_mod = make_linear(d, 2 * d, **kw)
        self.final_proj = make_linear(d, cfg.out_channels, **kw)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(cfg, **kw) for _ in range(cfg.num_double_layers))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, **kw) for _ in range(cfg.num_single_layers))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]


def double_block(blk: DoubleBlock, cfg: FluxConfig, txt, img, mods, rope_cos, rope_sin,
                 attn_impl: str, kv_len: Optional[int]):
    """One double-stream block: separate img/txt QKV + MLPs, joint attention.

    mods = (img_mod (B, 6D), txt_mod (B, 6D)) — the block's AdaLN modulation
    vectors (per step, or precomputed for the whole schedule by flux_mods)."""
    n_txt = txt.shape[1]
    img_mod, txt_mod = mods
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = img_mod.chunk(6, dim=-1)
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = txt_mod.chunk(6, dim=-1)

    img_n = _modulate(img, i_shift1, i_scale1)
    txt_n = _modulate(txt, t_shift1, t_scale1)
    iq, ik, iv = dense(blk.img_qkv, img_n).chunk(3, dim=-1)
    tq, tk, tv = dense(blk.txt_qkv, txt_n).chunk(3, dim=-1)
    h, hd = cfg.num_heads, cfg.head_dim

    if attn_impl == "fused":
        # raw q/k: RMSNorm + rotate-half RoPE run inside the attention kernel,
        # with per-row scale tables (txt rows, then img rows)
        q = _heads(torch.cat([tq, iq], dim=1), h)
        k = _heads(torch.cat([tk, ik], dim=1), h)
        v = _heads(torch.cat([tv, iv], dim=1), h)
        n_img = q.shape[1] - n_txt
        qs = torch.cat([blk.txt_q_scale.expand(n_txt, hd), blk.img_q_scale.expand(n_img, hd)])
        ks = torch.cat([blk.txt_k_scale.expand(n_txt, hd), blk.img_k_scale.expand(n_img, hd)])
        out = flash_attention_qk_norm_rope(q, k, v, rope_cos, rope_sin, qs, ks, kv_len=kv_len)
    else:
        iq = rms_norm(_heads(iq, h), blk.img_q_scale)
        ik = rms_norm(_heads(ik, h), blk.img_k_scale)
        tq = rms_norm(_heads(tq, h), blk.txt_q_scale)
        tk = rms_norm(_heads(tk, h), blk.txt_k_scale)
        # text tokens first
        q = apply_rope_bshd(torch.cat([tq, iq], dim=1), rope_cos, rope_sin)
        k = apply_rope_bshd(torch.cat([tk, ik], dim=1), rope_cos, rope_sin)
        v = torch.cat([_heads(tv, h), _heads(iv, h)], dim=1)
        out = dot_product_attention(q, k, v, impl=attn_impl, kv_len=kv_len)

    out = out.reshape(out.shape[0], out.shape[1], -1)
    txt_attn, img_attn = out[:, :n_txt], out[:, n_txt:]

    img = img + i_gate1[:, None] * dense(blk.img_proj, img_attn)
    img_mlp_in = _modulate(img, i_shift2, i_scale2)
    img = img + i_gate2[:, None] * dense(blk.img_mlp.fc2,
                                         gelu_tanh(dense(blk.img_mlp.fc1, img_mlp_in)))

    txt = txt + t_gate1[:, None] * dense(blk.txt_proj, txt_attn)
    txt_mlp_in = _modulate(txt, t_shift2, t_scale2)
    txt = txt + t_gate2[:, None] * dense(blk.txt_mlp.fc2,
                                         gelu_tanh(dense(blk.txt_mlp.fc1, txt_mlp_in)))
    return txt, img


def single_block(blk: SingleBlock, cfg: FluxConfig, x, mod, rope_cos, rope_sin,
                 attn_impl: str, kv_len: Optional[int]):
    """One single-stream block: parallel attention + MLP over the joint sequence.

    mod: (B, 3D) AdaLN modulation vector (see double_block)."""
    d, h = cfg.hidden_dim, cfg.num_heads
    shift, scale, gate = mod.chunk(3, dim=-1)
    x_n = _modulate(x, shift, scale)

    fused = dense(blk.linear1, x_n)
    q, k, v, mlp = fused.split([d, d, d, fused.shape[-1] - 3 * d], dim=-1)
    # q/k/v stay strided views of `fused`; the kernel takes the row stride
    q, k, v = _heads(q, h), _heads(k, h), _heads(v, h)
    if attn_impl == "fused":
        attn = flash_attention_qk_norm_rope(q, k, v, rope_cos, rope_sin,
                                            blk.q_scale, blk.k_scale, kv_len=kv_len)
    else:
        q = apply_rope_bshd(rms_norm(q, blk.q_scale), rope_cos, rope_sin)
        k = apply_rope_bshd(rms_norm(k, blk.k_scale), rope_cos, rope_sin)
        attn = dot_product_attention(q, k, v, impl=attn_impl, kv_len=kv_len)
    attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
    out = dense(blk.linear2, torch.cat([attn, gelu_tanh(mlp)], dim=-1))
    return x + gate[:, None] * out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def flux_vec(model: FluxTransformer, timestep, guidance, pooled, dtype=torch.bfloat16):
    """The AdaLN conditioning vector (B, D) from timestep + guidance + pooled
    CLIP embedding."""
    cfg = model.cfg
    vec = dense(model.time_in.fc2, silu(dense(
        model.time_in.fc1,
        timestep_embedding(timestep * 1000.0, cfg.time_embed_channels).to(dtype))))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("model expects guidance embeddings")
        vec = vec + dense(model.guidance_in.fc2, silu(dense(
            model.guidance_in.fc1,
            timestep_embedding(guidance * 1000.0, cfg.time_embed_channels).to(dtype))))
    vec = vec + dense(model.vector_in.fc2, silu(dense(model.vector_in.fc1, pooled.to(dtype))))
    return vec


def flux_mods(model: FluxTransformer, vec: torch.Tensor):
    """All AdaLN modulation vectors for conditioning vec (N, D).

    The modulation weights are ~27% of the DiT's parameters but their inputs
    depend only on (timestep, guidance, pooled). For a whole denoise schedule,
    call with vec of shape (steps*B, D): every modulation weight is then read
    once per image instead of once per step.

    Returns {"double": [(img (N, 6D), txt (N, 6D)) per block],
             "single": [(N, 3D) per block], "final": (N, 2D)}.
    """
    sv = silu(vec)
    return {
        "double": [(dense(b.img_mod, sv), dense(b.txt_mod, sv)) for b in model.double_blocks],
        "single": [dense(b.mod, sv) for b in model.single_blocks],
        "final": dense(model.final_mod, sv),
    }


def flux_apply(
    model: FluxTransformer,
    img_tokens: torch.Tensor,      # (B, T_img, in_channels)
    txt_tokens: torch.Tensor,      # (B, T_txt, joint_dim)
    pooled: torch.Tensor,          # (B, pooled_dim)
    timestep: torch.Tensor,        # (B,) sigma in [0, 1]
    guidance: Optional[torch.Tensor],  # (B,) guidance scale or None
    rope_cos: torch.Tensor,        # (T_txt + T_img, head_dim)
    rope_sin: torch.Tensor,
    *,
    attn_impl: str = "plain",
    remat: bool = False,
    kv_len: Optional[int] = None,
    mods=None,                     # optional precomputed flux_mods(...) output
) -> torch.Tensor:
    """Predict the flow velocity for packed image tokens. Returns (B, T_img, out_channels).

    remat: checkpoint every block (``torch.utils.checkpoint``, non-reentrant),
    as the JAX package's ``jax.checkpoint`` of its scan bodies: a block keeps
    only its inputs for the backward and runs its forward again there."""
    cfg = model.cfg
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    want = "half" if attn_impl == "fused" else "interleaved"
    if model.rope_layout != want:
        raise ValueError(f"attn_impl={attn_impl!r} needs q/k weights in the {want!r} "
                         f"layout, the model is {model.rope_layout!r} "
                         "(see half_permute_flux_params)")
    n_txt = txt_tokens.shape[1]
    dtype = img_tokens.dtype
    if mods is None:
        # per-block modulation computed as each block runs
        sv = silu(flux_vec(model, timestep, guidance, pooled, dtype))
        double_mods = ((dense(b.img_mod, sv), dense(b.txt_mod, sv)) for b in model.double_blocks)
        single_mods = (dense(b.mod, sv) for b in model.single_blocks)
        final = dense(model.final_mod, sv)
    else:
        double_mods, single_mods, final = mods["double"], mods["single"], mods["final"]

    img = dense(model.img_in, img_tokens)
    txt = dense(model.txt_in, txt_tokens.to(dtype))
    rope_cos, rope_sin = rope_cos.float(), rope_sin.float()

    def call(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    for blk, m in zip(model.double_blocks, double_mods):
        txt, img = call(double_block, blk, cfg, txt, img, m, rope_cos, rope_sin, attn_impl,
                        kv_len)
    x = torch.cat([txt, img], dim=1)
    for blk, m in zip(model.single_blocks, single_mods):
        x = call(single_block, blk, cfg, x, m, rope_cos, rope_sin, attn_impl, kv_len)
    x = x[:, n_txt:]

    # AdaLN-continuous output head: chunk order is (scale, shift)
    scale, shift = final.chunk(2, dim=-1)
    x = layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]
    return dense(model.final_proj, x)


@torch.no_grad()
def half_permute_flux_params(model: FluxTransformer) -> FluxTransformer:
    """Permute q/k feature columns into the rotate-half layout the fused
    attention kernel needs (attn_impl="fused").

    The permutation is a similarity transform on the attention logits (q and
    k permuted identically), so outputs are unchanged; it folds the
    interleaved RoPE pairing into the weights once at load time. v and all
    other parameters are untouched. Every output-axis tensor of the fused
    projections is gathered: the weight and bias of an ``nn.Linear``, every
    buffer of a ``QuantLinear`` (``io.quantize.OUT_AXIS_KEYS``: the NF4 codes
    pack along the input axis and their absmax groups it, so the output
    rows move whole), and a parallel LoRA's B along its last axis (A acts on
    the input and stays). Grouped LoRA factors, or a tensor of unknown
    layout, raise. Unlike the JAX package, which returns a new tree, this
    permutes the module IN PLACE (a copy of the 12B DiT would not fit beside
    it) and returns it."""
    if model.rope_layout != "interleaved":
        raise ValueError(f"model is already in the {model.rope_layout!r} layout")
    cfg = model.cfg
    d = cfg.hidden_dim
    perm = half_permutation(cfg.head_dim)
    per_head = np.concatenate([h * cfg.head_dim + perm for h in range(cfg.num_heads)])

    def permute_rows(lin: nn.Module, extra: int = 0) -> None:
        idx = torch.as_tensor(np.concatenate([per_head, d + per_head,
                                              2 * d + np.arange(d + extra)]))
        tensors = list(lin.named_parameters(recurse=False)) + list(
            lin.named_buffers(recurse=False))
        for name, t in tensors:
            if name in OUT_AXIS_KEYS:
                t.copy_(t.index_select(0, idx.to(t.device)))
            elif name == "lora_b":
                t.copy_(t.index_select(-1, idx.to(t.device)))
            elif name in ("lora_ga", "lora_gb"):
                raise ValueError(
                    "grouped per-module LoRA factors cannot be permuted for the fused "
                    "kernel: fold them first (training.train.lora_merge or io.lora's "
                    "load-time folding)")
            elif name != "lora_a":   # never drop one silently
                raise KeyError(f"unknown tensor {name!r} of a fused projection in "
                               "half_permute_flux_params: add it to io.quantize."
                               "OUT_AXIS_KEYS (output axis first) or handle it here")

    p = torch.as_tensor(perm)
    for blk in model.double_blocks:
        permute_rows(blk.img_qkv)
        permute_rows(blk.txt_qkv)
        for prm in (blk.img_q_scale, blk.img_k_scale, blk.txt_q_scale, blk.txt_k_scale):
            prm.copy_(prm[p.to(prm.device)])
    for blk in model.single_blocks:
        permute_rows(blk.linear1, extra=cfg.mlp_dim)
        for prm in (blk.q_scale, blk.k_scale):
            prm.copy_(prm[p.to(prm.device)])
    model.rope_layout = "half"
    return model
