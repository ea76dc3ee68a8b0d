"""Wan2.1-VACE's DiT: video self-attention, cross-attention to the text, and
the VACE branch that writes hints into the residual stream.

``WanVACETransformer`` holds diffusers' ``WanVACETransformer3DModel`` in the
port's layout: q|k|v of the self-attention fused into one linear and k|v of
the cross-attention into another (``io.params.wan_vace_key_map`` loads the
checkpoint's separate ones into them); the 3-D patch embeddings keep the
checkpoint's (D, C, 1, 2, 2) convolution weights. A forward, on NTHWC
latents (B, T', h, w, 16), the NTHWC control (B, T', h, w, 96: the inactive
and reactive latents and the 64 mask channels) and the text (B, 512, 4096):

* tokens: 1 x 2 x 2 patches in (t, h, w) order, each patch's features in
  the convolution's (C, 1, 2, 2) order, through ``patch_embed`` (the
  control through ``vace_patch_embed``); the text through ``text_in``
  (linear, GELU-tanh, linear) on all 512 rows, its zero padding included;
* modulation: ``wan_mods`` from the timestep alone, once per image for
  every step: temb = ``time_in`` of the sinusoid of 1000 sigma ([cos |
  sin]), e0 = ``time_proj`` of silu(temb); each block's six vectors are
  its learned ``modulation`` table plus e0 (shift, scale, gate, shift2,
  scale2, gate2), the head's two its ``head_mod`` plus temb (shift,
  scale), summed in float32 and rounded to the activation dtype;
* a block (``wan_block``): x += gate * SelfAttn(AdaLN(x)); x +=
  CrossAttn(LN_affine(x), text); x += gate2 * FFN(AdaLN2(x)). Both
  attentions RMS-norm q and k across the token's heads with (H*D,)
  weights; the self-attention adds 3-axis interleaved RoPE over (frame,
  row, column) ids; q/k/v/o all have biases (``models.transformer``'s
  ``wan_attention`` runs them);
* the VACE branch runs first (``_vace``): block 0 begins c = proj_in(c) +
  x, and every branch block ends with the hint proj_out(c); after main
  block ``vace_layers[i]`` the stream takes x += hint_i * 1.0;
* the head: AdaLN with the head's vectors, ``head`` to 64 features per
  token, which unpatchify in (1, 2, 2, C) order back to NTHWC.

A serving call (CUDA, gradients off, modulation vectors given) runs from
the module's ``ForwardGraphs``, keyed by the inputs' shapes: the canvas
and its frames (the text is always 512 rows), so the prompt's and the
negative's forwards of a step replay one graph. ``_forward`` also takes
`taps`, which keeps, for the blocks it names, the block's inputs and the
output of each of its parts (an eager forward only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.config import WanVACEConfig
from textflux_torch.models.graphs import key_of
from textflux_torch.models.layers import (MLP, dense, gelu_tanh, make_linear, ones_param, silu,
                                          timestep_embedding)
from textflux_torch.models.transformer import (_graphed, _modulate, check_attn_layout, dit_init,
                                               wan_attention)
from textflux_torch.utils.tracking import span

TIMESTEP_SCALE = 1000.0
HINT_SCALE = 1.0


def _patch_param(c_out: int, c_in: int, patch, *, device, dtype, generator) -> nn.Module:
    """A 3-D patch embedding's convolution weight (c_out, c_in, *patch) and
    bias, uniform in [-1/sqrt(fan_in), +] and zero."""
    fan_in = c_in * int(np.prod(patch))
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty((c_out, c_in, *patch), device=device, dtype=dtype))
    m.bias = nn.Parameter(torch.zeros(c_out, device=device, dtype=dtype))
    if device.type != "meta":
        with torch.no_grad():
            m.weight.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=generator)
    return m


def _table(rows: int, d: int, *, device, dtype, generator) -> nn.Parameter:
    t = torch.empty((rows, d), device=device, dtype=dtype)
    if device.type != "meta":
        t.uniform_(-d ** -0.5, d ** -0.5, generator=generator)
    return nn.Parameter(t)


class AffineNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.weight = ones_param(d, device=device, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))


class WanBlock(nn.Module):
    """One block's parameters (module docstring); a branch block adds
    ``proj_out`` and, the first, ``proj_in``."""

    def __init__(self, cfg: WanVACEConfig, *, vace: int = -1, **kw):
        super().__init__()
        d = cfg.hidden_dim
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.num_heads, self.eps = cfg.num_heads, cfg.eps
        self.modulation = _table(6, d, **kw)
        self.self_qkv = make_linear(d, 3 * d, **kw)
        self.self_q_scale = ones_param(d, **pkw)
        self.self_k_scale = ones_param(d, **pkw)
        self.self_o = make_linear(d, d, **kw)
        self.cross_norm = AffineNorm(d, **pkw)
        self.cross_q = make_linear(d, d, **kw)
        self.cross_kv = make_linear(d, 2 * d, **kw)
        self.cross_q_scale = ones_param(d, **pkw)
        self.cross_k_scale = ones_param(d, **pkw)
        self.cross_o = make_linear(d, d, **kw)
        self.ffn = MLP(d, cfg.ffn_dim, d, **kw)
        if vace == 0:
            self.proj_in = make_linear(d, d, **kw)
        if vace >= 0:
            self.proj_out = make_linear(d, d, **kw)


class WanVACETransformer(nn.Module):
    """Wan2.1-VACE DiT parameters, initialised from `generator` (default:
    seed 0 on `device`); its ``fused_layout`` is "interleaved", the
    checkpoint's q/k order, which the across-heads kernels read, so
    ``transformer.to_attn_layout`` leaves it as it is."""

    def __init__(self, cfg: WanVACEConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dit_init(self, cfg, device, dtype, generator, fused_layout="interleaved")
        d = cfg.hidden_dim
        self.patch_embed = _patch_param(d, cfg.in_channels, cfg.patch_size, **kw)
        self.vace_patch_embed = _patch_param(d, cfg.vace_in_channels, cfg.patch_size, **kw)
        self.time_in = MLP(cfg.freq_dim, d, d, **kw)
        self.time_proj = make_linear(d, 6 * d, **kw)
        self.text_in = MLP(cfg.text_dim, d, d, **kw)
        self.head_mod = _table(2, d, **kw)
        self.head = make_linear(d, cfg.out_channels * cfg.patch_dim, **kw)
        self.blocks = nn.ModuleList(WanBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.vace_blocks = nn.ModuleList(WanBlock(cfg, vace=i, **kw)
                                         for i in range(len(cfg.vace_layers)))
        self.vace_hints = 0     # hints added to the main stream (eager and captured forwards)

    def forward(self, latents, control, text, rope_cos, rope_sin, *, attn_impl: str,
                mods) -> torch.Tensor:
        """The flow velocity, NTHWC (B, T', h, w, 16), for NTHWC latents, the
        control (B, T', h, w, 96) and the text (B, 512, text_dim). rope_cos /
        rope_sin: (S, head_dim) interleaved tables of ``rope_ids``. mods:
        ``step_mods`` of ``wan_mods`` at this step. A serving call replays
        the module's graph for its key (module docstring)."""
        check_attn_layout(self, attn_impl)
        args = dict(latents=latents, control=control, text=text, rope_cos=rope_cos,
                    rope_sin=rope_sin)
        if not _graphed(latents, remat=False, mods=mods, mesh=None):
            return self._forward(**args, attn_impl=attn_impl, mods=mods)
        names = list(args)
        inputs = [args[k] for k in names] + _flat_mods(mods)
        n, n_blocks = len(names), len(self.blocks)
        return self.graphs.run(
            key_of(inputs, dict(attn_impl=attn_impl)), self.graphs.signature(self),
            lambda xs: self._forward(**dict(zip(names, xs)), attn_impl=attn_impl,
                                     mods=_unflat_mods(xs[n:], n_blocks)), inputs)

    def _forward(self, latents, control, text, rope_cos, rope_sin, *, attn_impl: str, mods,
                 taps: Optional[dict] = None):
        """The forward (module docstring). `taps`, when given, is a dict
        {"blocks": {i: {}}, "vace": {j: {}}} whose named blocks' dicts are
        filled (``wan_block``), with "first" (x, c, text after their
        embedders) and "last" (the stream before the head)."""
        dtype = latents.dtype
        x = dense(_as_linear(self.patch_embed), patchify(latents, self.cfg.patch_size))
        c = dense(_as_linear(self.vace_patch_embed), patchify(control.to(dtype),
                                                              self.cfg.patch_size))
        txt = dense(self.text_in.fc2, gelu_tanh(dense(self.text_in.fc1, text.to(dtype))))
        rope = (rope_cos.float(), rope_sin.float())
        if taps is not None:
            taps["first"] = (x, c, txt)
        hints = self._vace(x, c, txt, rope, attn_impl, mods["vace"], taps)
        where = {layer: i for i, layer in enumerate(self.cfg.vace_layers)}
        for i, (blk, m) in enumerate(zip(self.blocks, mods["blocks"])):
            tap = None if taps is None else taps["blocks"].get(i)
            x = wan_block(blk, x, txt, m, rope, attn_impl, tap)
            if i in where:
                x = x + hints[where[i]] * HINT_SCALE
                self.vace_hints += 1
                if tap is not None:
                    tap["hinted"] = x
        if taps is not None:
            taps["last"] = x
        shift, scale = mods["head"].unbind(1)
        out = dense(self.head, _modulate(x, shift, scale))
        return unpatchify(out, latents.shape, self.cfg.patch_size)

    def _vace(self, x, c, txt, rope, attn_impl: str, mods, taps=None) -> list:
        """The VACE branch: its hints, one per branch block."""
        hints = []
        with span("wan.vace"):
            for j, (blk, m) in enumerate(zip(self.vace_blocks, mods)):
                tap = None if taps is None else taps["vace"].get(j)
                if j == 0:
                    if tap is not None:
                        tap["proj_in_in"] = c
                    c = dense(blk.proj_in, c) + x
                c = wan_block(blk, c, txt, m, rope, attn_impl, tap)
                hints.append(dense(blk.proj_out, c))
                if tap is not None:
                    tap["hint"] = hints[-1]
        return hints


def _as_linear(p: nn.Module) -> nn.Module:
    """A patch embedding as the linear over a patch's flattened (C, 1, 2, 2)
    features: its weight viewed (D, C * 4)."""
    lin = nn.Module()
    lin.weight, lin.bias = p.weight.flatten(1), p.bias
    return lin


def patchify(x: torch.Tensor, patch) -> torch.Tensor:
    """NTHWC (B, T, H, W, C) -> tokens (B, T/pt * H/ph * W/pw, C*pt*ph*pw),
    tokens in (t, h, w) order, each patch's features in (C, pt, ph, pw)
    order (a 3-D convolution's)."""
    b, t, h, w, c = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, t // pt, pt, h // ph, ph, w // pw, pw, c)
    return x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, -1, c * pt * ph * pw)


def unpatchify(tokens: torch.Tensor, shape, patch) -> torch.Tensor:
    """The head's tokens (B, S, pt*ph*pw*C), features in (pt, ph, pw, C)
    order, back to NTHWC `shape`."""
    b, t, h, w, c = shape
    pt, ph, pw = patch
    x = tokens.reshape(b, t // pt, h // ph, w // pw, pt, ph, pw, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t, h, w, c)


def _affine_ln(p: AffineNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with weight and bias, float32 inside, one rounding to x's
    dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p.weight.float(), p.bias.float(),
                        eps).to(x.dtype)


def wan_block(blk: WanBlock, x, txt, mod, rope, attn_impl: str, tap: Optional[dict] = None):
    """One block (module docstring) on the stream x (B, S, D) with the
    text `txt` (B, L, D), its modulation `mod` (B, 6, D) and the RoPE
    tables `rope`. `tap`, when given, keeps: mods, in, self (the
    self-attention branch out of its projection), mid1 (the stream after
    it), cross (the cross-attention branch), mid2, ffn (the FFN's output)
    and out."""
    heads, eps = blk.num_heads, blk.eps
    with span("wan.block"):
        shift, scale, gate, shift2, scale2, gate2 = mod.unbind(1)
        q, k, v = dense(blk.self_qkv, _modulate(x, shift, scale)).chunk(3, dim=-1)
        a = wan_attention(*(_split(t, heads) for t in (q, k, v)), blk.self_q_scale,
                          blk.self_k_scale, attn_impl, rope=rope)
        a = dense(blk.self_o, a.flatten(2))
        x1 = x + gate[:, None] * a
        q = dense(blk.cross_q, _affine_ln(blk.cross_norm, x1, eps))
        k, v = dense(blk.cross_kv, txt).chunk(2, dim=-1)
        ca = wan_attention(*(_split(t, heads) for t in (q, k, v)), blk.cross_q_scale,
                           blk.cross_k_scale, attn_impl)
        ca = dense(blk.cross_o, ca.flatten(2))
        x2 = x1 + ca
        f = dense(blk.ffn.fc2, gelu_tanh(dense(blk.ffn.fc1, _modulate(x2, shift2, scale2))))
        out = x2 + gate2[:, None] * f
    if tap is not None:
        tap.update(mods=mod, **{"in": x}, self=a, mid1=x1, cross=ca, mid2=x2, ffn=f, out=out)
    return out


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, heads, -1)


def _flat_mods(mods) -> list:
    return list(mods["vace"]) + list(mods["blocks"]) + [mods["head"]]


def _unflat_mods(flat, n_blocks: int) -> dict:
    n_vace = len(flat) - n_blocks - 1
    return {"vace": list(flat[:n_vace]), "blocks": list(flat[n_vace:n_vace + n_blocks]),
            "head": flat[-1]}


def wan_temb(model: WanVACETransformer, sigmas, dtype=torch.bfloat16, device=None):
    """temb (N, D) for float32 sigmas (N,): ``time_in`` of the [cos | sin]
    sinusoid of the scheduler's float32 timesteps 1000 sigma, in `dtype`."""
    t = torch.as_tensor(np.asarray(sigmas, np.float32) * np.float32(TIMESTEP_SCALE),
                        device=device)
    emb = timestep_embedding(t, model.cfg.freq_dim).to(dtype)
    return dense(model.time_in.fc2, silu(dense(model.time_in.fc1, emb)))


def wan_mods(model: WanVACETransformer, temb: torch.Tensor) -> dict:
    """Every block's (N, 6, D) modulation vectors and the head's (N, 2, D)
    for temb (N, D) (module docstring): {"vace": [...], "blocks": [...],
    "head": ...}, each a table plus e0 (or temb) in float32, rounded to
    temb's dtype."""
    n, d = temb.shape
    e0 = dense(model.time_proj, silu(temb)).float().reshape(n, 6, d)

    def plus(table, e):
        return (table.float()[None] + e).to(temb.dtype)

    return {"vace": [plus(b.modulation, e0) for b in model.vace_blocks],
            "blocks": [plus(b.modulation, e0) for b in model.blocks],
            "head": plus(model.head_mod, temb.float()[:, None])}


def step_mods(mods_all: dict, i: int, b: int) -> dict:
    """Step `i`'s `b` rows of ``wan_mods`` over (steps * b) rows."""
    rows = slice(i * b, (i + 1) * b)
    return {"vace": [m[rows] for m in mods_all["vace"]],
            "blocks": [m[rows] for m in mods_all["blocks"]], "head": mods_all["head"][rows]}


def rope_ids(frames: int, grid_h: int, grid_w: int) -> np.ndarray:
    """(frames * grid_h * grid_w, 3) RoPE ids of the tokens in (t, h, w)
    order: (frame, row, column), each from 0."""
    f, r, c = np.meshgrid(np.arange(frames), np.arange(grid_h), np.arange(grid_w),
                          indexing="ij")
    return np.stack([f, r, c], -1).reshape(-1, 3).astype(np.float64)
