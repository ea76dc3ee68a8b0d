"""The plain float32 reference of FLUX.1-Fill-dev, T5-XXL, CLIP-L and the FLUX VAE.

Plain PyTorch, written from the published architectures (diffusers'
``FluxTransformer2DModel``, ``T5EncoderModel``, ``CLIPTextModel``,
``AutoencoderKL``) in the layout of the program's parameters, so that one
state dict of names fills both sides. Every product runs in float32 with
TF32 off; attention is an explicit softmax. Nothing here imports the program.

A rounding says how each linear's (and convolution's) weight and input are
rounded before the float32 product: "fp32" (none), "int8w" (int8 codes per
output channel, the weight-only int8 deployment), and the controls "fp8"
(e4m3 weights per output channel, e4m3 inputs) and "int4w" (int4 codes per
output channel).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0
TIMESTEP_DTYPE = torch.bfloat16   # the configurations' dtype


def _lin(d_in, d_out, bias=True):
    return nn.Linear(d_in, d_out, bias=bias, device="meta")


def _vec(n):
    return nn.Parameter(torch.empty(n, device="meta"))


# ---------------------------------------------------------------------------
# rounding of a linear's operands
# ---------------------------------------------------------------------------

def quantize_rows(w: torch.Tensor, levels: int) -> torch.Tensor:
    """Symmetric per-output-channel codes in [-levels, levels], dequantised."""
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / levels
    return torch.clamp(torch.round(w / scale[:, None]), -levels, levels) * scale[:, None]


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale per row (the last axis is the row)."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_tensor(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale for the whole tensor."""
    scale = torch.clamp(x.abs().amax(), min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_weights(module: nn.Module, precision: str) -> None:
    """Round every linear and convolution weight of `module` in place for
    `precision` (one scale per output channel); under "fp8" their inputs
    are rounded too, per token for a linear, per tensor for a convolution."""
    levels = {"int8w": 127, "int4w": 7}.get(precision)
    if precision == "fp32":
        return
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight.data.reshape(m.weight.shape[0], -1)
            w = fp8_rows(w) if precision == "fp8" else quantize_rows(w, levels)
            m.weight.data = w.reshape(m.weight.shape)
            m.fp8_inputs = precision == "fp8"


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    if getattr(lin, "fp8_inputs", False):
        x = fp8_rows(x)
    return F.linear(x, lin.weight, lin.bias)


def conv(c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return c(fp8_tensor(x) if getattr(c, "fp8_inputs", False) else x)


def rms_norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def attention(q, k, v, scale):
    """(B, S, H, D) -> (B, S, H*D), softmax in float32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def timestep_embedding(t, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# FLUX.1-Fill MM-DiT
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_in, d_hidden, d_out):
        super().__init__()
        self.fc1, self.fc2 = _lin(d_in, d_hidden), _lin(d_hidden, d_out)


class DoubleBlock(nn.Module):
    def __init__(self, d, m, hd):
        super().__init__()
        self.img_mod, self.txt_mod = _lin(d, 6 * d), _lin(d, 6 * d)
        self.img_qkv, self.txt_qkv = _lin(d, 3 * d), _lin(d, 3 * d)
        self.img_q_scale, self.img_k_scale = _vec(hd), _vec(hd)
        self.txt_q_scale, self.txt_k_scale = _vec(hd), _vec(hd)
        self.img_proj, self.txt_proj = _lin(d, d), _lin(d, d)
        self.img_mlp, self.txt_mlp = MLP(d, m, d), MLP(d, m, d)


class SingleBlock(nn.Module):
    def __init__(self, d, m, hd):
        super().__init__()
        self.mod = _lin(d, 3 * d)
        self.linear1 = _lin(d, 3 * d + m)
        self.q_scale, self.k_scale = _vec(hd), _vec(hd)
        self.linear2 = _lin(d + m, d)


class Flux(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        m, hd = int(d * cfg["mlp_ratio"]), cfg["attention_head_dim"]
        self.cfg = cfg
        self.img_in = _lin(cfg["in_channels"], d)
        self.txt_in = _lin(cfg["joint_attention_dim"], d)
        self.time_in = MLP(256, d, d)
        self.vector_in = MLP(cfg["pooled_projection_dim"], d, d)
        self.guidance_in = MLP(256, d, d)
        self.final_mod = _lin(d, 2 * d)
        self.final_proj = _lin(d, cfg["out_channels"])
        self.double_blocks = nn.ModuleList(DoubleBlock(d, m, hd)
                                           for _ in range(cfg["num_layers"]))
        self.single_blocks = nn.ModuleList(SingleBlock(d, m, hd)
                                           for _ in range(cfg["num_single_layers"]))


def rope_tables(ids, axes_dims, theta=10000):
    """Interleaved 3-axis RoPE tables (S, D), angles in float64."""
    ids = ids.to(torch.float64)
    cos, sin = [], []
    for axis, dim in enumerate(axes_dims):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                             device=ids.device) / dim)
        ang = torch.outer(ids[:, axis], freqs)
        cos.append(torch.cos(ang).repeat_interleave(2, dim=1))
        sin.append(torch.sin(ang).repeat_interleave(2, dim=1))
    return torch.cat(cos, -1).float(), torch.cat(sin, -1).float()


def apply_rope(x, cos, sin):
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * cos[None, :, None] + rotated * sin[None, :, None]


def image_ids(lat_h, lat_w, device):
    h2, w2 = lat_h // 2, lat_w // 2
    ids = torch.zeros(h2, w2, 3, dtype=torch.float64, device=device)
    ids[..., 1] = torch.arange(h2, device=device)[:, None]
    ids[..., 2] = torch.arange(w2, device=device)[None, :]
    return ids.reshape(-1, 3)


def _modulate(x, shift, scale):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def flux_velocity(model: Flux, img_tokens, txt_tokens, pooled, sigma, guidance, lat_h, lat_w):
    """The velocity (B, T_img, out_channels) for packed image tokens."""
    cfg = model.cfg
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    dev = img_tokens.device
    b, n_txt = img_tokens.shape[0], txt_tokens.shape[1]
    ids = torch.cat([torch.zeros(n_txt, 3, dtype=torch.float64, device=dev),
                     image_ids(lat_h, lat_w, dev)])
    cos, sin = rope_tables(ids, cfg["axes_dims_rope"])
    # the timestep reaches the model in its dtype and is scaled there, as
    # the published pipeline hands it over; the guidance stays float32
    t = torch.full((b,), float(sigma), device=dev, dtype=TIMESTEP_DTYPE) * 1000.0
    g = torch.full((b,), float(guidance), device=dev) * 1000.0

    def mlp(p, x):
        return dense(p.fc2, F.silu(dense(p.fc1, x)))

    vec = (mlp(model.time_in, timestep_embedding(t.float(), 256))
           + mlp(model.guidance_in, timestep_embedding(g, 256))
           + mlp(model.vector_in, pooled))
    sv = F.silu(vec)
    img, txt = dense(model.img_in, img_tokens), dense(model.txt_in, txt_tokens)

    def qkv(lin, x, qs, ks):
        q, k, v = dense(lin, x).reshape(b, x.shape[1], 3, heads, hd).unbind(2)
        return rms_norm(q, qs), rms_norm(k, ks), v

    for blk in model.double_blocks:
        i1, i2, i3, i4, i5, i6 = dense(blk.img_mod, sv).chunk(6, -1)
        t1, t2, t3, t4, t5, t6 = dense(blk.txt_mod, sv).chunk(6, -1)
        iq, ik, iv = qkv(blk.img_qkv, _modulate(img, i1, i2), blk.img_q_scale, blk.img_k_scale)
        tq, tk, tv = qkv(blk.txt_qkv, _modulate(txt, t1, t2), blk.txt_q_scale, blk.txt_k_scale)
        q = apply_rope(torch.cat([tq, iq], 1), cos, sin)
        k = apply_rope(torch.cat([tk, ik], 1), cos, sin)
        out = attention(q, k, torch.cat([tv, iv], 1), hd ** -0.5)
        img = img + i3[:, None] * dense(blk.img_proj, out[:, n_txt:])
        img = img + i6[:, None] * mlp_gelu(blk.img_mlp, _modulate(img, i4, i5))
        txt = txt + t3[:, None] * dense(blk.txt_proj, out[:, :n_txt])
        txt = txt + t6[:, None] * mlp_gelu(blk.txt_mlp, _modulate(txt, t4, t5))
    x = torch.cat([txt, img], 1)
    d = heads * hd
    for blk in model.single_blocks:
        shift, scale, gate = dense(blk.mod, sv).chunk(3, -1)
        fused = dense(blk.linear1, _modulate(x, shift, scale))
        q, k, v, h = fused.split([d, d, d, fused.shape[-1] - 3 * d], -1)
        q = apply_rope(rms_norm(q.reshape(b, -1, heads, hd), blk.q_scale), cos, sin)
        k = apply_rope(rms_norm(k.reshape(b, -1, heads, hd), blk.k_scale), cos, sin)
        attn = attention(q, k, v.reshape(b, -1, heads, hd), hd ** -0.5)
        x = x + gate[:, None] * dense(blk.linear2,
                                      torch.cat([attn, F.gelu(h, approximate="tanh")], -1))
    scale, shift = dense(model.final_mod, sv).chunk(2, -1)
    return dense(model.final_proj, _modulate(x[:, n_txt:], shift, scale))


def mlp_gelu(p, x):
    return dense(p.fc2, F.gelu(dense(p.fc1, x), approximate="tanh"))


# ---------------------------------------------------------------------------
# T5 v1.1 encoder
# ---------------------------------------------------------------------------

class T5Layer(nn.Module):
    def __init__(self, d, inner, ff):
        super().__init__()
        self.attn_norm, self.mlp_norm = _vec(d), _vec(d)
        self.q, self.k, self.v = (_lin(d, inner, False) for _ in range(3))
        self.o = _lin(inner, d, False)
        self.wi_0, self.wi_1 = _lin(d, ff, False), _lin(d, ff, False)
        self.wo = _lin(ff, d, False)


class T5(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(cfg["vocab_size"], d, device="meta"))
        self.rel_bias = nn.Parameter(torch.empty(cfg["relative_attention_num_buckets"],
                                                 cfg["num_heads"], device="meta"))
        self.layers = nn.ModuleList(T5Layer(d, inner, cfg["d_ff"])
                                    for _ in range(cfg["num_layers"]))
        self.final_norm = _vec(d)


def t5_buckets(s, num_buckets, max_distance, device):
    """Bidirectional relative-position buckets (Raffel et al., T5)."""
    pos = torch.arange(s, device=device)
    rel = pos[None, :] - pos[:, None]
    nb = num_buckets // 2
    bucket = (rel > 0).long() * nb
    rel = rel.abs()
    exact = nb // 2
    large = exact + (torch.log(rel.float() / exact + 1e-9) / math.log(max_distance / exact)
                     * (nb - exact)).long()
    return bucket + torch.where(rel < exact, rel, large.clamp(max=nb - 1))


def t5_encode(model: T5, ids):
    cfg = model.cfg
    b, s = ids.shape
    h = model.embedding[ids]
    buckets = t5_buckets(s, cfg["relative_attention_num_buckets"],
                         cfg["relative_attention_max_distance"], ids.device)
    bias = model.rel_bias[buckets].permute(2, 0, 1)[None]
    nh, eps = cfg["num_heads"], cfg["layer_norm_epsilon"]
    for p in model.layers:
        y = rms_norm(h, p.attn_norm, eps)
        q, k, v = (dense(lin, y).reshape(b, s, nh, -1) for lin in (p.q, p.k, p.v))
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) + bias, dim=-1)
        h = h + dense(p.o, torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1))
        y = rms_norm(h, p.mlp_norm, eps)
        h = h + dense(p.wo, F.gelu(dense(p.wi_0, y), approximate="tanh") * dense(p.wi_1, y))
    return rms_norm(h, model.final_norm, eps)


# ---------------------------------------------------------------------------
# CLIP-L text encoder
# ---------------------------------------------------------------------------

class AffineNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.scale, self.bias = _vec(d), _vec(d)


class CLIPLayer(nn.Module):
    def __init__(self, d, ff):
        super().__init__()
        self.ln1, self.ln2 = AffineNorm(d), AffineNorm(d)
        self.q, self.k, self.v, self.o = (_lin(d, d) for _ in range(4))
        self.fc1, self.fc2 = _lin(d, ff), _lin(ff, d)


class CLIP(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg["vocab_size"], d, device="meta"))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg["max_position_embeddings"], d, device="meta"))
        self.layers = nn.ModuleList(CLIPLayer(d, cfg["intermediate_size"])
                                    for _ in range(cfg["num_hidden_layers"]))
        self.final_ln = AffineNorm(d)


def clip_pooled(model: CLIP, ids):
    """The final LayerNorm's output at the first end-of-text token."""
    cfg = model.cfg
    b, s = ids.shape
    eps, nh = cfg["layer_norm_eps"], cfg["num_attention_heads"]

    def ln(p, x):
        return F.layer_norm(x, x.shape[-1:], p.scale, p.bias, eps)

    h = model.token_embedding[ids] + model.position_embedding[:s]
    causal = torch.full((s, s), float("-inf"), device=ids.device).triu(1)
    for p in model.layers:
        y = ln(p.ln1, h)
        q, k, v = (dense(lin, y).reshape(b, s, nh, -1) for lin in (p.q, p.k, p.v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1]) + causal
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v).reshape(b, s, -1)
        h = h + dense(p.o, o)
        y = ln(p.ln2, h)
        h = h + dense(p.fc2, (lambda a: a * torch.sigmoid(1.702 * a))(dense(p.fc1, y)))
    h = ln(model.final_ln, h)
    # the published config's eos_token_id is the legacy 2: its pooling takes
    # the largest id, which is the end-of-text token in CLIP's vocabulary
    eos = (torch.argmax(ids, dim=-1) if cfg["eos_token_id"] == 2
           else torch.argmax((ids == cfg["eos_token_id"]).int(), dim=-1))
    return h[torch.arange(b, device=ids.device), eos]


# ---------------------------------------------------------------------------
# FLUX VAE (KL autoencoder, 16 latent channels)
# ---------------------------------------------------------------------------

def _conv(k, c_in, c_out, stride=1, padding=0):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding, device="meta")


class Resnet(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm1, self.norm2 = AffineNorm(c_in), AffineNorm(c_out)
        self.conv1, self.conv2 = _conv(3, c_in, c_out, padding=1), _conv(3, c_out, c_out,
                                                                          padding=1)
        self.skip = _conv(1, c_in, c_out) if c_in != c_out else None


class Attn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = AffineNorm(c)
        self.q, self.k, self.v, self.out = (_lin(c, c) for _ in range(4))


class Mid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.res1, self.attn, self.res2 = Resnet(c, c), Attn(c), Resnet(c, c)


class Down(nn.Module):
    def __init__(self, c_in, c, n, down):
        super().__init__()
        self.resnets = nn.ModuleList(Resnet(c_in if j == 0 else c, c) for j in range(n))
        self.down = _conv(3, c, c, stride=2) if down else None


class Up(nn.Module):
    def __init__(self, c_in, c, n, up):
        super().__init__()
        self.resnets = nn.ModuleList(Resnet(c_in if j == 0 else c, c) for j in range(n))
        self.up = _conv(3, c, c, padding=1) if up else None


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, n = cfg["block_out_channels"], cfg["layers_per_block"]
        self.conv_in = _conv(3, cfg["in_channels"], ch[0], padding=1)
        self.down = nn.ModuleList(Down(ch[max(i - 1, 0)], c, n, i < len(ch) - 1)
                                  for i, c in enumerate(ch))
        self.mid = Mid(ch[-1])
        self.norm_out = AffineNorm(ch[-1])
        self.conv_out = _conv(3, ch[-1], 2 * cfg["latent_channels"], padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        rev, n = list(reversed(cfg["block_out_channels"])), cfg["layers_per_block"] + 1
        self.conv_in = _conv(3, cfg["latent_channels"], rev[0], padding=1)
        self.mid = Mid(rev[0])
        self.up = nn.ModuleList(Up(rev[max(i - 1, 0)], c, n, i < len(rev) - 1)
                                for i, c in enumerate(rev))
        self.norm_out = AffineNorm(rev[-1])
        self.conv_out = _conv(3, rev[-1], cfg["out_channels"], padding=1)


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder, self.decoder = Encoder(cfg), Decoder(cfg)


def _gn(p, x, groups):
    return F.group_norm(x, groups, p.scale, p.bias, 1e-6)


def _resnet(p, x, g):
    h = conv(p.conv1, F.silu(_gn(p.norm1, x, g)))
    h = conv(p.conv2, F.silu(_gn(p.norm2, h, g)))
    return (conv(p.skip, x) if p.skip is not None else x) + h


def _mid(p, x, g):
    x = _resnet(p.res1, x, g)
    b, c, hh, ww = x.shape
    y = _gn(p.attn.norm, x, g).reshape(b, c, hh * ww).transpose(1, 2)
    q, k, v = dense(p.attn.q, y), dense(p.attn.k, y), dense(p.attn.v, y)
    o = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1) @ v
    x = x + dense(p.attn.out, o).transpose(1, 2).reshape(b, c, hh, ww)
    return _resnet(p.res2, x, g)


def vae_moments(vae: VAE, images):
    """NHWC images in [-1, 1] -> posterior (mean, logvar), NHWC."""
    g, p = vae.cfg["norm_num_groups"], vae.encoder
    x = conv(p.conv_in, images.permute(0, 3, 1, 2))
    for blk in p.down:
        for r in blk.resnets:
            x = _resnet(r, x, g)
        if blk.down is not None:
            x = conv(blk.down, F.pad(x, (0, 1, 0, 1)))
    x = conv(p.conv_out, F.silu(_gn(p.norm_out, _mid(p.mid, x, g), g))).permute(0, 2, 3, 1)
    mean, logvar = x.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_decode(vae: VAE, latents):
    """Scaled NHWC latents -> NHWC images in [-1, 1]."""
    cfg, p = vae.cfg, vae.decoder
    g = cfg["norm_num_groups"]
    z = latents / cfg["scaling_factor"] + cfg["shift_factor"]
    x = _mid(p.mid, conv(p.conv_in, z.permute(0, 3, 1, 2)), g)
    for blk in p.up:
        for r in blk.resnets:
            x = _resnet(r, x, g)
        if blk.up is not None:
            x = conv(blk.up, F.interpolate(x, scale_factor=2, mode="nearest"))
    return conv(p.conv_out, F.silu(_gn(p.norm_out, x, g))).permute(0, 2, 3, 1)


def pack_latents(z):
    """(B, H, W, C) -> (B, H/2 * W/2, C*4), feature order (c, ph, pw)."""
    b, h, w, c = z.shape
    return z.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(
        b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens, lat_h, lat_w):
    b, _, f = tokens.shape
    x = tokens.reshape(b, lat_h // 2, lat_w // 2, f // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, lat_h, lat_w, f // 4)


def pack_mask(mask, s):
    """(B, H, W) pixel mask -> (B, T, s*s*4) tokens aligned with the latents."""
    b, hp, wp = mask.shape
    x = mask.reshape(b, hp // s, s, wp // s, s).permute(0, 1, 3, 2, 4)
    return pack_latents(x.reshape(b, hp // s, wp // s, s * s))


def make_schedule(steps, image_seq_len, base_seq=256, max_seq=4096, base_shift=0.5,
                  max_shift=1.15):
    """FLUX's dynamic-shift flow-matching sigmas (diffusers' FluxFillPipeline):
    steps + 1 float32 values, 0 last."""
    m = (max_shift - base_shift) / (max_seq - base_seq)
    mu = image_seq_len * m + (base_shift - m * base_seq)
    sig = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    sig = math.exp(mu) / (math.exp(mu) + (1.0 / sig - 1.0))
    return np.append(sig, 0.0).astype(np.float32)


MODELS = {"flux": Flux, "t5": T5, "clip": CLIP, "vae": VAE}
