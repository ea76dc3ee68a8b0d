"""The plain float32 reference of the Wan-2.1 VAE (``AutoencoderKLQwenImage``) on one frame.

Plain PyTorch, written from diffusers' ``AutoencoderKLWan`` in the layout of
the program's parameters (a causal 3-D convolution's weight as stored,
(out, in, t, kh, kw)). Departure from the published model, which is causal
in time and encodes a video in chunks: an image is the first chunk, one
frame, in which every ``CausalConv3d`` meets two zero frames before it, so
it is the 2-D convolution with the last temporal tap ``W[:, :, -1]``, and
the temporal resampling convolutions (``time_conv``) never run. float32,
TF32 off, an explicit softmax in the middle attention. Nothing here imports
the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench import weights
from h100_bench.reference import models as M

MODEL = "wan_vae"


def _conv(c_out, c_in, kernel):
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty((c_out, c_in, *kernel), device="meta"))
    m.bias = nn.Parameter(torch.empty(c_out, device="meta"))
    return m


def _norm(c):
    m = nn.Module()
    m.scale = M._vec(c)
    return m


class Res(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm1, self.conv1 = _norm(c_in), _conv(c_out, c_in, (3, 3, 3))
        self.norm2, self.conv2 = _norm(c_out), _conv(c_out, c_out, (3, 3, 3))
        self.shortcut = _conv(c_out, c_in, (1, 1, 1)) if c_in != c_out else None


class Attn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm, self.qkv, self.proj = _norm(c), _conv(3 * c, c, (1, 1)), _conv(c, c, (1, 1))


class Mid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.res1, self.attn, self.res2 = Res(c, c), Attn(c), Res(c, c)


class Resample(nn.Module):
    def __init__(self, c, mode):
        super().__init__()
        self.mode = mode
        self.conv = _conv(c // 2 if mode.startswith("up") else c, c, (3, 3))
        self.time_conv = {"downsample3d": _conv(c, c, (3, 1, 1)),
                          "upsample3d": _conv(2 * c, c, (3, 1, 1))}.get(mode)


class Up(nn.Module):
    def __init__(self, c_in, c_out, n, mode):
        super().__init__()
        self.resnets = nn.ModuleList(Res(c_in if j == 0 else c_out, c_out) for j in range(n))
        self.up = Resample(c_out, mode) if mode else None


class WanVAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        base, mult, z = cfg["base_dim"], list(cfg["dim_mult"]), cfg["z_dim"]
        n, tdown = cfg["num_res_blocks"], list(cfg["temperal_downsample"])
        enc = nn.Module()
        dims = [base * u for u in [1] + mult]
        enc.conv_in = _conv(dims[0], 3, (3, 3, 3))
        blocks = []
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(n):
                blocks.append(Res(c_in, c_out))
                c_in = c_out
            if i != len(mult) - 1:
                blocks.append(Resample(c_out, "downsample3d" if tdown[i] else "downsample2d"))
        enc.down = nn.ModuleList(blocks)
        enc.mid, enc.norm_out = Mid(dims[-1]), _norm(dims[-1])
        enc.conv_out = _conv(2 * z, dims[-1], (3, 3, 3))
        dec = nn.Module()
        dims = [base * u for u in [mult[-1]] + mult[::-1]]
        tup = tdown[::-1]
        dec.conv_in, dec.mid = _conv(dims[0], z, (3, 3, 3)), Mid(dims[0])
        ups = []
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            mode = None if i == len(mult) - 1 else ("upsample3d" if tup[i] else "upsample2d")
            ups.append(Up(c_in // 2 if i > 0 else c_in, c_out, n + 1, mode))
        dec.up = nn.ModuleList(ups)
        dec.norm_out, dec.conv_out = _norm(dims[-1]), _conv(3, dims[-1], (3, 3, 3))
        self.encoder, self.decoder = enc, dec
        self.quant_conv = _conv(2 * z, 2 * z, (1, 1, 1))
        self.post_quant_conv = _conv(z, z, (1, 1, 1))


def round_convs(model: nn.Module, rounding: str) -> None:
    """The control's rounding of every convolution weight (one e4m3 scale
    per output channel, inputs rounded per tensor), as ``models.round_weights``
    rounds an ``nn.Conv2d``'s."""
    if rounding == "fp32":
        return
    if rounding != "fp8":
        raise ValueError(f"no rounding {rounding!r} for the Wan VAE")
    for m in model.modules():
        w = m._parameters.get("weight")
        if w is not None and w.dim() >= 4:
            m.weight.data = M.fp8_rows(w.data.reshape(w.shape[0], -1)).reshape(w.shape)
            m.fp8_inputs = True


def build(cfg: dict, seed: int, device, rounding: str = "fp32") -> WanVAE:
    model = WanVAE(cfg)
    model.load_state_dict(weights.state_dict(seed, MODEL, weights.groups(model), device,
                                             torch.float32), assign=True, strict=True)
    model.requires_grad_(False)
    round_convs(model, rounding)
    return model


def conv(p, x, stride=1):
    if getattr(p, "fp8_inputs", False):
        x = M.fp8_tensor(x)
    w = p.weight[:, :, -1] if p.weight.dim() == 5 else p.weight
    return F.conv2d(x, w, p.bias, stride=stride, padding=0 if stride != 1 else w.shape[-1] // 2)


def rms(p, x):
    """``RMS_norm``: F.normalize over channels, times sqrt(C) and gamma."""
    return F.normalize(x, dim=1) * math.sqrt(x.shape[1]) * p.scale[:, None, None]


def res(p: Res, x):
    h = conv(p.conv1, F.silu(rms(p.norm1, x)))
    h = conv(p.conv2, F.silu(rms(p.norm2, h)))
    return (x if p.shortcut is None else conv(p.shortcut, x)) + h


def mid(p: Mid, x):
    x = res(p.res1, x)
    b, c, hh, ww = x.shape
    q, k, v = conv(p.attn.qkv, rms(p.attn.norm, x)).reshape(b, 3 * c, -1).transpose(1, 2).chunk(
        3, -1)
    o = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), -1) @ v
    x = x + conv(p.attn.proj, o.transpose(1, 2).reshape(b, c, hh, ww))
    return res(p.res2, x)


def resample(p: Resample, x):
    if p.mode.startswith("down"):
        return conv(p.conv, F.pad(x, (0, 1, 0, 1)), stride=2)
    return conv(p.conv, F.interpolate(x, scale_factor=2, mode="nearest"))


def _stats(cfg, device):
    return (torch.tensor(cfg["latents_mean"], device=device),
            torch.tensor(cfg["latents_std"], device=device))


@torch.inference_mode()
def encode(vae: WanVAE, images):
    """NHWC images in [-1, 1] -> the posterior mean, normalised (z - mean) /
    std, NHWC float32."""
    p = vae.encoder
    x = conv(p.conv_in, images.permute(0, 3, 1, 2))
    for blk in p.down:
        x = resample(blk, x) if isinstance(blk, Resample) else res(blk, x)
    x = conv(p.conv_out, F.silu(rms(p.norm_out, mid(p.mid, x))))
    mu = conv(vae.quant_conv, x)[:, :vae.cfg["z_dim"]].permute(0, 2, 3, 1)
    mean, std = _stats(vae.cfg, images.device)
    return (mu - mean) / std


@torch.inference_mode()
def decode(vae: WanVAE, latents):
    """Normalised NHWC latents -> NHWC images clamped to [-1, 1]."""
    mean, std = _stats(vae.cfg, latents.device)
    z = (latents.float() * std + mean).permute(0, 3, 1, 2)
    p = vae.decoder
    x = mid(p.mid, conv(p.conv_in, conv(vae.post_quant_conv, z)))
    for blk in p.up:
        for r in blk.resnets:
            x = res(r, x)
        if blk.up is not None:
            x = resample(blk.up, x)
    x = conv(p.conv_out, F.silu(rms(p.norm_out, x)))
    return x.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
