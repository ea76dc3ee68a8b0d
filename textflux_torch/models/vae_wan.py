"""The Wan-2.1 VAE (diffusers' ``AutoencoderKLQwenImage`` / ``AutoencoderKLWan``) on
single images and on clips.

The published VAE is causal in time: every ``CausalConv3d`` pads two zero
frames before the first, and a video's first chunk is one frame. An image
is that chunk, so each 3-D convolution is the 2-D convolution with its
last temporal tap ``W[:, :, -1]`` (the taps before it meet the zero
frames), the temporal down- and upsampling convolutions (``time_conv``)
never run (the first chunk only fills their caches), and the rest is 2-D.
The parameters keep the checkpoint's shapes (a 3-D convolution's weight is
(out, in, t, kh, kw)), so a diffusers checkpoint loads as it is stored;
``time_conv`` is held and not used.

Layers (base 96, ``dim_mult`` (1, 2, 4, 4), 2 residual blocks a level):

* ``RMS_norm``: ``F.normalize`` over channels, times sqrt(C) and a
  per-channel scale, in float32;
* a residual block: norm, SiLU, 3x3 conv, norm, SiLU, 3x3 conv, plus a 1x1
  shortcut where the widths differ;
* the attention block: one head over H*W, a 1x1 qkv and a 1x1 projection;
* encoder widths 96, 96, 192, 384, 384, each level but the last ending in
  a (0, 1, 0, 1) zero pad and a stride-2 3x3 conv; the middle is residual,
  attention, residual; then norm, SiLU, conv to 2 x 16, ``quant_conv``,
  and the posterior's mean;
* decoder (after ``post_quant_conv``): widths 384, 384, 384, 192, 96, three
  residual blocks a level, levels 1-3 taking half the previous width in;
  upsampling is nearest x2 and a 3x3 conv to half the width; the output is
  clamped to [-1, 1].

Latents are normalised per channel, (z - mean) / std, with the published
vectors (``config.WAN_LATENTS_MEAN`` / ``WAN_LATENTS_STD``). Public
functions take and give NHWC, as ``models.vae``'s.

Clips (``wan_encode_video`` / ``wan_decode_video``, NTHWC) run the causal
temporal path as the published VAE does, chunk by chunk: the encoder takes
frame 0 alone and then 4 frames at a time, the decoder one latent frame at
a time. Every causal 3-D convolution pads its input with the last
``CACHE_T`` frames of its input in the chunks before (zeros before frame
0), kept in a per-call cache; ``time_conv`` runs from the second chunk on:
downsampling, a stride-2 convolution over the previous chunk's last frame
and this chunk's; upsampling, a causal convolution to twice the channels
whose halves become two frames each. So 1 + 4k frames encode to 1 + k
latent frames and decode back. The single-image functions above are the
first chunk without the temporal convolutions, and stay as they are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.config import WanVAEConfig
from textflux_torch.device import resolve_device
from textflux_torch.models.layers import silu


def _conv_param(c_out: int, c_in: int, kernel, *, device, dtype, generator) -> nn.Module:
    """A convolution's weight (c_out, c_in, *kernel) and bias, uniform in
    [-1/sqrt(fan_in), +] and zero."""
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty((c_out, c_in, *kernel), device=device, dtype=dtype))
    m.bias = nn.Parameter(torch.zeros(c_out, device=device, dtype=dtype))
    if device.type != "meta":
        bound = 1.0 / math.sqrt(c_in * math.prod(kernel))
        with torch.no_grad():
            m.weight.uniform_(-bound, bound, generator=generator)
    return m


def _conv3(c_out, c_in, k, **kw):
    """A causal 3-D convolution's parameters: (c_out, c_in, k, k, k)."""
    return _conv_param(c_out, c_in, (k, k, k), **kw)


class RMSNorm(nn.Module):
    def __init__(self, c: int, *, device, dtype, **_):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device, dtype=dtype))


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, **kw):
        super().__init__()
        self.norm1 = RMSNorm(c_in, **kw)
        self.conv1 = _conv3(c_out, c_in, 3, **kw)
        self.norm2 = RMSNorm(c_out, **kw)
        self.conv2 = _conv3(c_out, c_out, 3, **kw)
        self.shortcut = _conv3(c_out, c_in, 1, **kw) if c_in != c_out else None


class AttnBlock(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = RMSNorm(c, **kw)
        self.qkv = _conv_param(3 * c, c, (1, 1), **kw)
        self.proj = _conv_param(c, c, (1, 1), **kw)


class MidBlock(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.res1 = ResBlock(c, c, **kw)
        self.attn = AttnBlock(c, **kw)
        self.res2 = ResBlock(c, c, **kw)


class Resample(nn.Module):
    """A level's spatial down- (stride-2 3x3 conv after a (0, 1, 0, 1) pad)
    or upsampling (nearest x2, then a 3x3 conv to half the width), with the
    temporal convolution of a 3-D one held unused."""

    def __init__(self, c: int, mode: str, **kw):
        super().__init__()
        self.mode = mode
        c_out = c // 2 if mode.startswith("up") else c
        self.conv = _conv_param(c_out, c, (3, 3), **kw)
        self.time_conv = None
        if mode == "downsample3d":
            self.time_conv = _conv_param(c, c, (3, 1, 1), **kw)
        elif mode == "upsample3d":
            self.time_conv = _conv_param(2 * c, c, (3, 1, 1), **kw)


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        dims = [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]
        temporal = (False,) + (True,) * (len(cfg.dim_mult) - 2)
        self.conv_in = _conv3(dims[0], 3, 3, **kw)
        blocks = []
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResBlock(c_in, c_out, **kw))
                c_in = c_out
            if i != len(cfg.dim_mult) - 1:
                blocks.append(Resample(c_out, "downsample3d" if temporal[i] else "downsample2d",
                                       **kw))
        self.down = nn.ModuleList(blocks)
        self.mid = MidBlock(dims[-1], **kw)
        self.norm_out = RMSNorm(dims[-1], **kw)
        self.conv_out = _conv3(2 * cfg.z_dim, dims[-1], 3, **kw)


class UpBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n: int, mode: Optional[str], **kw):
        super().__init__()
        self.resnets = nn.ModuleList(ResBlock(c_in if j == 0 else c_out, c_out, **kw)
                                     for j in range(n))
        self.up = Resample(c_out, mode, **kw) if mode else None


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        mult = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * u for u in (mult[-1],) + mult[::-1]]
        temporal = ((False,) + (True,) * (len(mult) - 2))[::-1]
        self.conv_in = _conv3(dims[0], cfg.z_dim, 3, **kw)
        self.mid = MidBlock(dims[0], **kw)
        ups = []
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:
                c_in //= 2
            mode = None
            if i != len(mult) - 1:
                mode = "upsample3d" if temporal[i] else "upsample2d"
            ups.append(UpBlock(c_in, c_out, cfg.num_res_blocks + 1, mode, **kw))
        self.up = nn.ModuleList(ups)
        self.norm_out = RMSNorm(dims[-1], **kw)
        self.conv_out = _conv3(3, dims[-1], 3, **kw)


class WanVAE(nn.Module):
    """Wan VAE parameters, initialised from `generator` (default: seed 0)."""

    def __init__(self, cfg: WanVAEConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.quant_conv = _conv3(2 * cfg.z_dim, 2 * cfg.z_dim, 1, **kw)
        self.post_quant_conv = _conv3(cfg.z_dim, cfg.z_dim, 1, **kw)
        self.decoder = Decoder(cfg, **kw)


# ---------------------------------------------------------------------------
# Forward (NCHW inside)
# ---------------------------------------------------------------------------

def _conv(p: nn.Module, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """A convolution in x's dtype: a 3-D one's last temporal tap, 'same'
    zero padding for odd kernels (none for the stride-2 one, padded by
    the caller)."""
    w = p.weight[:, :, -1] if p.weight.dim() == 5 else p.weight
    pad = 0 if stride != 1 else w.shape[-1] // 2
    return F.conv2d(x, w.to(x.dtype), p.bias.to(x.dtype), stride=stride, padding=pad)


def _norm(p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    xf = F.normalize(x.float(), dim=1) * math.sqrt(x.shape[1])
    return (xf * p.scale.float()[:, None, None]).to(x.dtype)


def _res(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p.conv1, silu(_norm(p.norm1, x)))
    h = _conv(p.conv2, silu(_norm(p.norm2, h)))
    return (x if p.shortcut is None else _conv(p.shortcut, x)) + h


def _attn(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    b, c, hh, ww = x.shape
    qkv = _conv(p.qkv, _norm(p.norm, x)).reshape(b, 3 * c, hh * ww).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return x + _conv(p.proj, o.transpose(1, 2).reshape(b, c, hh, ww))


def _mid(p: MidBlock, x: torch.Tensor) -> torch.Tensor:
    return _res(p.res2, _attn(p.attn, _res(p.res1, x)))


def _resample(p: Resample, x: torch.Tensor) -> torch.Tensor:
    if p.mode.startswith("down"):
        return _conv(p.conv, F.pad(x, (0, 1, 0, 1)), stride=2)
    return _conv(p.conv, F.interpolate(x, scale_factor=2, mode="nearest"))


def _stats(vae: WanVAE, like: torch.Tensor):
    cfg = vae.cfg
    mean = torch.tensor(cfg.latents_mean, dtype=torch.float32, device=like.device)
    std = torch.tensor(cfg.latents_std, dtype=torch.float32, device=like.device)
    return mean, std


def wan_encode(vae: WanVAE, images: torch.Tensor) -> torch.Tensor:
    """NHWC images in [-1, 1] -> the posterior's mean, normalised per
    channel: (B, H/8, W/8, 16) in the images' dtype."""
    p = vae.encoder
    x = _conv(p.conv_in, images.permute(0, 3, 1, 2))
    for blk in p.down:
        x = _resample(blk, x) if isinstance(blk, Resample) else _res(blk, x)
    x = _conv(p.conv_out, silu(_norm(p.norm_out, _mid(p.mid, x))))
    mu = _conv(vae.quant_conv, x)[:, :vae.cfg.z_dim].permute(0, 2, 3, 1)
    mean, std = _stats(vae, mu)
    return ((mu.float() - mean) / std).to(images.dtype)


def wan_decode(vae: WanVAE, latents: torch.Tensor) -> torch.Tensor:
    """Normalised NHWC latents -> NHWC images clamped to [-1, 1]."""
    mean, std = _stats(vae, latents)
    z = (latents.float() * std + mean).to(latents.dtype).permute(0, 3, 1, 2)
    p = vae.decoder
    x = _mid(p.mid, _conv(p.conv_in, _conv(vae.post_quant_conv, z)))
    for blk in p.up:
        for r in blk.resnets:
            x = _res(r, x)
        if blk.up is not None:
            x = _resample(blk.up, x)
    x = _conv(p.conv_out, silu(_norm(p.norm_out, x)))
    return torch.clamp(x, -1.0, 1.0).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Clips: the causal temporal path (NCTHW inside), chunk by chunk
# ---------------------------------------------------------------------------

CACHE_T = 2     # input frames a causal 3-D convolution carries to the next chunk
ENCODE_CHUNK = 4
_REPEAT = "first chunk"   # an upsampling time_conv's state after the first chunk


def _causal(p: nn.Module, x: torch.Tensor, prev: Optional[torch.Tensor], *,
            stride: int = 1) -> torch.Tensor:
    """A causal 3-D convolution on chunk x (B, C, T, H, W) after `prev`, the
    earlier frames of its input it sees (None: zeros); front-padded in time
    to the kernel's reach, 'same' zero padding in space."""
    w = p.weight
    kt, ph = w.shape[2], w.shape[3] // 2
    full = x if prev is None else torch.cat([prev, x], 2)
    pad_t = max(0, kt - 1 - (full.shape[2] - x.shape[2])) if stride == 1 else 0
    full = F.pad(full, (ph, ph, ph, ph, pad_t, 0))
    return F.conv3d(full, w.to(x.dtype), p.bias.to(x.dtype), stride=(stride, 1, 1))


def _cconv(p: nn.Module, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """``_causal`` with the frames `cache` kept for `p`, which then keeps
    the last CACHE_T frames of this chunk's input (with those before it)."""
    if p.weight.shape[2] == 1:
        return _causal(p, x, None)
    prev = cache.get(id(p))
    out = _causal(p, x, prev)
    cache[id(p)] = (x if prev is None else torch.cat([prev, x], 2))[:, :, -CACHE_T:]
    return out


def _frames(fn, x: torch.Tensor) -> torch.Tensor:
    """`fn` (NCHW -> NCHW) on every frame of x (B, C, T, H, W)."""
    b, c, t, h, w = x.shape
    y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


def _norm3(p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    xf = F.normalize(x.float(), dim=1) * math.sqrt(x.shape[1])
    return (xf * p.scale.float()[:, None, None, None]).to(x.dtype)


def _res3(p: ResBlock, x: torch.Tensor, cache: dict) -> torch.Tensor:
    h = _cconv(p.conv1, silu(_norm3(p.norm1, x)), cache)
    h = _cconv(p.conv2, silu(_norm3(p.norm2, h)), cache)
    return (x if p.shortcut is None else _causal(p.shortcut, x, None)) + h


def _mid3(p: MidBlock, x: torch.Tensor, cache: dict) -> torch.Tensor:
    x = _frames(lambda f: _attn(p.attn, f), _res3(p.res1, x, cache))
    return _res3(p.res2, x, cache)


def _resample3(p: Resample, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """A level's resampling of a chunk: in space frame by frame, in time by
    ``time_conv`` from the second chunk on (module docstring)."""
    if p.mode == "upsample3d":
        prev = cache.get(id(p))
        if prev is None:
            cache[id(p)] = _REPEAT
        else:
            b, c, t, h, w = x.shape
            keep = x[:, :, -CACHE_T:]
            if keep.shape[2] < CACHE_T:
                first = torch.zeros_like(keep) if prev is _REPEAT else prev[:, :, -1:]
                keep = torch.cat([first, keep], 2)
            y = _causal(p.time_conv, x, None if prev is _REPEAT else prev)
            cache[id(p)] = keep
            x = torch.stack(y.reshape(b, 2, c, t, h, w).unbind(1), 3).reshape(b, c, 2 * t, h, w)
    x = _frames(lambda f: _resample(p, f), x)
    if p.mode == "downsample3d":
        prev = cache.get(id(p))
        cache[id(p)] = x[:, :, -1:]
        if prev is not None:
            x = _causal(p.time_conv, x, prev, stride=2)
    return x


def _encode_chunk(vae: WanVAE, x: torch.Tensor, cache: dict) -> torch.Tensor:
    p = vae.encoder
    x = _cconv(p.conv_in, x, cache)
    for blk in p.down:
        x = _resample3(blk, x, cache) if isinstance(blk, Resample) else _res3(blk, x, cache)
    return _cconv(p.conv_out, silu(_norm3(p.norm_out, _mid3(p.mid, x, cache))), cache)


def _decode_chunk(vae: WanVAE, x: torch.Tensor, cache: dict) -> torch.Tensor:
    p = vae.decoder
    x = _mid3(p.mid, _cconv(p.conv_in, x, cache), cache)
    for blk in p.up:
        for r in blk.resnets:
            x = _res3(r, x, cache)
        if blk.up is not None:
            x = _resample3(blk.up, x, cache)
    return _cconv(p.conv_out, silu(_norm3(p.norm_out, x)), cache)


def latent_frames(frames: int) -> int:
    """Latent frames of a clip of 1 + 4k frames: 1 + k."""
    if frames < 1 or (frames - 1) % ENCODE_CHUNK:
        raise ValueError(f"a clip has 1 + {ENCODE_CHUNK}k frames, got {frames}")
    return 1 + (frames - 1) // ENCODE_CHUNK


def wan_encode_video(vae: WanVAE, video: torch.Tensor) -> torch.Tensor:
    """NTHWC clips (B, 1 + 4k, H, W, 3) in [-1, 1] -> the posterior's mean,
    normalised per channel: (B, 1 + k, H/8, W/8, 16) in the clips' dtype;
    frame 0 alone, then 4 frames a chunk."""
    t = video.shape[1]
    latent_frames(t)
    x = video.permute(0, 4, 1, 2, 3)
    cache: dict = {}
    bounds = [(0, 1)] + [(s, s + ENCODE_CHUNK) for s in range(1, t, ENCODE_CHUNK)]
    mu = torch.cat([_encode_chunk(vae, x[:, :, a:b], cache) for a, b in bounds], 2)
    mu = _causal(vae.quant_conv, mu, None)[:, :vae.cfg.z_dim].permute(0, 2, 3, 4, 1)
    mean, std = _stats(vae, mu)
    return ((mu.float() - mean) / std).to(video.dtype)


def wan_decode_video(vae: WanVAE, latents: torch.Tensor) -> torch.Tensor:
    """Normalised NTHWC latents (B, 1 + k, h, w, 16) -> NTHWC clips (B,
    1 + 4k, 8h, 8w, 3) clamped to [-1, 1]; one latent frame a chunk."""
    mean, std = _stats(vae, latents)
    z = (latents.float() * std + mean).to(latents.dtype).permute(0, 4, 1, 2, 3)
    x = _causal(vae.post_quant_conv, z, None)
    cache: dict = {}
    out = torch.cat([_decode_chunk(vae, x[:, :, i:i + 1], cache) for i in range(x.shape[2])], 2)
    return torch.clamp(out, -1.0, 1.0).permute(0, 2, 3, 4, 1)
