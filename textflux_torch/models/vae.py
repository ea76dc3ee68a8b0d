"""FLUX KL autoencoder (16 latent channels, 8x spatial).

The port of ``textflux_tpu/models/vae.py``. The public functions keep the JAX
package's NHWC image/latent layout; inside, the convolutions run as
``nn.Conv2d`` in PyTorch's NCHW. GroupNorm computes in float32; the mid-block
spatial attention is one single-head attention. FLUX's VAE has no quant convs.
``vae_encode_tiled`` / ``vae_decode_tiled`` bound the cost of large canvases
(the pipeline switches to them above a 160x160 latent area).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.config import VAEConfig
from textflux_torch.device import resolve_device
from textflux_torch.models.layers import dense, make_linear, silu


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def make_conv(k: int, c_in: int, c_out: int, *, stride: int = 1, padding: int = 0,
              device=None, dtype=None, generator=None) -> nn.Conv2d:
    """nn.Conv2d with the JAX package's conv_init distribution: weights
    uniform in [-1/sqrt(c_in*k*k), +], zero bias."""
    conv = torch.nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride=stride,
                                    padding=padding, device=device, dtype=dtype)
    bound = 1.0 / math.sqrt(c_in * k * k)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.zero_()
    return conv


def conv(c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Convolution in x's dtype (NCHW)."""
    return F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), stride=c.stride,
                    padding=c.padding)


class GroupNorm(nn.Module):
    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))


def group_norm(p: GroupNorm, x: torch.Tensor, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW in float32, cast back to x's dtype."""
    return F.group_norm(x.float(), groups, p.scale.float(), p.bias.float(), eps).to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, **kw):
        super().__init__()
        nkw = {k: kw[k] for k in ("device", "dtype")}
        self.norm1 = GroupNorm(c_in, **nkw)
        self.conv1 = make_conv(3, c_in, c_out, padding=1, **kw)
        self.norm2 = GroupNorm(c_out, **nkw)
        self.conv2 = make_conv(3, c_out, c_out, padding=1, **kw)
        self.skip = make_conv(1, c_in, c_out, **kw) if c_in != c_out else None


def _resnet(p: ResnetBlock, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv(p.conv1, silu(group_norm(p.norm1, x, groups)))
    h = conv(p.conv2, silu(group_norm(p.norm2, h, groups)))
    skip = conv(p.skip, x) if p.skip is not None else x
    return skip + h


class AttnBlock(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = GroupNorm(c, device=kw["device"], dtype=kw["dtype"])
        self.q = make_linear(c, c, **kw)
        self.k = make_linear(c, c, **kw)
        self.v = make_linear(c, c, **kw)
        self.out = make_linear(c, c, **kw)


def _attn(p: AttnBlock, x: torch.Tensor, groups: int) -> torch.Tensor:
    b, c, h, w = x.shape
    y = group_norm(p.norm, x, groups).reshape(b, c, h * w).transpose(1, 2)  # (b, hw, c)
    q, k, v = dense(p.q, y), dense(p.k, y), dense(p.v, y)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    probs = torch.softmax(logits / math.sqrt(c), dim=-1).to(v.dtype)
    o = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return x + dense(p.out, o).transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.res1 = ResnetBlock(c, c, **kw)
        self.attn = AttnBlock(c, **kw)
        self.res2 = ResnetBlock(c, c, **kw)


def _mid(p: MidBlock, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = _resnet(p.res1, x, groups)
    x = _attn(p.attn, x, groups)
    return _resnet(p.res2, x, groups)


class DownBlock(nn.Module):
    def __init__(self, c_in: int, c: int, n: int, downsample: bool, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(c_in if j == 0 else c, c, **kw)
                                     for j in range(n))
        # stride-2 VALID conv after an asymmetric (0, 1) pad (diffusers Downsample2D)
        self.down = make_conv(3, c, c, stride=2, **kw) if downsample else None


class UpBlock(nn.Module):
    def __init__(self, c_in: int, c: int, n: int, upsample: bool, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(c_in if j == 0 else c, c, **kw)
                                     for j in range(n))
        self.up = make_conv(3, c, c, padding=1, **kw) if upsample else None


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = make_conv(3, cfg.in_channels, chans[0], padding=1, **kw)
        self.down = nn.ModuleList(
            DownBlock(chans[max(i - 1, 0)], c, cfg.layers_per_block, i < len(chans) - 1, **kw)
            for i, c in enumerate(chans))
        self.mid = MidBlock(chans[-1], **kw)
        self.norm_out = GroupNorm(chans[-1], device=kw["device"], dtype=kw["dtype"])
        self.conv_out = make_conv(3, chans[-1], 2 * cfg.latent_channels, padding=1, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = make_conv(3, cfg.latent_channels, rev[0], padding=1, **kw)
        self.mid = MidBlock(rev[0], **kw)
        self.up = nn.ModuleList(
            UpBlock(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, i < len(rev) - 1, **kw)
            for i, c in enumerate(rev))
        self.norm_out = GroupNorm(rev[-1], device=kw["device"], dtype=kw["dtype"])
        self.conv_out = make_conv(3, rev[-1], cfg.out_channels, padding=1, **kw)


class FluxVAE(nn.Module):
    """KL autoencoder parameters (the JAX package's init_vae_params
    distributions), initialised from `generator` (default: seed 0)."""

    def __init__(self, cfg: VAEConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)


# ---------------------------------------------------------------------------
# Public functions (NHWC)
# ---------------------------------------------------------------------------

def vae_encode_moments(vae: FluxVAE, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode NHWC images in [-1, 1] to posterior (mean, logvar), each (B,h,w,C)."""
    g = vae.cfg.norm_num_groups
    p = vae.encoder
    x = conv(p.conv_in, images.permute(0, 3, 1, 2))
    for block in p.down:
        for r in block.resnets:
            x = _resnet(r, x, g)
        if block.down is not None:
            x = conv(block.down, F.pad(x, (0, 1, 0, 1)))
    x = _mid(p.mid, x, g)
    x = conv(p.conv_out, silu(group_norm(p.norm_out, x, g)))
    x = x.permute(0, 2, 3, 1)
    mean, logvar = x.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_encode(vae: FluxVAE, images: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, scale: bool = True) -> torch.Tensor:
    """Encode to latents: a posterior sample when `noise` (a standard normal
    draw shaped like the latents) or a `generator` to draw it from is given,
    else the mode; then (z - shift_factor) * scaling_factor when scale=True."""
    cfg = vae.cfg
    mean, logvar = vae_encode_moments(vae, images)
    z = mean
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=torch.float32)
    if noise is not None:
        std = torch.exp(0.5 * logvar.float())
        z = mean + (std * noise.to(device=mean.device, dtype=torch.float32)).to(mean.dtype)
    if scale:
        z = (z - cfg.shift_factor) * cfg.scaling_factor
    return z


def tile_starts(n: int, tile: int, stride: int) -> List[int]:
    """Tile origins along one axis: every `stride`, plus a last tile flush
    with the end when the stride leaves the end uncovered."""
    starts = list(range(0, max(n - tile, 0) + 1, stride)) or [0]
    if starts[-1] + tile < n:
        starts.append(n - tile)
    return starts


def _blend_window(n: int, overlap: int, device) -> torch.Tensor:
    """(n, n, 1) float32 blending weights: a linear ramp over `overlap` at
    each edge. The +1 keeps the end weights strictly positive (a zero end
    weight zeroed the canvas border, which a single tile covers); dividing
    by the summed weights makes single-cover regions exact for any positive
    weight, and overlaps blend linearly."""
    ramp = torch.clamp((torch.arange(n, dtype=torch.float32, device=device) + 1.0) / overlap,
                       max=1.0)
    win1d = torch.minimum(ramp, ramp.flip(0))
    return torch.minimum(win1d[:, None], win1d[None, :])[..., None]


def vae_encode_tiled(vae: FluxVAE, images: torch.Tensor, *,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     tile: int = 64, overlap: int = 16, scale: bool = True) -> torch.Tensor:
    """Tiled encode for large canvases (bounds the mid-block attention, whose
    cost is quadratic in latent area): encode overlapping pixel tiles and
    blend the latent seams in float32. `tile`/`overlap` are in latent units.

    Each tile takes its own posterior draw, row-major: ``noise[i]`` for tile
    i when given (B, tile_h, tile_w, C), else drawn from `generator` tile by
    tile; one draw for every tile would repeat the same noise field with the
    tile stride. Neither: the posterior mode. A canvas within one tile is
    encoded whole, with ``noise[0]``."""
    if isinstance(noise, torch.Tensor):
        raise TypeError("vae_encode_tiled takes a sequence of per-tile draws, not one tensor")
    cfg = vae.cfg
    f = cfg.spatial_factor
    b, hp, wp, _ = images.shape
    h, w = hp // f, wp // f
    if h <= tile and w <= tile:
        return vae_encode(vae, images, noise=None if noise is None else noise[0],
                          generator=generator, scale=scale)
    out = torch.zeros((b, h, w, cfg.latent_channels), dtype=torch.float32, device=images.device)
    weight = torch.zeros((h, w, 1), dtype=torch.float32, device=images.device)
    win = _blend_window(tile, overlap, images.device)
    ys, xs = tile_starts(h, tile, tile - overlap), tile_starts(w, tile, tile - overlap)
    ty, tx = min(tile, h), min(tile, w)
    for i, y in enumerate(ys):
        for j, x in enumerate(xs):
            pix = images[:, y * f:(y + ty) * f, x * f:(x + tx) * f]
            eps = None if noise is None else noise[i * len(xs) + j]
            z = vae_encode(vae, pix, noise=eps, generator=generator, scale=scale).float()
            tile_win = win[:ty, :tx]
            out[:, y:y + ty, x:x + tx] += z * tile_win
            weight[y:y + ty, x:x + tx] += tile_win
    return (out / torch.clamp(weight, min=1e-6)).to(images.dtype)


def vae_decode_tiled(vae: FluxVAE, latents: torch.Tensor, *, tile: int = 64,
                     overlap: int = 16, scale: bool = True) -> torch.Tensor:
    """Tiled decode for large canvases: decode overlapping latent tiles and
    blend the seams linearly in float32. Bounds decoder activation memory
    at ~tile^2."""
    cfg = vae.cfg
    b, h, w, _ = latents.shape
    if h <= tile and w <= tile:
        return vae_decode(vae, latents, scale=scale)
    f = cfg.spatial_factor
    out = torch.zeros((b, h * f, w * f, cfg.out_channels), dtype=torch.float32,
                      device=latents.device)
    weight = torch.zeros((h * f, w * f, 1), dtype=torch.float32, device=latents.device)
    win = _blend_window(tile * f, overlap * f, latents.device)
    for y in tile_starts(h, tile, tile - overlap):
        for x in tile_starts(w, tile, tile - overlap):
            dec = vae_decode(vae, latents[:, y:y + min(tile, h), x:x + min(tile, w)],
                             scale=scale).float()
            wy, wx = dec.shape[1], dec.shape[2]
            tile_win = win[:wy, :wx]
            out[:, y * f:y * f + wy, x * f:x * f + wx] += dec * tile_win
            weight[y * f:y * f + wy, x * f:x * f + wx] += tile_win
    return (out / torch.clamp(weight, min=1e-6)).to(latents.dtype)


def vae_decode(vae: FluxVAE, latents: torch.Tensor, *, scale: bool = True) -> torch.Tensor:
    """Decode (scaled) NHWC latents to NHWC images in [-1, 1]."""
    cfg = vae.cfg
    g = cfg.norm_num_groups
    if scale:
        latents = latents / cfg.scaling_factor + cfg.shift_factor
    p = vae.decoder
    x = conv(p.conv_in, latents.permute(0, 3, 1, 2))
    x = _mid(p.mid, x, g)
    for block in p.up:
        for r in block.resnets:
            x = _resnet(r, x, g)
        if block.up is not None:
            x = conv(block.up, F.interpolate(x, scale_factor=2, mode="nearest"))
    x = conv(p.conv_out, silu(group_norm(p.norm_out, x, g)))
    return x.permute(0, 2, 3, 1)
