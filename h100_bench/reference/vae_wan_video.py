"""The plain float32 reference of the Wan-2.1 VAE over a clip: the causal temporal path.

Plain PyTorch, written from diffusers' ``AutoencoderKLWan`` in the layout of
the program's parameters (``vae_wan.WanVAE``'s names; its pieces are
imported, not edited). Departure from the published code, which runs the
clip in chunks (frame 0 alone, then 4 frames; one latent frame a chunk
when decoding) and carries each causal convolution's last two input frames
from chunk to chunk: this runs the whole clip at once, in the form those
chunks compute.

* every causal 3-D convolution is one ``conv3d`` over the clip with two
  zero frames before frame 0;
* downsampling in time (``time_conv``, stride 2, no padding) keeps frame 0
  and adds one frame for each window (2j, 2j + 1, 2j + 2) of the clip's
  frames;
* upsampling in time keeps frame 0 and runs ``time_conv`` causally over
  frames 1 on (two zero frames before frame 1), each output's two halves
  of channels becoming two frames;
* the middle attention, the spatial resampling and the norms act frame by
  frame.

So 1 + 4k frames encode to 1 + k latent frames and decode back, as the
chunks do. float32, TF32 off; nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from h100_bench.reference import models as M
from h100_bench.reference import vae_wan as W


def cconv(p, x, stride: int = 1):
    """A causal 3-D convolution over the whole clip (B, C, T, H, W)."""
    if getattr(p, "fp8_inputs", False):
        x = M.fp8_tensor(x)
    w = p.weight
    kt, ph = w.shape[2], w.shape[3] // 2
    pad_t = kt - 1 if stride == 1 else 0
    return F.conv3d(F.pad(x, (ph, ph, ph, ph, pad_t, 0)), w, p.bias, stride=(stride, 1, 1))


def frames(fn, x):
    """`fn` (NCHW -> NCHW) on every frame of x (B, C, T, H, W)."""
    b, c, t, h, w = x.shape
    y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


def rms3(p, x):
    return F.normalize(x, dim=1) * math.sqrt(x.shape[1]) * p.scale[:, None, None, None]


def res3(p: W.Res, x):
    h = cconv(p.conv1, F.silu(rms3(p.norm1, x)))
    h = cconv(p.conv2, F.silu(rms3(p.norm2, h)))
    return (x if p.shortcut is None else cconv(p.shortcut, x)) + h


def attn(p: W.Attn, x):
    b, c, hh, ww = x.shape
    q, k, v = W.conv(p.qkv, W.rms(p.norm, x)).reshape(b, 3 * c, -1).transpose(1, 2).chunk(3, -1)
    o = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), -1) @ v
    return x + W.conv(p.proj, o.transpose(1, 2).reshape(b, c, hh, ww))


def mid3(p: W.Mid, x):
    return res3(p.res2, frames(lambda f: attn(p.attn, f), res3(p.res1, x)))


def resample3(p: W.Resample, x):
    if p.mode == "upsample3d" and x.shape[2] > 1:
        b, c, t, h, w = x.shape
        y = cconv(p.time_conv, x[:, :, 1:])
        y = torch.stack(y.reshape(b, 2, c, t - 1, h, w).unbind(1), 3).reshape(b, c, 2 * t - 2, h, w)
        x = torch.cat([x[:, :, :1], y], 2)
    x = frames(lambda f: W.resample(p, f), x)
    if p.mode == "downsample3d" and x.shape[2] > 1:
        x = torch.cat([x[:, :, :1], cconv(p.time_conv, x, stride=2)], 2)
    return x


@torch.inference_mode()
def encode(vae: W.WanVAE, video):
    """NTHWC clips (B, 1 + 4k, H, W, 3) in [-1, 1] -> the posterior mean,
    normalised (z - mean) / std, NTHWC (B, 1 + k, H/8, W/8, 16) float32."""
    p = vae.encoder
    x = cconv(p.conv_in, video.permute(0, 4, 1, 2, 3).float())
    for blk in p.down:
        x = resample3(blk, x) if isinstance(blk, W.Resample) else res3(blk, x)
    x = cconv(p.conv_out, F.silu(rms3(p.norm_out, mid3(p.mid, x))))
    mu = cconv(vae.quant_conv, x)[:, :vae.cfg["z_dim"]].permute(0, 2, 3, 4, 1)
    mean, std = W._stats(vae.cfg, video.device)
    return (mu - mean) / std


@torch.inference_mode()
def decode(vae: W.WanVAE, latents):
    """Normalised NTHWC latents (B, 1 + k, h, w, 16) -> NTHWC clips (B,
    1 + 4k, 8h, 8w, 3) clamped to [-1, 1]."""
    mean, std = W._stats(vae.cfg, latents.device)
    z = (latents.float() * std + mean).permute(0, 4, 1, 2, 3)
    p = vae.decoder
    x = mid3(p.mid, cconv(p.conv_in, cconv(vae.post_quant_conv, z)))
    for blk in p.up:
        for r in blk.resnets:
            x = res3(r, x)
        if blk.up is not None:
            x = resample3(blk.up, x)
    x = cconv(p.conv_out, F.silu(rms3(p.norm_out, x)))
    return x.clamp(-1.0, 1.0).permute(0, 2, 3, 4, 1)
