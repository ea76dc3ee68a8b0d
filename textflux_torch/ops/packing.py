"""Latent token packing / unpacking and RoPE id grids.

The MM-DiT consumes images as sequences of 2x2-patch tokens over the VAE
latent grid, and the fill conditioning packs the inpainting mask by first
folding the 8x8 VAE spatial factor into channels. Feature ordering matches the
FLUX checkpoint convention (channel-major within a patch: feature =
c*4 + ph*2 + pw).

All image tensors at the port's public functions are **NHWC**, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) latent grid -> (B, H/2*W/2, C*4) token sequence.

    Token feature order is (c, ph, pw): feature[c*4 + ph*2 + pw] = latents[h*2+ph, w*2+pw, c].
    """
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # b, h/2, w/2, c, ph, pw
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, latent_height: int, latent_width: int) -> torch.Tensor:
    """(B, T, C*4) token sequence -> (B, H, W, C) latent grid (inverse of pack_latents)."""
    b, t, f = tokens.shape
    c = f // 4
    h2, w2 = latent_height // 2, latent_width // 2
    x = tokens.reshape(b, h2, w2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h/2, ph, w/2, pw, c
    return x.reshape(b, latent_height, latent_width, c)


def pack_mask(mask: torch.Tensor, spatial_factor: int = 8) -> torch.Tensor:
    """Pixel-resolution mask (B, Hpix, Wpix) -> (B, T, s*s*4) packed mask tokens.

    The s x s VAE spatial factor folds into s*s channels (channel = ph*s + pw),
    then the 2x2 token patching packs those, aligned with the image latent
    tokens so the fill conditioning is their concatenation.
    """
    s = spatial_factor
    b, hp, wp = mask.shape
    h, w = hp // s, wp // s
    x = mask.reshape(b, h, s, w, s)
    x = x.permute(0, 1, 3, 2, 4)            # b, h, w, ph, pw
    x = x.reshape(b, h, w, s * s)           # channel = ph*s + pw
    return pack_latents(x)


def latent_image_ids(latent_height: int, latent_width: int) -> np.ndarray:
    """RoPE position ids for image tokens: (T, 3) rows of (0, token_row, token_col).

    Host-side (numpy): ids are static per shape and feed the RoPE table
    precomputation.
    """
    h2, w2 = latent_height // 2, latent_width // 2
    ids = np.zeros((h2, w2, 3), dtype=np.float64)
    ids[..., 1] = np.arange(h2)[:, None]
    ids[..., 2] = np.arange(w2)[None, :]
    return ids.reshape(h2 * w2, 3)


def text_ids(seq_len: int) -> np.ndarray:
    """RoPE position ids for text tokens: all zeros (T5 tokens carry no position)."""
    return np.zeros((seq_len, 3), dtype=np.float64)
