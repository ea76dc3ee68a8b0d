"""3-axis rotary position embeddings for the MM-DiT joint sequence.

Tables are computed on the host in float64 (the reference's fp64 frequency
computation) and returned as float32 numpy arrays; callers move them to the
device once per shape.

Convention of ``rope_tables`` / ``apply_rope_bshd``: interleaved pairwise
rotation, each frequency repeated twice along the feature axis, rotating
(x[2i], x[2i+1]) pairs. ``rope_tables_half`` gives the rotate-half layout the
fused attention kernel uses on half-permuted q/k features.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def rope_tables(
    ids: np.ndarray,
    axes_dims: Sequence[int],
    theta: int = 10000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute cos/sin tables for 3-axis RoPE.

    Args:
      ids: (S, n_axes) float position ids.
      axes_dims: per-axis rotary dims, summing to head_dim (e.g. (16, 56, 56)).
      theta: frequency base.

    Returns:
      (cos, sin): float32 arrays of shape (S, sum(axes_dims)).
    """
    ids = np.asarray(ids, dtype=np.float64)
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        angles = np.outer(ids[:, axis], freqs)                    # (S, dim/2)
        cos_parts.append(np.repeat(np.cos(angles), 2, axis=1))    # (S, dim)
        sin_parts.append(np.repeat(np.sin(angles), 2, axis=1))
    cos = np.concatenate(cos_parts, axis=-1).astype(np.float32)
    sin = np.concatenate(sin_parts, axis=-1).astype(np.float32)
    return cos, sin


def rope_tables_half(
    ids: np.ndarray,
    axes_dims: Sequence[int],
    theta: int = 10000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate-half-layout RoPE tables for the fused attention kernel.

    With head features permuted evens-first (see ``half_permutation``), the
    interleaved rotation becomes a rotate-half rotation whose tables are the
    per-axis unique frequencies concatenated (D/2 columns) and tiled twice.
    """
    ids = np.asarray(ids, dtype=np.float64)
    parts = []
    for axis, dim in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        parts.append(np.outer(ids[:, axis], freqs))          # (S, dim/2)
    angles = np.concatenate(parts, axis=-1)                  # (S, D/2)
    cos = np.tile(np.cos(angles), (1, 2)).astype(np.float32)  # (S, D)
    sin = np.tile(np.sin(angles), (1, 2)).astype(np.float32)
    return cos, sin


def half_permutation(head_dim: int) -> np.ndarray:
    """Feature permutation mapping interleaved rope pairs (2j, 2j+1) to
    rotate-half positions (j, j + D/2): evens first, then odds."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def apply_rope_bshd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved RoPE on (B, S, H, D); the (S, D) tables broadcast over
    batch and heads. Computes in float32 and casts back to x's dtype."""
    xf = x.float()
    pairs = xf.reshape(*x.shape[:-1], -1, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    out = xf * cos[None, :, None, :] + rotated * sin[None, :, None, :]
    return out.to(x.dtype)
