"""Plain multi-head attention over (batch, seq, heads, head_dim) tensors.

The counterpart of the JAX package's ``_xla_attention``: float32 logits, a
``kv_len`` key mask, float32 softmax, probabilities rounded to v's dtype,
float32 accumulation, output in q's dtype. The model's ``"plain"`` attention
path uses it; the ``"fused"`` path goes through
``ops.flash_attention.flash_attention_qk_norm_rope``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Unfused reference attention on BSHD tensors; keys at index >= kv_len
    are masked out (padded queries still produce outputs, callers drop them)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None:
        mask = torch.arange(k.shape[1], device=k.device) < kv_len
        logits = torch.where(mask[None, None, None, :], logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
