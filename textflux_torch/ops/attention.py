"""Multi-head attention over (batch, seq, heads, head_dim) tensors.

``plain_attention`` is the counterpart of the JAX package's
``_xla_attention``: float32 logits, a ``kv_len`` key mask, float32 softmax,
probabilities rounded to v's dtype, float32 accumulation, output in q's
dtype. ``dot_product_attention`` dispatches between it and ``"flash"``, the
``FlashAttention`` autograd function over the kernels of
``ops.flash_attention`` (the counterpart of the JAX package's
``_flash_differentiable`` custom VJP). The model's ``"fused"`` serving path
goes through ``ops.flash_attention.flash_attention_qk_norm_rope`` instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from textflux_torch.ops import flash_attention as FA

IMPLS = ("auto", "plain", "flash")


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


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """The kernels read rows with unit feature stride and head stride D;
    an upstream gradient in any other layout is copied into that one."""
    d = x.shape[-1]
    if x.stride(3) == 1 and x.stride(2) == d and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0:
        return x
    return x.contiguous()


class FlashAttention(torch.autograd.Function):
    """Flash attention with the hand-written backward.

    Forward: the forward kernel; q, k, v and O are saved. Backward: the LSE
    kernel, Dvec = rowsum(dO o O) in plain torch, then the dQ and the dK/dV
    kernels (``ops.flash_attention.flash_attention_bwd``). On CPU tensors
    each kernel's plain version runs instead. Under
    ``torch.utils.checkpoint`` the forward runs again in the recompute, so a
    checkpointed block launches the forward kernel twice per step."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        o = FA.flash_attention(q, k, v, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o)
        ctx.kv_len = kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, o, _kernel_layout(do), kv_len=ctx.kv_len)
        return dq, dk, dv, None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          impl: str = "auto", kv_len: Optional[int] = None) -> torch.Tensor:
    """Scaled dot-product attention over BSHD tensors.

    impl: "flash" (the kernels and their backward through ``FlashAttention``),
    "plain" (``plain_attention``, differentiated by autograd), or "auto":
    "flash" on CUDA tensors at every sequence length, "plain" on the CPU.
    kv_len: keys at index >= kv_len are masked out."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "plain"
    if impl == "flash":
        return FlashAttention.apply(q, k, v, kv_len)
    return plain_attention(q, k, v, kv_len=kv_len)
