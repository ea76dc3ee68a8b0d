"""Shared building blocks.

Linears are ``nn.Linear`` (weights stored (out, in)), or the quantised
``io.quantize.QuantLinear`` that replaces one; ``dense`` applies either in
the input's dtype, as the JAX package's ``x @ w + b`` does, plus the LoRA
branch that ``training.train.lora_insert`` attaches. Norms compute in float32
and cast back to the activation dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.io.quantize import QuantLinear


def make_linear(d_in: int, d_out: int, *, bias: bool = True, device=None, dtype=None,
                generator: Optional[torch.Generator] = None,
                scale: Optional[float] = None) -> nn.Linear:
    """nn.Linear with the JAX package's dense_init distribution: weights
    uniform in [-1/sqrt(d_in), 1/sqrt(d_in)], zero bias. Storage is allocated
    without PyTorch's own init pass and filled from `generator`."""
    lin = torch.nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias, device=device,
                                   dtype=dtype)
    bound = 1.0 / math.sqrt(d_in) if scale is None else scale
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


class MLP(nn.Module):
    """Two linears (the JAX package's mlp_init pair); the activation is the
    caller's."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, **kw):
        super().__init__()
        self.fc1 = make_linear(d_in, d_hidden, **kw)
        self.fc2 = make_linear(d_hidden, d_out, **kw)


def ones_param(n: int, *, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, device=device, dtype=dtype))


def dense(lin: nn.Module, x: torch.Tensor, *, bias: bool = True,
          amax_reduce=None) -> torch.Tensor:
    """x @ w + b in x's dtype (a ``QuantLinear`` dequantises on read, or runs
    its w8a8 product), plus the LoRA branch when one is attached, over any
    base:

    * ``lora_a`` (in, r) / ``lora_b`` (r, out): the parallel low-rank branch
      y += (x @ A*s) @ B, with s = ``lora_scale`` (alpha/rank) folded into A;
    * ``lora_ga`` (M, in, r) / ``lora_gb`` (M, r, d): M grouped per-module
      branches (q, k, v) whose deltas land on the leading M*d output columns;
      the rest (single-block linear1's MLP tail) gets none.

    The factors are fp32 parameters cast to x's dtype for the products, and
    the frozen base is never merged with them.

    On a tensor-parallel shard (``lin.tp_share``, set by
    ``parallel.partitioning.shard_linears``) the factors stay whole (the JAX
    package replicates them) and the rank takes its share: over a
    column-parallel base the columns of B (of each group's B) that its
    output holds, in the device-major order; over a row-parallel base the
    rows of A for its input columns, so (x_r A_r) B joins the base's
    partial product before the one sum over the ranks.

    ``bias=False`` leaves the bias out (a row-parallel shard adds it after
    the sum over ranks); `amax_reduce` goes to a w8a8 ``QuantLinear``
    (``QuantLinear.matmul``)."""
    if isinstance(lin, QuantLinear):
        y = lin.matmul(x, bias=bias, amax_reduce=amax_reduce)
    else:
        b = lin.bias.to(x.dtype) if bias and lin.bias is not None else None
        y = F.linear(x, lin.weight.to(x.dtype), b)
    share = getattr(lin, "tp_share", None)
    a = getattr(lin, "lora_a", None)
    if a is not None:
        a, b = a * lin.lora_scale, lin.lora_b
        if share is not None and share.kind == "row":
            a = a.index_select(0, share.index_on(a.device))
        elif share is not None:
            b = b.index_select(1, share.index_on(b.device))
        y = y + (x @ a.to(x.dtype)) @ b.to(x.dtype)
    ga = getattr(lin, "lora_ga", None)
    if ga is not None:
        gb = lin.lora_gb
        if share is not None:
            if share.kind == "row":
                raise ValueError("grouped LoRA factors over a row-parallel base: the groups "
                                 "split the output columns")
            gb = gb[..., share.segment_part()]
        t = torch.einsum("...i,mir->...mr", x, (ga * lin.lora_scale).to(x.dtype))
        delta = torch.einsum("...mr,mrd->...md", t, gb.to(x.dtype)).flatten(-2)
        n = delta.shape[-1]
        y = delta + y if n == y.shape[-1] else torch.cat([y[..., :n] + delta, y[..., n:]], -1)
    return y


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm in float32."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with learned scale, variance in float32."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * scale.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000,
                       scale: float = 1.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order (flip_sin_to_cos=True, shift=0),
    computed in float32 regardless of the activation dtype; the angles are
    multiplied by `scale` after the frequencies (diffusers' ``Timesteps``
    ``scale``, which Qwen-Image sets to 1000)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    if scale != 1.0:
        args = args * scale
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
