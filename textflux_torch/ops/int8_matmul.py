"""The int8 weight-only linear: a hand-written Hopper kernel and its plain
PyTorch version.

``int8_matmul(x, w_q, scale, bias)`` is x @ (w_q * scale)^T + bias for the
``weight_only`` layout of ``io.quantize.QuantLinear`` (int8 codes (out, in),
an fp32 scale per output channel). On a CPU tensor it runs the plain
version, which dequantises the weight in x's dtype as the JAX package's
``dequantize_dense`` does; on a CUDA tensor it launches
``csrc/w8a16_gemm_sm90.cu`` (``w8a16_gemm_sm90_kernel``) or raises, and
counts the launch in ``int8_matmul.launches``. Where x needs a gradient
(QLoRA over an int8 base) the kernel is the forward of ``Int8Matmul``, an
autograd function whose backward, dx = dy @ (w_q * scale), is plain PyTorch.

The kernel replaces no TPU kernel: it was added because the plain version's
dequantise (a bf16 copy of the codes, a scaled copy, then the product and a
separate bias add) bounded the int8 serving cell. It reads the codes
straight from device memory, converts them to bf16 on chip and applies the
scale and the bias in its epilogue; its design is at the top of its source.
Its work is 2*M*N*K FLOPs against N*K bytes of codes: the serving step's
products (512 to 1,664 tokens) are bound by the tensor cores, the one- and
30-row conditioning products by the codes' bytes.

The kernel takes bf16 activations, any number of rows M >= 1, K a multiple
of 16 and N a multiple of 8 (``check_shape``), which covers every
``weight_only`` linear of the FLUX.1-Fill DiT and of T5-XXL and a
tensor-parallel rank's halves and quarters of them. Each launch tiles the
output in 128 channels by T tokens, T picked from M and N by
``token_tile``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

# tokens a tile: wgmma's N in the kernel (its instantiations)
TOKEN_TILES = (32, 64, 128, 192, 256)
CHANNEL_TILE = 128      # output channels a tile: two consumer warpgroups of 64
# a tile's cost beyond its tokens' products, in tokens: the conversion of its
# codes and the stage waits, which do not shrink with T. Fitted to the
# kernel's times at every token tile on the serving shapes (one H100 80GB
# HBM3 at 700 W, tools/int8_matmul_bench.py --sweep): 144 to 192 pick the
# fastest tile at all 20 shapes, 128 or less misses 3
TILE_OVERHEAD = 160


def check_shape(m: int, n: int, k: int) -> None:
    """Raise ValueError unless the kernel takes an (m, k) @ (n, k)^T product:
    m >= 1 rows, k a multiple of 16 (TMA's 16-byte row pitch of the codes),
    n a multiple of 8 (of the output)."""
    if m < 1 or k < 16 or k % 16 or n < 8 or n % 8:
        raise ValueError(f"the int8 kernel takes m >= 1, k a multiple of 16 and n a multiple "
                         f"of 8; got m={m}, n={n}, k={k}")


def token_tile(m: int, n: int, sms: int) -> int:
    """The token tile T for m rows and n channels on `sms` SMs: the one whose
    persistent walk costs least, counting a tile as T + TILE_OVERHEAD token
    products and the walk as the tiles' waves over the SMs. A short M takes
    the smallest tile that holds it; a long one trades larger tiles against
    a ragged last wave."""
    n_tiles = -(-n // CHANNEL_TILE)

    def cost(t: int) -> int:
        return -(-(n_tiles * -(-m // t)) // sms) * (t + TILE_OVERHEAD)

    return min(TOKEN_TILES, key=lambda t: (cost(t), t))


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the codes cast to x's dtype, times the scale
    cast to x's dtype, then the product and the bias in x's dtype (the JAX
    package's ``dequantize_dense`` then ``dense``)."""
    y = F.linear(x, w_q.to(x.dtype) * scale.to(x.dtype)[:, None])
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, tile: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, without synchronising:
    x (..., K) bf16, w_q (N, K) int8, scale (N,) fp32, bias (N,) or None
    (cast to bf16). Validates every argument and raises on what the kernel
    does not take. `tile` overrides ``token_tile``'s choice: a seam for the
    kernel's tests and ``tools/int8_matmul_bench.py --sweep``, which run
    each instantiation; no caller in the package passes it."""
    from textflux_torch.ops.cuda_build import load_library

    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 for the int8 kernel, got {x.dtype}")
    n, k = w_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} features, the codes {k}")
    if w_q.dtype != torch.int8 or not w_q.is_contiguous():
        raise ValueError("w_q must be contiguous int8 (N, K)")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous float32 ({n},) tensor")
    if bias is not None:
        bias = bias.to(torch.bfloat16)
        if tuple(bias.shape) != (n,) or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous ({n},) tensor")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    check_shape(m, n, k)
    for name, t in (("x", x2), ("w_q", w_q), ("scale", scale), ("bias", bias)):
        if t is not None and (t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"{name} must be 16-byte aligned on {x.device}")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms = _sm_count(index)
    tile = token_tile(m, n, sms) if tile is None else tile
    if tile not in TOKEN_TILES:
        raise ValueError(f"tile must be one of {TOKEN_TILES}, got {tile}")
    grid = min(-(-n // CHANNEL_TILE) * -(-m // tile), sms)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.textflux_w8a16_gemm(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                                      None if bias is None else bias.data_ptr(), y.data_ptr(),
                                      m, n, k, tile, grid, stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return y.reshape(*lead, n)


class Int8Matmul(torch.autograd.Function):
    """x @ (w_q * scale)^T + bias with a gradient for x alone (the codes,
    the scale and the bias are frozen buffers): the forward is the kernel,
    the backward dx = dy @ (w_q * scale) in dy's dtype, plain PyTorch (the
    TPU package has no kernel for it). ``int8_matmul`` applies it to CUDA
    tensors alone; its forward's plain branch on CPU tensors is a seam for
    the CPU test that holds this backward to autograd through the plain
    expression."""

    @staticmethod
    def forward(ctx, x, w_q, scale, bias):
        ctx.save_for_backward(w_q, scale)
        if x.device.type == "cuda":
            return launch(x, w_q, scale, bias)
        return int8_matmul_reference(x, w_q, scale, bias)

    @staticmethod
    def backward(ctx, dy):
        w_q, scale = ctx.saved_tensors
        dx = dy @ (w_q.to(dy.dtype) * scale.to(dy.dtype)[:, None])
        return dx, None, None, None


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ (w_q * scale)^T + bias in x's dtype: the plain version on a CPU
    tensor; on a CUDA tensor the kernel (through ``Int8Matmul`` where x
    needs a gradient), or a ValueError / TypeError for what it does not
    take."""
    if x.device.type != "cuda":
        return int8_matmul_reference(x, w_q, scale, bias)
    if torch.is_grad_enabled() and x.requires_grad:
        return Int8Matmul.apply(x, w_q, scale, bias)
    return launch(x, w_q, scale, bias)


int8_matmul.launches = 0

