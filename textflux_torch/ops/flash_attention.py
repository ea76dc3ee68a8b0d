"""Fused per-head RMSNorm + rotate-half RoPE + softmax attention.

``flash_attention_qk_norm_rope`` is the attention of every MM-DiT block on the
fused path. On a CUDA tensor it launches the hand-written Hopper kernel in
``textflux_torch/csrc/fused_attention.cu`` (or raises); on a CPU tensor it runs
``flash_attention_qk_norm_rope_reference``, the plain PyTorch version of the
same arithmetic.

The kernel replaces the Pallas TPU kernel
``textflux_tpu/ops/flash_attention.py::_fused_kernel``. At the serving shape
(B=1, S=1408, H=24, D=128) its work is 4*S*S*D*H ~ 24.4 GFLOP (~25 us at the
H100's 989 TFLOP/s bf16) against ~37.5 MB of q/k/v/o and tables (~11 us at
3.35 TB/s): it is bound by tensor-core operations. Its design against that
bound is described at the top of the CUDA source: q/k normed and roped once
per row, both products on the tensor cores, K/V tiles double-buffered with
cp.async, Q fragments held in registers, P passed to the P*V product in
registers, scores never written to memory.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG2_E = 1.4426950408889634
SUPPORTED_HEAD_DIMS = (64, 128)


def fold_tables(cos: torch.Tensor, sin: torch.Tensor, q_scale: torch.Tensor,
                k_scale: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Fold the learned RMSNorm scales and the rotate-half sign into the rope
    tables: out_j = xn_j*cos2_j + roll(xn, D/2)_j*sin2_j with
    cos2 = scale*cos and sin2 = sign*roll(scale, D/2)*sin.

    cos, sin: (S, D) rotate-half tables. q_scale, k_scale: (D,) shared or
    (S, D) per-row. Returns fp32 (cos_q, sin_q, cos_k, sin_k), each (S, D)
    and contiguous."""
    s, d = cos.shape
    cosf, sinf = cos.float(), sin.float()
    sign = torch.where(torch.arange(d, device=cos.device) < d // 2, -1.0, 1.0)
    out = []
    for scale in (q_scale, k_scale):
        sf = scale.float()
        out.append((cosf * sf).expand(s, d).contiguous())
        out.append((sign * torch.roll(sf, d // 2, dims=-1) * sinf).expand(s, d).contiguous())
    return tuple(out)


def _norm_rope(x: torch.Tensor, cos2: torch.Tensor, sin2: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 RMSNorm + rotate-half RoPE on (B, H, S, D) with folded tables."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    xn = x * torch.rsqrt(var + eps)
    return xn * cos2 + torch.roll(xn, x.shape[-1] // 2, dims=-1) * sin2


def _reference_folded(q, k, v, cos_q, sin_q, cos_k, sin_k, kv_len: int,
                      eps: float) -> torch.Tensor:
    d = q.shape[-1]
    # (B, S, H, D) -> (B, H, S, D)
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    qn = (_norm_rope(qf, cos_q, sin_q, eps) * (LOG2_E / math.sqrt(d))).to(v.dtype)
    kn = _norm_rope(kf, cos_k, sin_k, eps).to(v.dtype)
    s = torch.matmul(qn.float(), kn.float().transpose(-1, -2))   # log2 units
    if kv_len < k.shape[1]:
        col = torch.arange(k.shape[1], device=q.device)
        s = torch.where(col < kv_len, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def flash_attention_qk_norm_rope_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cos: torch.Tensor, sin: torch.Tensor,
    q_scale: torch.Tensor, k_scale: torch.Tensor,
    *, kv_len: Optional[int] = None, eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same table folding, the same
    casts (normed q/k rounded to v's dtype, probabilities rounded to v's
    dtype before the P*V product, fp32 accumulation) and the same exp2
    softmax with the max subtracted. One pass over all keys instead of the
    kernel's tiles, so sums are taken in another order."""
    kv_len = q.shape[1] if kv_len is None else int(kv_len)
    return _reference_folded(q, k, v, *fold_tables(cos, sin, q_scale, k_scale),
                             kv_len=kv_len, eps=eps)


def _check_bshd(name: str, x: torch.Tensor, shape, d: int, align: int) -> None:
    """The kernel reads q/k in 4-byte and v in 16-byte pieces: `align`
    elements of bf16 must divide the batch/sequence strides and the start."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if (x.stride(3) != 1 or x.stride(2) != d or x.stride(1) % align
            or x.stride(0) % align):
        raise ValueError(
            f"{name} needs unit feature stride, head stride {d} and sequence/batch "
            f"strides that are multiples of {align}; got strides {x.stride()}")
    if x.data_ptr() % (2 * align):
        raise ValueError(f"{name} must be {2 * align}-byte aligned")


def launch_folded(q, k, v, cos_q, sin_q, cos_k, sin_k, *, kv_len: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on already-folded tables (see fold_tables): a
    norm+rope pass into bf16 scratch, then the attention pass, on the
    current stream, without synchronising. Validates every argument and
    raises on what the kernel does not take."""
    from textflux_torch.ops.cuda_build import load_library

    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel supports head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    for name, x, align in (("q", q, 2), ("k", k, 2), ("v", v, 8)):
        _check_bshd(name, x, (b, s, h, d), d, align)
    for name, t in (("cos_q", cos_q), ("sin_q", sin_q), ("cos_k", cos_k), ("sin_k", sin_k)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (s, d) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({s}, {d}) tensor "
                             f"on {q.device}")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must be in [1, {s}], got {kv_len}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    # scratch for the normed, roped q'/k' rows, and the output
    qn, kn, out = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                   for _ in range(3))
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.textflux_fused_norm_rope_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            cos_q.data_ptr(), sin_q.data_ptr(), cos_k.data_ptr(), sin_k.data_ptr(),
            qn.data_ptr(), kn.data_ptr(), out.data_ptr(), b, s, h, d, kv_len,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(eps), LOG2_E / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA error {err}")
    flash_attention_qk_norm_rope.launches += 1
    return out


def flash_attention_qk_norm_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cos: torch.Tensor, sin: torch.Tensor,
    q_scale: torch.Tensor, k_scale: torch.Tensor,
    *, kv_len: Optional[int] = None, eps: float = 1e-6,
) -> torch.Tensor:
    """Fully fused attention over BSHD q/k/v.

    Requires q/k features in the rotate-half permutation (see
    ``ops.rope.half_permutation``, folded into the q/k weight columns at load
    time) and ``rope_tables_half`` tables.

    Args:
      q, k, v: (B, S, H, D); q and k raw (before norm and rope).
      cos, sin: (S, D) rotate-half tables.
      q_scale, k_scale: RMSNorm scales, already permuted: (D,) shared or
        (S, D) per row (the double blocks use different txt/img norms).
      kv_len: keys at index >= kv_len are masked out (sequence padding).

    CPU tensors run the plain version; CUDA tensors launch the kernel, whose
    launches are counted in ``flash_attention_qk_norm_rope.launches``.
    """
    kv_len = q.shape[1] if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= q.shape[1]:
        raise ValueError(f"kv_len must be in [1, {q.shape[1]}], got {kv_len}")
    tables = fold_tables(cos, sin, q_scale, k_scale)
    if q.device.type == "cpu":
        return _reference_folded(q, k, v, *tables, kv_len=kv_len, eps=eps)
    return launch_folded(q, k, v, *tables, kv_len=kv_len, eps=eps)


flash_attention_qk_norm_rope.launches = 0
