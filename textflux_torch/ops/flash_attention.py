"""Hand-written Hopper attention kernels and their plain PyTorch versions.

Two families, each wrapper launching its kernel on CUDA tensors (or raising)
and running its plain version on CPU tensors, with an integer launch count
on the wrapper (``<wrapper>.launches``). One wgmma / TMA attention mainloop
(``csrc/flash_fwd_sm90.cu``, ``flash_fwd_sm90_kernel``) serves both
families' forward.

``flash_attention_qk_norm_rope`` is the attention of every MM-DiT block on
the fused serving path. It replaces the Pallas TPU kernel
``textflux_tpu/ops/flash_attention.py::_fused_kernel``, in two launches: a
norm+rope pass (``csrc/fused_attention.cu``) that writes q', k' once per row
into bf16 scratch (``norm_rope_prep`` launches it alone, for timing), then
the forward mainloop on q', k' and v. At the serving shape (B=1, S=1408,
H=24, D=128) its work is 4*S*S*D*H ~ 24.4 GFLOP (~25 us at the H100's 989
TFLOP/s bf16) against ~37.5 MB of q/k/v/o and tables (~11 us at 3.35 TB/s):
it is bound by tensor-core operations.

``flash_attention_fwd`` (O and the row log-sum-exp L in one launch),
``flash_attention`` (O alone) and the backward passes ``flash_attention_lse``,
``flash_attention_dq`` and ``flash_attention_dkv`` are the training path's
attention, composed into a gradient by ``flash_attention_bwd`` and
``ops.attention.FlashAttention``. They replace the Pallas kernels
``_flash_kernel``, ``_lse_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` of the
same JAX module. At the training shape (B=1, S=4224, H=24, D=128) each is
bound by tensor-core operations (4, 2, 6 and 8 x B*H*S*kv*D FLOPs: 0.22 to
0.44 ms at the bf16 peak, against 0.016 to 0.046 ms of memory traffic), and
on Hopper only wgmma reaches that peak:

- the forward, dQ and dK/dV kernels (``csrc/flash_fwd_sm90.cu``,
  ``csrc/flash_bwd_sm90.cu``, helpers in ``csrc/sm90_common.cuh``) run
  every product on wgmma: a producer warpgroup streams 128-byte swizzled
  tiles in by TMA through an mbarrier ring, two consumer warpgroups of 64
  rows each keep P (and dS) in registers as the A operand of the next
  product. No atomics: outputs are bitwise the same from run to run;
- the forward writes L beside O, so the autograd function hands L to the
  backward, and the LSE pass (the forward's mainloop with V's loads, P*V
  and the O epilogue compiled out) runs only when ``flash_attention_bwd``
  is given no L.

The design of each is at the top of its CUDA source.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from textflux_torch.utils.tracking import span

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


def _prep_reference(q, k, cos_q, sin_q, cos_k, sin_k, eps: float, dtype):
    """q' (times log2(e)/sqrt(D)) and k', normed and roped in fp32 and
    rounded to `dtype`, as (B, H, S, D)."""
    d = q.shape[-1]
    # (B, S, H, D) -> (B, H, S, D)
    qn = (_norm_rope(q.float().transpose(1, 2), cos_q, sin_q, eps)
          * (LOG2_E / math.sqrt(d))).to(dtype)
    kn = _norm_rope(k.float().transpose(1, 2), cos_k, sin_k, eps).to(dtype)
    return qn, kn


def _reference_folded(q, k, v, cos_q, sin_q, cos_k, sin_k, kv_len: int,
                      eps: float) -> torch.Tensor:
    qn, kn = _prep_reference(q, k, cos_q, sin_q, cos_k, sin_k, eps, v.dtype)
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
    """A kernel reads rows in `align`-element (2*align-byte) pieces: `align`
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


def _check_folded(q, k, v, cos_q, sin_q, cos_k, sin_k) -> None:
    """What the fused kernel's launches take: q, k read in 4-byte pieces by
    the prep, v (when given) read by TMA in 16-byte pieces, fp32 tables."""
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel supports head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    for name, x, align in (("q", q, 2), ("k", k, 2), ("v", v, 8)):
        if x is not None:
            _check_bshd(name, x, (b, s, h, d), d, align)
    for name, t in (("cos_q", cos_q), ("sin_q", sin_q), ("cos_k", cos_k), ("sin_k", sin_k)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (s, d) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({s}, {d}) tensor "
                             f"on {q.device}")
    if k.device != q.device or (v is not None and v.device != q.device):
        raise ValueError("q, k and v must be on one device")


def launch_folded(q, k, v, cos_q, sin_q, cos_k, sin_k, *, kv_len: int,
                  eps: float = 1e-6, kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on already-folded tables (see fold_tables): a
    norm+rope pass into bf16 scratch, then the attention mainloop, on the
    current stream, without synchronising. Validates every argument and
    raises on what the kernel does not take. `kv_lens`, when given, is a
    device int32 (B,) tensor of key lengths that the kernel reads in
    `kv_len`'s place (each must lie in [1, S]; read on the device, so not
    checked here)."""
    from textflux_torch.ops.cuda_build import load_library

    b, s, h, d = q.shape
    _check_folded(q, k, v, cos_q, sin_q, cos_k, sin_k)
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must be in [1, {s}], got {kv_len}")
    if kv_lens is not None:
        _check_kv_lens(kv_lens, b, q.device)
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
            float(eps), LOG2_E / math.sqrt(d), None if kv_lens is None else kv_lens.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA error {err}")
    flash_attention_qk_norm_rope.launches += 1
    return out


def norm_rope_prep(q, k, cos_q, sin_q, cos_k, sin_k, *, eps: float = 1e-6):
    """The fused kernel's first pass alone, on folded tables: (q', k') as
    (B, S, H, D) in q's dtype, q' times log2(e)/sqrt(D). On the serving path
    ``launch_folded`` runs this pass inside its one call; this entry exists
    so that the pass can be timed and checked on its own, and counts no
    launch. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        qn, kn = _prep_reference(q, k, cos_q, sin_q, cos_k, sin_k, eps, q.dtype)
        return qn.transpose(1, 2).contiguous(), kn.transpose(1, 2).contiguous()
    from textflux_torch.ops.cuda_build import load_library

    b, s, h, d = q.shape
    _check_folded(q, k, None, cos_q, sin_q, cos_k, sin_k)
    qn, kn = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        err = load_library().textflux_norm_rope_prep(
            q.data_ptr(), k.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(), cos_k.data_ptr(),
            sin_k.data_ptr(), qn.data_ptr(), kn.data_ptr(), b, s, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), float(eps),
            LOG2_E / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"norm+rope prep launch failed: CUDA error {err}")
    return qn, kn


def _check_kv_lens(kv_lens: torch.Tensor, b: int, device) -> None:
    if (kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (b,)
            or kv_lens.device != device or not kv_lens.is_contiguous()):
        raise ValueError(f"kv_len as a tensor must be a contiguous int32 ({b},) tensor on "
                         f"{device}")


def flash_attention_qk_norm_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cos: torch.Tensor, sin: torch.Tensor,
    q_scale: torch.Tensor, k_scale: torch.Tensor,
    *, kv_len=None, eps: float = 1e-6,
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
      kv_len: keys at index >= kv_len are masked out (sequence padding): an
        int, or an int32 (B,) tensor on q's device of each sample's key
        length, which the kernel reads on the device (a CUDA graph then
        replays with lengths other than those it was captured with).

    CPU tensors run the plain version; CUDA tensors launch the kernel, whose
    launches are counted in ``flash_attention_qk_norm_rope.launches``.
    """
    with span("attn.fused"):
        tables = fold_tables(cos, sin, q_scale, k_scale)
        if isinstance(kv_len, torch.Tensor):
            _check_kv_lens(kv_len, q.shape[0], q.device)
            if q.device.type == "cpu":
                return torch.cat([_reference_folded(q[i:i + 1], k[i:i + 1], v[i:i + 1], *tables,
                                                    kv_len=int(n), eps=eps)
                                  for i, n in enumerate(kv_len.tolist())])
            return launch_folded(q, k, v, *tables, kv_len=q.shape[1], eps=eps, kv_lens=kv_len)
        kv_len = q.shape[1] if kv_len is None else int(kv_len)
        if not 1 <= kv_len <= q.shape[1]:
            raise ValueError(f"kv_len must be in [1, {q.shape[1]}], got {kv_len}")
        if q.device.type == "cpu":
            return _reference_folded(q, k, v, *tables, kv_len=kv_len, eps=eps)
        return launch_folded(q, k, v, *tables, kv_len=kv_len, eps=eps)


flash_attention_qk_norm_rope.launches = 0


# ---------------------------------------------------------------------------
# Wan's attention: q/k RMSNorm across heads, interleaved RoPE or none
# ---------------------------------------------------------------------------

def across_heads_prep_reference(x: torch.Tensor, weight: torch.Tensor,
                                cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], *,
                                eps: float, mul: float, dtype) -> torch.Tensor:
    """Plain version of the across-heads prep on (B, S, H, D): x times
    rsqrt(mean of x^2 over the token's H*D features + eps) times `weight`
    (H*D,), then the interleaved RoPE of the (S, D) tables when given,
    times `mul`; float32 inside, rounded once to `dtype`, (B, S, H, D)."""
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h * d)
    xn = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
          * weight.float()).reshape(b, s, h, d)
    if cos is not None:
        pairs = xn.reshape(b, s, h, d // 2, 2)
        rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(b, s, h, d)
        xn = xn * cos.float()[None, :, None] + rotated * sin.float()[None, :, None]
    return (xn * mul).to(dtype)


def across_heads_attention_reference(q, k, v, q_weight, k_weight, cos=None, sin=None, *,
                                     eps: float = 1e-6) -> torch.Tensor:
    """Plain version of ``attn_self`` / ``attn_cross``: the prep of q (times
    log2(e)/sqrt(D)) and of k rounded to v's dtype, then an exp2 softmax
    with the max subtracted over every key, probabilities rounded to v's
    dtype before P*V, fp32 accumulation; (B, Sq, H, D) in q's dtype. One
    pass over all keys instead of the kernel's tiles."""
    d = q.shape[-1]
    qn = across_heads_prep_reference(q, q_weight, cos, sin, eps=eps, mul=LOG2_E / math.sqrt(d),
                                     dtype=v.dtype)
    kn = across_heads_prep_reference(k, k_weight, cos, sin, eps=eps, mul=1.0, dtype=v.dtype)
    s = torch.matmul(qn.float().transpose(1, 2), kn.float().permute(0, 2, 3, 1))
    p = torch.exp2(s - torch.amax(s, dim=-1, keepdim=True))
    acc = torch.matmul(p.to(v.dtype).float(), _bhsd(v))
    return _bshd(acc / torch.clamp(p.sum(-1, keepdim=True), min=1e-30), q.dtype)


def _check_across(q, k, v, q_weight, k_weight, cos, sin) -> None:
    """What the across-heads launches take: q, k read in 8-byte pieces by
    the prep, v (when given) by TMA in 16-byte pieces, fp32 weights and
    tables."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel supports head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    _check_bshd("q", q, (b, sq, h, d), d, 4)
    _check_bshd("k", k, (b, sk, h, d), d, 4)
    if v is not None:
        _check_bshd("v", v, (b, sk, h, d), d, 8)
    for name, t, shape in (("q_weight", q_weight, (h * d,)), ("k_weight", k_weight, (h * d,)),
                           ("cos", cos, (sq, d)), ("sin", sin, (sq, d))):
        if t is not None and (t.device != q.device or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {q.device}")
    if (cos is None) != (sin is None) or (cos is not None and sk != sq):
        raise ValueError("RoPE takes both tables, and keys as many as the queries")


def _across_args(q, k, q_weight, k_weight, cos, sin):
    return (q_weight.float().contiguous(), k_weight.float().contiguous(),
            None if cos is None else cos.float().contiguous(),
            None if sin is None else sin.float().contiguous())


def across_heads_prep(q, k, q_weight, k_weight, cos=None, sin=None, *, eps: float = 1e-6):
    """The across-heads prep alone (q' times log2(e)/sqrt(D), and k'), as
    (B, S, H, D) in q's dtype: ``attn_self`` and ``attn_cross`` run it
    inside their one call; this entry exists so that the pass can be timed
    and checked on its own, and counts no launch. CPU tensors run the plain
    version."""
    d = q.shape[-1]
    if q.device.type == "cpu":
        return (across_heads_prep_reference(q, q_weight, cos, sin, eps=eps,
                                            mul=LOG2_E / math.sqrt(d), dtype=q.dtype),
                across_heads_prep_reference(k, k_weight, cos, sin, eps=eps, mul=1.0,
                                            dtype=q.dtype))
    from textflux_torch.ops.cuda_build import load_library

    wq, wk, cos, sin = _across_args(q, k, q_weight, k_weight, cos, sin)
    _check_across(q, k, None, wq, wk, cos, sin)
    b, sq, h, _ = q.shape
    qn, kn = torch.empty_like(q, memory_format=torch.contiguous_format), torch.empty(
        (b, k.shape[1], h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().textflux_across_heads_prep(
            q.data_ptr(), k.data_ptr(), wq.data_ptr(), wk.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            qn.data_ptr(), kn.data_ptr(), b, sq, k.shape[1], h, d, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), float(eps), LOG2_E / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"across-heads prep launch failed: CUDA error {err}")
    return qn, kn


def _across_heads(q, k, v, q_weight, k_weight, cos, sin, eps: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return across_heads_attention_reference(q, k, v, q_weight, k_weight, cos, sin, eps=eps)
    from textflux_torch.ops.cuda_build import load_library

    wq, wk, cos, sin = _across_args(q, k, q_weight, k_weight, cos, sin)
    _check_across(q, k, v, wq, wk, cos, sin)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qn, out = (torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device) for _ in range(2))
    kn = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().textflux_across_heads_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wq.data_ptr(), wk.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            qn.data_ptr(), kn.data_ptr(), out.data_ptr(), b, sq, sk, h, d,
            *_strides(q, k, v), float(eps), LOG2_E / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"across-heads attention launch failed: CUDA error {err}")
    return out


def attn_self(q, k, v, q_weight, k_weight, cos, sin, *, eps: float = 1e-6) -> torch.Tensor:
    """Wan's self-attention over BSHD q/k/v (raw q and k, from their
    linears): q and k RMS-normed across each token's heads with the
    (H*D,) weights, interleaved RoPE of the (S, D) tables, softmax
    attention over every key; (B, S, H, D) in q's dtype. CUDA tensors run
    the across-heads prep and the forward mainloop
    (``flash_fwd_sm90_kernel``), counted in ``attn_self.launches``; CPU
    tensors the plain version."""
    with span("attn.self"):
        out = _across_heads(q, k, v, q_weight, k_weight, cos, sin, eps)
    if q.device.type == "cuda":
        attn_self.launches += 1
    return out


def attn_cross(q, k, v, q_weight, k_weight, *, eps: float = 1e-6) -> torch.Tensor:
    """Wan's cross-attention: q (B, Sq, H, D) from the video tokens, k and v
    (B, Sk, H, D) from the text's; q and k RMS-normed across heads, no
    RoPE, softmax attention over every key; (B, Sq, H, D) in q's dtype.
    CUDA tensors run the prep and ``flash_fwd_cross_sm90_kernel``, counted
    in ``attn_cross.launches``; CPU tensors the plain version."""
    with span("attn.cross"):
        out = _across_heads(q, k, v, q_weight, k_weight, None, None, eps)
    if q.device.type == "cuda":
        attn_cross.launches += 1
    return out


attn_self.launches = attn_cross.launches = 0


# ---------------------------------------------------------------------------
# Plain flash attention: the training forward and its three backward passes
# ---------------------------------------------------------------------------

def _key_mask(kv_len: int, sk: int, device) -> torch.Tensor:
    return torch.arange(sk, device=device) < kv_len


def _scores(q: torch.Tensor, k: torch.Tensor, kv_len: int, mul: float) -> torch.Tensor:
    """fp32 (B, H, S, Sk) scores q k^T * mul, keys >= kv_len set to -1e30."""
    s = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * mul
    if kv_len < k.shape[1]:
        s = torch.where(_key_mask(kv_len, k.shape[1], q.device), s, torch.full_like(s, -1e30))
    return s


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.float().transpose(1, 2)


def _bshd(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).transpose(1, 2).contiguous()


def _probs(q, k, lse, kv_len) -> torch.Tensor:
    """P = exp(s - L) with masked keys exactly 0, fp32 (B, H, S, Sk)."""
    d = q.shape[-1]
    p = torch.exp(_scores(q, k, kv_len, 1.0 / math.sqrt(d)) - lse[..., None])
    if kv_len < k.shape[1]:
        p = torch.where(_key_mask(kv_len, k.shape[1], q.device), p, torch.zeros_like(p))
    return p


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              *, kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of the forward kernel: scores scaled by log2(e)/sqrt(D)
    in fp32, an exp2 softmax with the max subtracted, probabilities rounded
    to v's dtype before P*V, fp32 accumulation, output in q's dtype. One
    pass over all keys instead of the kernel's tiles."""
    kv_len = q.shape[1] if kv_len is None else int(kv_len)
    s = _scores(q, k, kv_len, LOG2_E / math.sqrt(q.shape[-1]))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _bhsd(v))
    return _bshd(acc / torch.clamp(l, min=1e-30), q.dtype)


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  *, kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of the LSE kernel: L = m + log(sum exp(s - m)), natural
    log, s = q k^T / sqrt(D) with masked keys; fp32 (B, H, S)."""
    kv_len = q.shape[1] if kv_len is None else int(kv_len)
    s = _scores(q, k, kv_len, 1.0 / math.sqrt(q.shape[-1]))
    m = torch.amax(s, dim=-1, keepdim=True)
    l = torch.sum(torch.exp(s - m), dim=-1, keepdim=True)
    return (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]


def flash_attention_dq_reference(q, k, v, do, lse, dvec, *,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of the dQ kernel: P = exp(s - L), dS = P o (dO v^T -
    Dvec) rounded to v's dtype, dQ = dS k / sqrt(D) in fp32, out in q's dtype."""
    kv_len = q.shape[1] if kv_len is None else int(kv_len)
    p = _probs(q, k, lse, kv_len)
    ds = p * (torch.matmul(_bhsd(do), _bhsd(v).transpose(-1, -2)) - dvec[..., None])
    dq = torch.matmul(ds.to(v.dtype).float(), _bhsd(k)) / math.sqrt(q.shape[-1])
    return _bshd(dq, q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, dvec, *,
                                  kv_len: Optional[int] = None):
    """Plain version of the dK/dV kernel: dV = P^T dO with P rounded to v's
    dtype, dK = dS^T q / sqrt(D) with dS rounded to v's dtype; key rows >=
    kv_len come out 0. Returns (dk in k's dtype, dv in v's dtype)."""
    kv_len = q.shape[1] if kv_len is None else int(kv_len)
    p = _probs(q, k, lse, kv_len)
    dof = _bhsd(do)
    ds = p * (torch.matmul(dof, _bhsd(v).transpose(-1, -2)) - dvec[..., None])
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(v.dtype).float().transpose(-1, -2), _bhsd(q)) / math.sqrt(q.shape[-1])
    return _bshd(dk, k.dtype), _bshd(dv, v.dtype)


def attention_dvec(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Dvec_i = rowsum(dO o O), fp32 (B, H, S): computed outside the kernels,
    as the JAX package computes it outside Pallas."""
    return torch.sum(do.float() * o.float(), dim=-1).transpose(1, 2).contiguous()


def _check_kv_len(kv_len: Optional[int], s: int) -> int:
    kv_len = s if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must be in [1, {s}], got {kv_len}")
    return kv_len


def _check_rows(x: torch.Tensor, name: str, shape, device) -> None:
    if (x.device != device or x.dtype != torch.float32 or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {tuple(shape)} tensor on {device}")


def _check_inputs(named, shape) -> None:
    """Every (B, S, H, D) operand of the flash kernels: bf16 on one CUDA
    device, unit feature stride, head stride D, rows 16-byte aligned."""
    d = shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels support head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    device = named[0][1].device
    for name, x in named:
        _check_bshd(name, x, shape, d, 8)
        if x.device != device:
            raise ValueError("all operands must be on one device")


def _launch(entry: str, *args) -> None:
    from textflux_torch.ops.cuda_build import load_library

    err = getattr(load_library(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _strides(*xs) -> tuple:
    return tuple(s for x in xs for s in (x.stride(0), x.stride(1)))


def _forward(q, k, v, kv_len: Optional[int], with_lse: bool):
    b, s, h, d = q.shape
    kv_len = _check_kv_len(kv_len, s)
    if q.device.type == "cpu":
        o = flash_attention_reference(q, k, v, kv_len=kv_len)
        return o, (flash_attention_lse_reference(q, k, kv_len=kv_len) if with_lse else None)
    _check_inputs((("q", q), ("k", k), ("v", v)), q.shape)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        _launch("textflux_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, h, d, kv_len,
                *_strides(q, k, v), LOG2_E / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, kv_len: Optional[int] = None):
    """(O, L): softmax attention over BSHD q/k/v (keys >= kv_len masked),
    O in q's dtype, and the natural-log row log-sum-exp L of the scaled,
    masked scores, fp32 (B, H, S), which the backward takes. CUDA tensors
    launch the forward kernel once, writing both (counted in
    ``flash_attention.launches``); CPU tensors run the plain forward and
    the plain LSE."""
    return _forward(q, k, v, kv_len, with_lse=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, kv_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention over BSHD q/k/v (keys >= kv_len masked), output in
    q's dtype. CUDA tensors launch the forward kernel without L (counted in
    ``flash_attention.launches``); CPU tensors run the plain version."""
    return _forward(q, k, v, kv_len, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                        *, kv_len: Optional[int] = None) -> torch.Tensor:
    """Row log-sum-exp of the scaled, masked scores: fp32 (B, H, S). CUDA
    tensors launch the forward kernel's LSE-only instantiation
    (``flash_attention_lse.launches``)."""
    b, s, h, d = q.shape
    kv_len = _check_kv_len(kv_len, s)
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, kv_len=kv_len)
    _check_inputs((("q", q), ("k", k)), q.shape)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("textflux_flash_lse", q.data_ptr(), k.data_ptr(), lse.data_ptr(),
                b, s, h, d, kv_len, *_strides(q, k), LOG2_E / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_lse.launches += 1
    return lse


def flash_attention_dq(q, k, v, do, lse, dvec, *, kv_len: Optional[int] = None) -> torch.Tensor:
    """dQ from the saved inputs, the upstream gradient dO, L and Dvec. CUDA
    tensors launch the dQ kernel (``flash_attention_dq.launches``)."""
    b, s, h, d = q.shape
    kv_len = _check_kv_len(kv_len, s)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, dvec, kv_len=kv_len)
    _check_inputs((("q", q), ("k", k), ("v", v), ("do", do)), q.shape)
    for name, x in (("lse", lse), ("dvec", dvec)):
        _check_rows(x, name, (b, h, s), q.device)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch("textflux_flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, s, h, d, kv_len,
                *_strides(q, k, v, do), LOG2_E / math.sqrt(d), 1.0 / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, dvec, *, kv_len: Optional[int] = None):
    """(dK, dV) from the saved inputs, dO, L and Dvec; key rows >= kv_len
    are 0. CUDA tensors launch the dK/dV kernel
    (``flash_attention_dkv.launches``)."""
    b, s, h, d = q.shape
    kv_len = _check_kv_len(kv_len, s)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, dvec, kv_len=kv_len)
    _check_inputs((("q", q), ("k", k), ("v", v), ("do", do)), q.shape)
    for name, x in (("lse", lse), ("dvec", dvec)):
        _check_rows(x, name, (b, h, s), q.device)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch("textflux_flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
                kv_len, *_strides(q, k, v, do), LOG2_E / math.sqrt(d), 1.0 / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, do, *, kv_len: Optional[int] = None, lse=None):
    """(dq, dk, dv) of softmax attention, as the JAX package's
    ``flash_attention_bwd`` computes them: L (the LSE pass, unless the
    forward's L is given), Dvec = rowsum(dO o O) in plain torch, then the dQ
    pass and the dK/dV pass. `o` is the forward output (the JAX version
    recomputes it). On CUDA tensors the passes are kernels; on CPU tensors,
    their plain versions."""
    if lse is None:
        lse = flash_attention_lse(q, k, kv_len=kv_len)
    dvec = attention_dvec(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, dvec, kv_len=kv_len)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=kv_len)
    return dq, dk, dv


for _wrapper in (flash_attention, flash_attention_lse, flash_attention_dq, flash_attention_dkv):
    _wrapper.launches = 0
