"""The AdaLN modulate: a hand-written Hopper pass and its plain PyTorch
version.

``adaln_modulate(x, shift, scale)`` is LayerNorm(x) * (1 + scale) + shift
for x (B, S, D) and the (B, D) shift and scale of a block's (or the output
head's) modulation vector: the affine-free LayerNorm in float32 with eps
1e-6, then the modulation in x's dtype. On a CPU tensor it runs the plain
composition, which the JAX package's parity tests hold; on a CUDA tensor it
launches ``csrc/adaln_modulate.cu`` (``adaln_modulate_kernel``) or raises,
and counts the launch in ``adaln_modulate.launches``. The kernel has no
backward and takes bf16 alone: a caller through which a gradient flows, or
whose model is not bf16, calls the plain version itself
(``models.transformer._modulate`` does).

The kernel replaces no TPU kernel (XLA fuses the composition there). It
was added because eager PyTorch, inside a CUDA graph too, runs the
composition as 13 launches that move the row through device memory about
ten times in float32; the kernel reads the bf16 row once and writes it
once, with the composition's rounding points, so only the float32
summation order of the mean and the variance differs (the normalised value
is rarely one bf16 place off the composition's, and never more). Its design
is at the top of its source.
"""

from __future__ import annotations

import torch

from textflux_torch.models.layers import layer_norm

EPS = 1e-6              # the DiT's LayerNorm epsilon (``layers.layer_norm``'s default)
VECTOR = 8              # bf16 features a 16-byte load
MAX_DIM = 32 * 32 * VECTOR   # 32 vectors a lane: the kernel's largest instantiation


def adaln_modulate_reference(x: torch.Tensor, shift: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``layer_norm(x) * (1 + scale) + shift``, the
    vectors broadcast over the sequence."""
    return layer_norm(x, EPS) * (1.0 + scale[:, None]) + shift[:, None]


def launch(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, without synchronising,
    into a new contiguous (B, S, D) bf16 tensor: x (B, S, D) and shift,
    scale (B, D), all bf16 on one CUDA device; D a multiple of 8 up to
    MAX_DIM; unit feature strides, every other stride a multiple of 8 and
    every pointer 16-byte aligned (the kernel's 16-byte loads); no gradient
    to flow. Raises ValueError or TypeError on anything else."""
    from textflux_torch.ops.cuda_build import load_library

    if x.dim() != 3 or shift.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"x must be (B, S, D) and shift, scale (B, D); got {tuple(x.shape)}, "
                         f"{tuple(shift.shape)}, {tuple(scale.shape)}")
    b, s, d = x.shape
    if tuple(shift.shape) != (b, d) or tuple(scale.shape) != (b, d):
        raise ValueError(f"shift and scale must be ({b}, {d}); got {tuple(shift.shape)}, "
                         f"{tuple(scale.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (x, shift, scale)):
        raise TypeError(f"the AdaLN kernel takes bfloat16; got {x.dtype}, {shift.dtype}, "
                        f"{scale.dtype}")
    if d % VECTOR or not 0 < d <= MAX_DIM:
        raise ValueError(f"D must be a multiple of {VECTOR} up to {MAX_DIM}, got {d}")
    if not (0 < b < 2 ** 16 and 0 < s < 2 ** 31):
        raise ValueError(f"x must hold 1 to 65,535 samples of 1 or more rows, got "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda" or shift.device != x.device or scale.device != x.device:
        raise ValueError(f"the AdaLN kernel takes tensors on one CUDA device; got {x.device}, "
                         f"{shift.device}, {scale.device}")
    strides = (x.stride(0), x.stride(1), shift.stride(0), scale.stride(0))
    if (x.stride(2) != 1 or shift.stride(1) != 1 or scale.stride(1) != 1
            or any(st % VECTOR for st in strides)
            or any(t.data_ptr() % 16 for t in (x, shift, scale))):
        raise ValueError("the AdaLN kernel takes unit feature strides, other strides a "
                         "multiple of 8 and 16-byte aligned tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, shift, scale)):
        raise ValueError("the AdaLN kernel has no backward: a gradient would flow")
    y = torch.empty((b, s, d), dtype=torch.bfloat16, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.textflux_adaln_modulate(x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                                          y.data_ptr(), b, s, d, x.stride(0), x.stride(1),
                                          shift.stride(0), scale.stride(0), EPS, stream)
    if err != 0:
        raise RuntimeError(f"AdaLN modulate kernel launch failed: CUDA error {err}")
    adaln_modulate.launches += 1
    return y


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LayerNorm(x) * (1 + scale) + shift: the plain version on a CPU
    tensor; on a CUDA tensor the kernel, or a ValueError / TypeError for
    what it does not take (``launch``)."""
    if x.device.type != "cuda":
        return adaln_modulate_reference(x, shift, scale)
    return launch(x, shift, scale)


adaln_modulate.launches = 0
