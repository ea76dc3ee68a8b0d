"""Blockwise int8 storage for Adam's moments: the port of
``textflux_tpu/training/optim8bit.py``.

The reference trains the full DiT with bitsandbytes' AdamW8bit, whose state
stores both Adam moments as blockwise-quantised int8. Here each moment
tensor is flattened, padded to a multiple of ``BLOCK`` (256) and cut into
blocks; each block keeps int8 codes and one float32 scale, so the state
takes ~2.03 bytes per parameter instead of 8.

Two codes, as in the JAX module:

  * ``quantize_blockwise``: symmetric linear int8 against the block's absmax;
  * ``quantize_dynamic``: sign-exact LOG-DOMAIN int8 (the analogue of
    bitsandbytes' dynamic map): 127 magnitude levels spaced geometrically
    over five decades below the block's absmax, so the relative error is
    bounded (~4.6%) at every scale. Values below absmax * 1e-5 take code 0;
    ``dequantize_dynamic(floor=True)`` reads code 0 back as +absmax * 1e-5,
    so the second moment is never underestimated (an underestimated
    denominator is what makes naive int8 Adam blow up).

``training.train.ClippedAdamW8bit`` keeps its moments in these codes and
updates from the freshly dequantised float32 values.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256
_LOG_RANGE = 11.512925464970229  # ln(1e5)

# (codes (n_blocks, block) int8, scales (n_blocks,) float32)
Quantized = Tuple[torch.Tensor, torch.Tensor]


def n_blocks(numel: int, block: int = BLOCK) -> int:
    return -(-numel // block)


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.float().reshape(-1)
    return F.pad(flat, (0, n_blocks(flat.numel(), block) * block - flat.numel())).reshape(
        -1, block)


def _unblock(flat: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return flat.reshape(-1)[:n].reshape(shape).to(dtype)


def quantize_blockwise(x: torch.Tensor, block: int = BLOCK) -> Quantized:
    """Symmetric linear int8 with a per-block absmax scale."""
    blocks = _blocks(x, block)
    scale = torch.clamp(blocks.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blockwise(qt: Quantized, shape, dtype=torch.float32) -> torch.Tensor:
    q, scale = qt
    return _unblock(q.float() * scale[:, None], shape, dtype)


def quantize_dynamic(x: torch.Tensor, block: int = BLOCK) -> Quantized:
    """Sign-exact blockwise log-domain int8; the scale is the block's
    absmax."""
    blocks = _blocks(x, block)
    absmax = torch.clamp(blocks.abs().amax(dim=-1), min=1e-30)
    t = blocks.abs() / absmax[:, None]
    qm = torch.round(127.0 * (1.0 + torch.log(torch.clamp(t, min=1e-5)) / _LOG_RANGE))
    q = (torch.sign(blocks) * torch.clamp(qm, 0.0, 127.0)).to(torch.int8)
    return q, absmax


def dequantize_dynamic(qt: Quantized, shape, *, floor: bool = False,
                       dtype=torch.float32) -> torch.Tensor:
    """The inverse of quantize_dynamic. With floor=True, code 0 reads back as
    +absmax * 1e-5 instead of 0 (for non-negative state, where an
    underestimate is the dangerous direction)."""
    q, scale = qt
    qf = q.float()
    mag = torch.exp(_LOG_RANGE * (qf.abs() / 127.0 - 1.0))
    sign = torch.where(qf == 0, torch.full_like(qf, 1.0 if floor else 0.0), torch.sign(qf))
    return _unblock(sign * mag * scale[:, None], shape, dtype)


def state_bytes(state: Any) -> int:
    """Bytes of every tensor in a nested optimizer state (dicts, lists,
    tuples)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(v) for v in state)
    return 0
