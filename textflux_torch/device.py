"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent; the
CPU is used only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda", *,
                   allow_meta: bool = False) -> torch.device:
    """`allow_meta`: the model constructors also take "meta", to build a
    module's structure without storage (the checkpoint loaders do)."""
    dev = torch.device(device)
    if dev.type == "meta" and allow_meta:
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def true_fp32():
    """float32 convolutions and matmuls in true float32 while the block runs
    (TF32 off for cuDNN and cuBLAS; cuDNN allows it by default), the
    previous flags restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
