"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent; the
CPU is used only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

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
