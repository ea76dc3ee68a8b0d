"""LoRA ingestion: load-time folding into the base weights.

The port of ``textflux_tpu/io/lora.py`` (``fold_lora_into_state_dict``,
``load_folded_flux_transformer``). A diffusers/peft LoRA file's deltas fold
into the base matrices once, at load: W' = W + scale * (alpha/r) * B @ A,
computed in float32 and then cast to the model's dtype, so the serving
path is the plain full-parameter model. Each diffusers module (``attn.to_q``
and so on) folds into its own row block of the fused weight it lands in,
while the checkpoint streams in (``io.params.load_flux_transformer``'s
``transform``), on the target device, with TF32 off for B @ A.

``import_lora_factors`` (the training warm start) is not ported yet.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Mapping, Tuple

import torch

from textflux_torch.config import FluxConfig
from textflux_torch.io.params import (
    Transform,
    checkpoint_keys,
    load_flux_transformer,
    load_safetensors_dir,
)

# base weight key -> (A (r, in), B (out, r), scale * alpha / r)
Deltas = Dict[str, Tuple[torch.Tensor, torch.Tensor, float]]


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in full float32 on CUDA (PyTorch's default, kept
    explicitly), restoring the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def lora_deltas(lora_sd: Mapping[str, torch.Tensor], scale: float = 1.0,
                prefix: str = "transformer.") -> Deltas:
    """The factors of every ``<module>.lora_A.weight`` / ``lora_B.weight``
    pair, keyed by the base weight they fold into (`prefix` stripped).
    Optional ``<module>.alpha`` scalars override alpha (default: alpha =
    rank, i.e. scaling 1)."""
    modules = {k[: -len(".lora_A.weight")] for k in lora_sd if k.endswith("lora_A.weight")}
    if lora_sd and not modules:
        # e.g. a kohya-format file ('lora_unet_..._lora_down.weight') or a
        # peft adapter-name infix: serving the base model as if the
        # fine-tune loaded is the worst failure mode
        sample = sorted(lora_sd)[:3]
        raise ValueError(
            "no '<module>.lora_A.weight' keys found in the LoRA file — "
            f"unrecognized naming scheme (sample keys: {sample}); expected "
            "the diffusers/peft pytorch_lora_weights.safetensors format")
    out: Deltas = {}
    for mod in sorted(modules):
        a = lora_sd[f"{mod}.lora_A.weight"]   # (r, in)
        b = lora_sd[f"{mod}.lora_B.weight"]   # (out, r)
        r = a.shape[0]
        alpha_t = lora_sd.get(f"{mod}.alpha")
        alpha = float(r) if alpha_t is None else float(alpha_t)
        base = mod[len(prefix):] if mod.startswith(prefix) else mod
        out[f"{base}.weight"] = (a, b, scale * (alpha / r))
    return out


def _fold(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, factor: float,
          device) -> torch.Tensor:
    """float32 W + factor * B @ A on `device`, TF32 off. Each tensor moves in
    its stored dtype and widens there (a host-side cast of every folded
    weight would cost more than the copy)."""
    with no_tf32():
        a32, b32, w32 = (x.to(device).float() for x in (a, b, w))
        return w32 + factor * (b32 @ a32)


def fold_lora_into_state_dict(sd: Mapping[str, torch.Tensor],
                              lora_sd: Mapping[str, torch.Tensor], scale: float = 1.0,
                              prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """Fold diffusers-format LoRA weights into a base state dict (diffusers
    naming); the folded entries come back float32, on their base's device."""
    out = dict(sd)
    for key, (a, b, factor) in lora_deltas(lora_sd, scale, prefix).items():
        if key not in out:
            raise KeyError(f"LoRA targets missing base weight: {key}")
        out[key] = _fold(out[key], a, b, factor, out[key].device)
    return out


def fold_transform(deltas: Deltas, device) -> Transform:
    """A loader transform that folds each delta into its base weight as the
    weight streams in, on `device`; other tensors pass through."""
    def transform(key: str, w: torch.Tensor) -> torch.Tensor:
        if key not in deltas:
            return w
        a, b, factor = deltas[key]
        return _fold(w, a, b, factor, device)

    return transform


def resolve_lora_path(lora_path: str) -> str:
    """A directory resolves to its pytorch_lora_weights.safetensors."""
    if os.path.isdir(lora_path):
        candidate = os.path.join(lora_path, "pytorch_lora_weights.safetensors")
        return candidate if os.path.exists(candidate) else lora_path
    return lora_path


def load_folded_flux_transformer(base_path: str, lora_path: str, cfg: FluxConfig, *,
                                 scale: float = 1.0, dtype=torch.bfloat16, device="cuda"):
    """Load a base transformer checkpoint with a LoRA file (or directory)
    folded in as it streams to `device`."""
    lora_sd = load_safetensors_dir(resolve_lora_path(lora_path))
    deltas = lora_deltas(lora_sd, scale=scale)
    present = set(checkpoint_keys(base_path))
    for key in deltas:
        if key not in present:
            raise KeyError(f"LoRA targets missing base weight: {key}")
    return load_flux_transformer(base_path, cfg, dtype=dtype, device=device,
                                 transform=fold_transform(deltas, device))
