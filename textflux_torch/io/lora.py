"""LoRA ingestion: load-time folding into the base weights.

The port of ``textflux_tpu/io/lora.py`` (``fold_lora_into_state_dict``,
``load_folded_flux_transformer``). A diffusers/peft LoRA file's deltas fold
into the base matrices once, at load: W' = W + scale * (alpha/r) * B @ A,
computed in float32 and then cast to the model's dtype, so the serving
path is the plain full-parameter model. Each diffusers module (``attn.to_q``
and so on) folds into its own row block of the fused weight it lands in,
while the checkpoint streams in (``io.params.load_flux_transformer``'s
``transform``), on the target device, with TF32 off for B @ A.

``import_lora_factors`` is the training warm start (``--pretrained-lora``):
a LoRA file back to the train step's factors.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
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
                                 scale: float = 1.0, dtype=torch.bfloat16, device="cuda",
                                 quantize: Optional[str] = None):
    """Load a base transformer checkpoint with a LoRA file (or directory)
    folded in as it streams to `device` (then quantised, with
    `quantize`)."""
    lora_sd = load_safetensors_dir(resolve_lora_path(lora_path))
    deltas = lora_deltas(lora_sd, scale=scale)
    present = set(checkpoint_keys(base_path))
    for key in deltas:
        if key not in present:
            raise KeyError(f"LoRA targets missing base weight: {key}")
    return load_flux_transformer(base_path, cfg, dtype=dtype, device=device,
                                 transform=fold_transform(deltas, device), quantize=quantize)


# training warm start: a diffusers/peft LoRA state dict -> the factors ------

# target -> its diffusers sub-modules, in fused column order (the name maps
# of io.export.export_lora_state_dict)
_IMPORT_MAP_DOUBLE = {
    "img_qkv": ("attn.to_q", "attn.to_k", "attn.to_v"),
    "txt_qkv": ("attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj"),
    "img_proj": ("attn.to_out.0",),
    "txt_proj": ("attn.to_add_out",),
    "img_mlp.fc1": ("ff.net.0.proj",),
    "img_mlp.fc2": ("ff.net.2",),
    "txt_mlp.fc1": ("ff_context.net.0.proj",),
    "txt_mlp.fc2": ("ff_context.net.2",),
}
_IMPORT_MAP_SINGLE = {
    "linear1": ("attn.to_q", "attn.to_k", "attn.to_v"),
}
# fused targets whose sub-modules import as grouped independent per-module
# factors (training.train.LORA_GROUPED); single-module targets import flat
_GROUPED_IMPORTS = ("img_qkv", "txt_qkv", "linear1")
# module names the reference's peft target list never adapts; a file carrying
# them was trained with a custom --lora_layers subset the factors cannot hold
_UNSUPPORTED_SINGLE_MODS = (".proj_mlp.lora_A", ".proj_out.lora_A")


def import_lora_factors(lora_sd: Mapping[str, torch.Tensor], cfg: FluxConfig,
                        lora_scale: float) -> Dict[str, Dict[str, torch.Tensor]]:
    """A diffusers/peft LoRA state dict -> the train step's factors,
    ``{"double_blocks.<i>.<target>": {"a", "b"}}`` as ``lora_insert`` takes
    them (fp32 CPU tensors; the warm start of reference train_lora.py:536-553).

    The sub-modules of a fused projection (qkv, single linear1's q/k/v)
    carry independent (A, B) pairs and import as grouped per-module factors
    a (M, in, r) / b (M, r, d), the parameterisation fresh training uses.
    Each module's own alpha_m/r_m, divided by the train step's ``lora_scale``
    (alpha/rank), is folded into A, so the inserted delta reproduces the
    file's. Targets absent from the file are omitted (the caller keeps its
    fresh init); absent layers of a present target get a fresh A from one
    ``np.random.default_rng(0)`` (drawn in the JAX package's order) and B = 0.
    The arithmetic is the JAX package's, in numpy float32."""
    for k in lora_sd:
        if any(m in k for m in _UNSUPPORTED_SINGLE_MODS):
            raise ValueError(
                f"LoRA file adapts {k.split('.lora_')[0]} — outside the "
                "reference's peft target list (single blocks adapt only "
                "attn.to_q/k/v); custom --lora_layers subsets are not "
                "importable (see ARCHITECTURE.md deviations)")

    def host(x) -> np.ndarray:
        return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)

    def lookup(prefix, i, mod):
        key = f"{prefix}.{i}.{mod}"
        for p in (f"transformer.{key}", key):
            if f"{p}.lora_A.weight" in lora_sd:
                a = host(lora_sd[f"{p}.lora_A.weight"])
                b = host(lora_sd[f"{p}.lora_B.weight"])
                r = a.shape[0]
                alpha = float(host(lora_sd[f"{p}.alpha"])) if f"{p}.alpha" in lora_sd else r
                return a.T * ((alpha / r) / lora_scale), b.T  # (in, r), (r, out)
        return None

    # one rng for the whole import: a fresh default_rng(0) per target would
    # hand every same-shaped target byte-identical "random" fresh-layer A's
    rng = np.random.default_rng(0)
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def build(group: str, prefix: str, n_layers: int, name_map) -> None:
        for target, mods in name_map.items():
            grouped = target in _GROUPED_IMPORTS
            per_layer = []
            for i in range(n_layers):
                pairs = [lookup(prefix, i, mod) for mod in mods]
                if all(p is None for p in pairs):
                    per_layer.append(None)  # layer not in the file: fresh below
                    continue
                if any(p is None for p in pairs):
                    raise ValueError(
                        f"LoRA sd covers only some sub-modules of fused "
                        f"target {target} (layer {i}): {mods}")
                if grouped:
                    ranks = {a.shape[1] for a, _ in pairs}
                    if len(ranks) != 1:
                        raise ValueError(
                            f"per-module ranks differ inside {target} "
                            f"(layer {i}): {ranks}")
                    per_layer.append((np.stack([a for a, _ in pairs]),
                                      np.stack([b for _, b in pairs])))
                else:
                    per_layer.append(pairs[0])
            present = [x for x in per_layer if x is not None]
            if not present:
                continue                                   # target not in the file
            ranks = {a.shape[-1] for a, _ in present}
            if len(ranks) != 1:
                raise ValueError(f"rank differs across layers for {target}: {ranks}")
            # layers absent from the file (block-subset LoRAs): B = 0 (a no-op
            # delta) with a random A as lora_init draws it (A = B = 0 would
            # zero both gradients and freeze the layer)
            a0, b0 = present[0]
            for i, x in enumerate(per_layer):
                if x is None:
                    x = (rng.standard_normal(a0.shape).astype(np.float32) / a0.shape[-1],
                         np.zeros_like(b0))
                out[f"{group}.{i}.{target}"] = {"a": torch.from_numpy(np.ascontiguousarray(x[0])),
                                                "b": torch.from_numpy(np.ascontiguousarray(x[1]))}

    build("double_blocks", "transformer_blocks", cfg.num_double_layers, _IMPORT_MAP_DOUBLE)
    build("single_blocks", "single_transformer_blocks", cfg.num_single_layers,
          _IMPORT_MAP_SINGLE)
    return out
