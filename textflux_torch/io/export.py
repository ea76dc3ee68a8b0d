"""Checkpoint export: the port's modules -> diffusers-format safetensors.

The port of ``textflux_tpu/io/export.py``: the inverse of
``io.params.flux_key_map``, so weights trained here load into the reference
stack (and back). The exported tensors are views of the model's parameters
(row blocks of the fused projections), written to disk one at a time by
``io.safetensors.save_file``. LoRA factors export in the peft/diffusers
``pytorch_lora_weights.safetensors`` naming (lora_A/lora_B per target
module).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import torch

from textflux_torch.io.params import flux_key_map
from textflux_torch.io.safetensors import save_file


def export_flux_state_dict(model) -> Dict[str, torch.Tensor]:
    """A FluxTransformer -> the diffusers FluxTransformer2DModel state dict,
    as views of its parameters. Raises on a model whose q/k weights were
    half-permuted for the fused attention path (``rope_layout == "half"``):
    its q/k rows are not the checkpoint's; and on a quantised one, whose
    weights no longer hold the checkpoint's values."""
    if model.rope_layout != "interleaved":
        raise ValueError(
            f"the model's q/k weights are in the {model.rope_layout!r} layout "
            "(half_permute_flux_params, done by FillPipeline on the fused path); "
            "export needs the checkpoint's 'interleaved' layout")
    keys = flux_key_map(model)
    if any(not isinstance(p, torch.Tensor) for p, _ in keys.values()):
        raise ValueError("the model is quantised (io.quantize.QuantLinear): export the "
                         "full-precision weights it was loaded from")
    return {k: (p if rows is None else p[rows]).detach() for k, (p, rows) in keys.items()}


# LoRA target -> its diffusers sub-modules, in fused row order, with sizes
def _lora_name_maps(cfg):
    d, m = cfg.hidden_dim, cfg.mlp_dim
    double = {
        "img_qkv": [("attn.to_q", d), ("attn.to_k", d), ("attn.to_v", d)],
        "txt_qkv": [("attn.add_q_proj", d), ("attn.add_k_proj", d), ("attn.add_v_proj", d)],
        "img_proj": [("attn.to_out.0", d)],
        "txt_proj": [("attn.to_add_out", d)],
        "img_mlp.fc1": [("ff.net.0.proj", m)],
        "img_mlp.fc2": [("ff.net.2", d)],
        "txt_mlp.fc1": [("ff_context.net.0.proj", m)],
        "txt_mlp.fc2": [("ff_context.net.2", d)],
    }
    single = {
        "linear1": [("attn.to_q", d), ("attn.to_k", d), ("attn.to_v", d), ("proj_mlp", m)],
        "linear2": [("proj_out", d)],
    }
    return {"double_blocks": ("transformer_blocks", double),
            "single_blocks": ("single_transformer_blocks", single)}


def export_lora_state_dict(lora: Mapping[str, Mapping[str, torch.Tensor]], cfg,
                           alpha: float, rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The port's LoRA factors (``training.train.lora_init``'s
    ``{"double_blocks.<i>.<target>": {"a", "b"}}``: a (in, r) / b (r, out),
    or grouped a (M, in, r) / b (M, r, d) per sub-module) -> diffusers/peft
    naming, with an ``alpha`` scalar per module.

    Flat fused targets export per projection by slicing B's columns (delta
    = A @ B, so column slices of B give per-projection deltas with a shared
    A). ``rank``: the rank the train-time scale alpha/rank was computed
    with; each target's alpha is then (alpha/rank)*r_t for its own rank
    r_t, as consumers recover the scale as alpha_t/r_t from the shapes.
    With rank=None every target exports alpha itself."""
    maps = _lora_name_maps(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for path, f in lora.items():
        group, i, target = path.split(".", 2)
        prefix, name_map = maps[group]
        a, b = f["a"].detach(), f["b"].detach()
        r_t = a.shape[-1]
        alpha_t = torch.tensor(alpha if rank is None else alpha * (r_t / rank),
                               dtype=torch.float32)
        if a.dim() == 3:
            # grouped: independent per-module adapters (the reference peft family)
            for mi, (sub, _) in enumerate(name_map[target][: a.shape[0]]):
                mod = f"transformer.{prefix}.{i}.{sub}"
                sd[f"{mod}.lora_A.weight"] = a[mi].T
                sd[f"{mod}.lora_B.weight"] = b[mi].T
                sd[f"{mod}.alpha"] = alpha_t
            continue
        start = 0
        for sub, size in name_map[target]:
            mod = f"transformer.{prefix}.{i}.{sub}"
            sd[f"{mod}.lora_A.weight"] = a.T                              # (r, in)
            sd[f"{mod}.lora_B.weight"] = b[:, start:start + size].T       # (out_slice, r)
            sd[f"{mod}.alpha"] = alpha_t
            start += size
    return sd


def save_safetensors(sd: Mapping[str, torch.Tensor], path: str, dtype=None) -> int:
    """Write a state dict; with `dtype`, tensors of one dimension or more
    are cast as they are written (scalars such as ``alpha`` keep theirs)."""
    return save_file(sd, path, dtype=dtype)


def _shard(keys, sizes, n: int):
    """Consecutive groups of keys with about equal bytes each."""
    total, groups, acc = sum(sizes.values()), [[]], 0
    for k in keys:
        if acc >= total * len(groups) / n and len(groups) < n:
            groups.append([])
        groups[-1].append(k)
        acc += sizes[k]
    return groups


def save_transformer_checkpoint(model, out_dir: str, *, shards: int = 1, dtype=None) -> int:
    """Save a diffusers-layout transformer/ directory: config.json and the
    weights, in one file or in `shards` files named as diffusers names them
    (``diffusion_pytorch_model-00001-of-00003.safetensors``, with the
    ``.index.json`` weight map). Returns the bytes of weights written."""
    cfg = model.cfg
    os.makedirs(out_dir, exist_ok=True)
    sd = export_flux_state_dict(model)
    base = "diffusion_pytorch_model"
    written = 0
    if shards <= 1:
        written = save_safetensors(sd, os.path.join(out_dir, f"{base}.safetensors"), dtype)
    else:
        sizes = {k: v.numel() * (v.element_size() if dtype is None
                                 else torch.empty((), dtype=dtype).element_size())
                 for k, v in sd.items()}
        weight_map = {}
        groups = _shard(list(sd), sizes, shards)
        for j, keys in enumerate(groups):
            name = f"{base}-{j + 1:05d}-of-{len(groups):05d}.safetensors"
            written += save_safetensors({k: sd[k] for k in keys},
                                        os.path.join(out_dir, name), dtype)
            weight_map.update({k: name for k in keys})
        with open(os.path.join(out_dir, f"{base}.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": sum(sizes.values())},
                       "weight_map": weight_map}, f, indent=2)
    config = {
        "_class_name": "FluxTransformer2DModel",
        "patch_size": 1,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "num_layers": cfg.num_double_layers,
        "num_single_layers": cfg.num_single_layers,
        "attention_head_dim": cfg.head_dim,
        "num_attention_heads": cfg.num_heads,
        "joint_attention_dim": cfg.joint_dim,
        "pooled_projection_dim": cfg.pooled_dim,
        "guidance_embeds": cfg.guidance_embeds,
        "axes_dims_rope": list(cfg.axes_dims_rope),
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return written
