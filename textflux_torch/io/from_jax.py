"""Carry the JAX package's parameter trees into the port's modules.

``load_jax_params(tree, cfg)`` takes a parameter tree as the JAX package
builds it (nested dicts of arrays; pass them through ``numpy.asarray``) and
returns the port's module for that config: ``FluxTransformer``, ``FluxVAE``,
``CLIPTextModel`` or ``T5Encoder``. It imports no JAX: any object numpy can
read works. The layout changes, each written out below:

  * dense ``w`` (in, out)            -> ``nn.Linear.weight`` (out, in)
  * stacked block leaves (L, ...)    -> leaf [i] of per-block module i
  * conv ``w`` HWIO                  -> ``nn.Conv2d.weight`` OIHW
  * norm ``scale``/``bias``, biases, embeddings, tables -> copied as they are

The trees hold the checkpoint's q/k feature order: the modules come back in
the "interleaved" rope layout, and a pipeline on the fused path permutes
them as the JAX pipeline does.

``load_jax_lora(tree, model)`` carries a JAX LoRA factor tree
(``training.train.lora_init``'s: stacked (L, ...) factors per target name)
across as the port's per-layer factors, in the same (in, r) / (r, out)
layout, ready for ``textflux_torch.training.train.lora_insert``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from textflux_torch.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


@torch.no_grad()
def _set(param: torch.Tensor, value: torch.Tensor, what: str) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{what}: shape {tuple(value.shape)} != {tuple(param.shape)}")
    param.copy_(value)


def _dense(lin: nn.Linear, p: Mapping, what: str) -> None:
    """JAX dense {"w": (in, out), "b": (out,)} -> nn.Linear (weight (out, in))."""
    _set(lin.weight, _t(p["w"]).T, what + ".w")
    if "b" in p:
        _set(lin.bias, _t(p["b"]), what + ".b")
    elif lin.bias is not None:
        raise ValueError(f"{what}: module has a bias the tree lacks")


def _conv(c: nn.Conv2d, p: Mapping, what: str) -> None:
    """JAX conv {"w": HWIO, "b"} -> nn.Conv2d (weight OIHW)."""
    _set(c.weight, _t(p["w"]).permute(3, 2, 0, 1), what + ".w")
    _set(c.bias, _t(p["b"]), what + ".b")


def _norm(mod: nn.Module, p: Mapping, what: str) -> None:
    _set(mod.scale, _t(p["scale"]), what + ".scale")
    _set(mod.bias, _t(p["bias"]), what + ".bias")


def _layer(tree, i: int):
    """Leaf i of a stacked (L, ...) subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _load_flux(model, tree) -> None:
    _dense(model.img_in, tree["img_in"], "img_in")
    _dense(model.txt_in, tree["txt_in"], "txt_in")
    for name in ("time_in", "vector_in") + (("guidance_in",) if model.guidance_in else ()):
        _dense(getattr(model, name).fc1, tree[name]["fc1"], name + ".fc1")
        _dense(getattr(model, name).fc2, tree[name]["fc2"], name + ".fc2")
    _dense(model.final_mod, tree["final_mod"], "final_mod")
    _dense(model.final_proj, tree["final_proj"], "final_proj")
    for i, blk in enumerate(model.double_blocks):
        p = _layer(tree["double"], i)
        for name in ("img_mod", "txt_mod", "img_qkv", "txt_qkv", "img_proj", "txt_proj"):
            _dense(getattr(blk, name), p[name], f"double[{i}].{name}")
        for name in ("img_mlp", "txt_mlp"):
            _dense(getattr(blk, name).fc1, p[name]["fc1"], f"double[{i}].{name}.fc1")
            _dense(getattr(blk, name).fc2, p[name]["fc2"], f"double[{i}].{name}.fc2")
        for name in ("img_q_scale", "img_k_scale", "txt_q_scale", "txt_k_scale"):
            _set(getattr(blk, name), _t(p[name]), f"double[{i}].{name}")
    for i, blk in enumerate(model.single_blocks):
        p = _layer(tree["single"], i)
        for name in ("mod", "linear1", "linear2"):
            _dense(getattr(blk, name), p[name], f"single[{i}].{name}")
        for name in ("q_scale", "k_scale"):
            _set(getattr(blk, name), _t(p[name]), f"single[{i}].{name}")


def _load_resnet(r, p, what):
    _norm(r.norm1, p["norm1"], what + ".norm1")
    _conv(r.conv1, p["conv1"], what + ".conv1")
    _norm(r.norm2, p["norm2"], what + ".norm2")
    _conv(r.conv2, p["conv2"], what + ".conv2")
    if r.skip is not None:
        _conv(r.skip, p["skip"], what + ".skip")


def _load_mid(m, p, what):
    _load_resnet(m.res1, p["res1"], what + ".res1")
    _norm(m.attn.norm, p["attn"]["norm"], what + ".attn.norm")
    for name in ("q", "k", "v", "out"):
        _dense(getattr(m.attn, name), p["attn"][name], f"{what}.attn.{name}")
    _load_resnet(m.res2, p["res2"], what + ".res2")


def _load_vae(model, tree) -> None:
    enc, dec = tree["encoder"], tree["decoder"]
    _conv(model.encoder.conv_in, enc["conv_in"], "encoder.conv_in")
    for i, block in enumerate(model.encoder.down):
        for j, r in enumerate(block.resnets):
            _load_resnet(r, enc["down"][i]["resnets"][j], f"encoder.down[{i}].resnets[{j}]")
        if block.down is not None:
            _conv(block.down, enc["down"][i]["down"], f"encoder.down[{i}].down")
    _load_mid(model.encoder.mid, enc["mid"], "encoder.mid")
    _norm(model.encoder.norm_out, enc["norm_out"], "encoder.norm_out")
    _conv(model.encoder.conv_out, enc["conv_out"], "encoder.conv_out")
    _conv(model.decoder.conv_in, dec["conv_in"], "decoder.conv_in")
    _load_mid(model.decoder.mid, dec["mid"], "decoder.mid")
    for i, block in enumerate(model.decoder.up):
        for j, r in enumerate(block.resnets):
            _load_resnet(r, dec["up"][i]["resnets"][j], f"decoder.up[{i}].resnets[{j}]")
        if block.up is not None:
            _conv(block.up, dec["up"][i]["up"], f"decoder.up[{i}].up")
    _norm(model.decoder.norm_out, dec["norm_out"], "decoder.norm_out")
    _conv(model.decoder.conv_out, dec["conv_out"], "decoder.conv_out")


def _load_clip(model, tree) -> None:
    _set(model.token_embedding, _t(tree["token_embedding"]), "token_embedding")
    _set(model.position_embedding, _t(tree["position_embedding"]), "position_embedding")
    for i, layer in enumerate(model.layers):
        p = _layer(tree["layers"], i)
        _norm(layer.ln1, p["ln1"], f"layers[{i}].ln1")
        _norm(layer.ln2, p["ln2"], f"layers[{i}].ln2")
        for name in ("q", "k", "v", "o", "fc1", "fc2"):
            _dense(getattr(layer, name), p[name], f"layers[{i}].{name}")
    _norm(model.final_ln, tree["final_ln"], "final_ln")


def _load_t5(model, tree) -> None:
    _set(model.embedding, _t(tree["embedding"]), "embedding")
    _set(model.rel_bias, _t(tree["rel_bias"]), "rel_bias")
    for i, layer in enumerate(model.layers):
        p = _layer(tree["layers"], i)
        _set(layer.attn_norm, _t(p["attn_norm"]), f"layers[{i}].attn_norm")
        _set(layer.mlp_norm, _t(p["mlp_norm"]), f"layers[{i}].mlp_norm")
        for name in ("q", "k", "v", "o", "wi_0", "wi_1", "wo"):
            _dense(getattr(layer, name), p[name], f"layers[{i}].{name}")
    _set(model.final_norm, _t(tree["final_norm"]), "final_norm")


def load_jax_lora(tree: Mapping, model) -> dict:
    """{"double": {name: {"a", "b"}}, "single": {...}} with stacked (L, ...)
    leaves -> {"double_blocks.<i>.<name>": {"a": Parameter, "b": Parameter}},
    fp32 on the model's device."""
    device = next(model.parameters()).device
    out = {}
    for group, blocks in (("double", "double_blocks"), ("single", "single_blocks")):
        for name, f in tree.get(group, {}).items():
            a, b = np.asarray(f["a"]), np.asarray(f["b"])
            n_layers = len(getattr(model, blocks))
            if a.shape[0] != n_layers or b.shape[0] != n_layers:
                raise ValueError(f"{group}.{name}: {a.shape[0]} layers, the model has {n_layers}")
            for i in range(n_layers):
                out[f"{blocks}.{i}.{name}"] = {
                    k: nn.Parameter(_t(x[i]).to(device)) for k, x in (("a", a), ("b", b))}
    return out


def load_jax_params(tree: Mapping, cfg, *, device="cuda", dtype=torch.float32) -> nn.Module:
    """Build the port's module for `cfg` (a textflux_torch.config dataclass)
    and fill it from the JAX-layout parameter tree."""
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE

    table = {FluxConfig: (FluxTransformer, _load_flux), VAEConfig: (FluxVAE, _load_vae),
             CLIPTextConfig: (CLIPTextModel, _load_clip), T5Config: (T5Encoder, _load_t5)}
    if type(cfg) not in table:
        raise TypeError(f"no port module for config type {type(cfg).__name__}")
    cls, fill = table[type(cfg)]
    model = cls(cfg, device=device, dtype=dtype)
    fill(model, tree)
    return model
