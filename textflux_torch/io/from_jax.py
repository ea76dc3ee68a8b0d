"""Carry the JAX package's parameter trees into the port's modules.

``load_jax_params(tree, cfg)`` takes a parameter tree as the JAX package
builds it (nested dicts of arrays; pass them through ``numpy.asarray``) and
returns the port's module for that config: ``FluxTransformer``, ``FluxVAE``,
``CLIPTextModel`` or ``T5Encoder``. It imports no JAX: any object numpy can
read works. The layout changes, each written out below:

  * dense ``w`` (in, out)            -> ``nn.Linear.weight`` (out, in)
  * a quantised dense leaf (``w_q`` / ``w_q8a8`` / ``w_nf4`` with their
    scales, the JAX ``io.quantize`` layouts) -> an ``io.quantize.
    QuantLinear`` in the linear's place, every (in, out) tensor transposed
    to the port's (out, in): the same codes on both sides
  * stacked block leaves (L, ...)    -> leaf [i] of per-block module i
  * conv ``w`` HWIO                  -> ``nn.Conv2d.weight`` OIHW
  * norm ``scale``/``bias``, biases, embeddings, tables -> copied as they are

The trees hold the checkpoint's q/k feature order: the modules come back in
the "interleaved" rope layout, and a pipeline on the fused path permutes
them as the JAX pipeline does.

``load_jax_inception`` / ``load_jax_lpips`` / ``load_jax_ppocr`` carry
the evaluation networks' trees (the FID InceptionV3, the AlexNet LPIPS and
the PP-OCR recognizer) into their modules in ``textflux_torch.evaluation``,
with the same layout changes.

``load_jax_dense(leaf)`` carries one dense leaf. ``load_jax_lora(tree,
model)`` carries a JAX LoRA factor tree
(``training.train.lora_init``'s: stacked (L, ...) factors per target name)
across as the port's per-layer factors, in the same (in, r) / (r, out)
layout, ready for ``textflux_torch.training.train.lora_insert``.
``load_jax_moments(opt, mu, nu, count)`` carries the JAX trainer's (masked)
AdamW or 8-bit AdamW moments into a port optimizer.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from textflux_torch.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig
from textflux_torch.io.quantize import QuantLinear


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


@torch.no_grad()
def _set(param: torch.Tensor, value: torch.Tensor, what: str) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{what}: shape {tuple(value.shape)} != {tuple(param.shape)}")
    param.copy_(value)


# the JAX leaf key of each quantised layout's codes -> its mode
_QUANT_CODES = {"w_q": "weight_only", "w_q8a8": "w8a8", "w_nf4": "nf4"}


def _quant_linear(lin: nn.Linear, p: Mapping, what: str) -> QuantLinear:
    """A QuantLinear holding a JAX quantised dense leaf's codes and scales."""
    mode = next(_QUANT_CODES[k] for k in _QUANT_CODES if k in p)
    q = QuantLinear(lin.in_features, lin.out_features, mode, bias="b" in p,
                    double_quant="absmax8" in p, device=lin.weight.device,
                    dtype=lin.weight.dtype)
    if q.mode != mode:
        raise ValueError(f"{what}: a {mode} leaf for a linear of {lin.in_features} inputs")
    for k, v in p.items():
        buf = getattr(q, "bias" if k == "b" else k, None)
        if not isinstance(buf, torch.Tensor) or k == "bias":
            raise ValueError(f"{what}: unknown key {k!r} in a quantised dense leaf")
        x = torch.from_numpy(np.array(v, copy=True))
        _set(buf, x.T if x.dim() == 2 else x, f"{what}.{k}")
    return q


def _dense(owner: nn.Module, name: str, p: Mapping, what: str) -> None:
    """JAX dense {"w": (in, out), "b": (out,)} -> owner.<name>, an nn.Linear
    (weight (out, in)); a quantised leaf puts a QuantLinear in its place."""
    lin = getattr(owner, name)
    if any(k in p for k in _QUANT_CODES):
        setattr(owner, name, _quant_linear(lin, p, what))
        return
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
    for name in ("img_in", "txt_in", "final_mod", "final_proj"):
        _dense(model, name, tree[name], name)
    for name in ("time_in", "vector_in") + (("guidance_in",) if model.guidance_in else ()):
        for fc in ("fc1", "fc2"):
            _dense(getattr(model, name), fc, tree[name][fc], f"{name}.{fc}")
    for i, blk in enumerate(model.double_blocks):
        p = _layer(tree["double"], i)
        for name in ("img_mod", "txt_mod", "img_qkv", "txt_qkv", "img_proj", "txt_proj"):
            _dense(blk, name, p[name], f"double[{i}].{name}")
        for name in ("img_mlp", "txt_mlp"):
            for fc in ("fc1", "fc2"):
                _dense(getattr(blk, name), fc, p[name][fc], f"double[{i}].{name}.{fc}")
        for name in ("img_q_scale", "img_k_scale", "txt_q_scale", "txt_k_scale"):
            _set(getattr(blk, name), _t(p[name]), f"double[{i}].{name}")
    for i, blk in enumerate(model.single_blocks):
        p = _layer(tree["single"], i)
        for name in ("mod", "linear1", "linear2"):
            _dense(blk, name, p[name], f"single[{i}].{name}")
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
        _dense(m.attn, name, p["attn"][name], f"{what}.attn.{name}")
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
            _dense(layer, name, p[name], f"layers[{i}].{name}")
    _norm(model.final_ln, tree["final_ln"], "final_ln")


def _load_t5(model, tree) -> None:
    _set(model.embedding, _t(tree["embedding"]), "embedding")
    _set(model.rel_bias, _t(tree["rel_bias"]), "rel_bias")
    for i, layer in enumerate(model.layers):
        p = _layer(tree["layers"], i)
        _set(layer.attn_norm, _t(p["attn_norm"]), f"layers[{i}].attn_norm")
        _set(layer.mlp_norm, _t(p["mlp_norm"]), f"layers[{i}].mlp_norm")
        for name in ("q", "k", "v", "o", "wi_0", "wi_1", "wo"):
            _dense(layer, name, p[name], f"layers[{i}].{name}")
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


def load_jax_dense(p: Mapping, *, device="cuda", dtype=torch.float32) -> nn.Module:
    """One JAX dense leaf as the port's module: an nn.Linear, or a
    QuantLinear holding a quantised leaf's codes."""
    if "w_nf4" in p:
        half, d_out = np.shape(p["w_nf4"])
        d_in = 2 * half
    else:
        d_in, d_out = np.shape(next(p[k] for k in ("w", "w_q", "w_q8a8") if k in p))
    holder = nn.Module()
    holder.lin = nn.Linear(d_in, d_out, bias="b" in p, device=device, dtype=dtype)
    _dense(holder, "lin", p, "dense")
    return holder.lin


def load_jax_params(tree: Mapping, cfg, *, device="cuda", dtype=torch.float32) -> nn.Module:
    """Build the port's module for `cfg` (a textflux_torch.config dataclass)
    and fill it from the JAX-layout parameter tree. `dtype` is one dtype
    for every parameter, or a function of the parameter's name giving each
    its own (``io.params.empty_module``'s policy, ``*scale`` parameters
    float32: e.g. a full-parameter JAX tree, float32 throughout, carried
    across as float32 masters beside frozen bf16 weights,
    ``training.train.mask_dtypes``)."""
    from textflux_torch.io.params import empty_module
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE

    table = {FluxConfig: (FluxTransformer, _load_flux), VAEConfig: (FluxVAE, _load_vae),
             CLIPTextConfig: (CLIPTextModel, _load_clip), T5Config: (T5Encoder, _load_t5)}
    if type(cfg) not in table:
        raise TypeError(f"no port module for config type {type(cfg).__name__}")
    cls, fill = table[type(cfg)]
    model = (empty_module(cfg, device=device, dtype=dtype) if callable(dtype)
             else cls(cfg, device=device, dtype=dtype))
    fill(model, tree)
    return model


def _leaf(tree: Mapping, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


@torch.no_grad()
def load_jax_moments(opt, mu: Mapping, nu: Mapping, count: int) -> None:
    """Carry the JAX trainer's Adam moments into a port optimizer that
    ``training.train.make_optimizer`` made over named parameters: the
    ``mu`` / ``nu`` trees (params structure) of optax.adamw's state for a
    ``ClippedAdamW`` (each leaf's layer, transposed where the port stores
    (out, in)), or of ``optim8bit``'s 8-bit state for a
    ``ClippedAdamW8bit`` (leaves (q, scale), taken as they are: the port
    keeps its moments per JAX leaf), and the update count. The leaves the
    JAX mask left without state (optax.masked) are never read."""
    from textflux_torch.training.train import ClippedAdamW, ClippedAdamW8bit, jax_leaf

    opt.count = int(count)
    if isinstance(opt, ClippedAdamW8bit):
        for j, (idx, _, _) in enumerate(opt.leaves):
            leaf = jax_leaf(opt.names[idx[0]])[0]
            for m, tree in (("mu", mu), ("nu", nu)):
                q, scale = _leaf(tree, leaf)
                _set(opt.state[f"{m}_q"][j], torch.from_numpy(np.array(q, copy=True)),
                     f"{m}.{leaf}.q")
                _set(opt.state[f"{m}_scale"][j], _t(scale), f"{m}.{leaf}.scale")
        return
    if not isinstance(opt, ClippedAdamW):
        raise TypeError(f"no JAX Adam moments for {type(opt).__name__}")
    for name, p in zip(opt.names, opt.params):
        leaf, layer, transpose = jax_leaf(name)
        state = opt.opt.state[p]
        state["step"] = torch.tensor(float(count))
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            x = np.asarray(_leaf(tree, leaf))
            x = _t(x if layer is None else x[layer])
            state[key] = (x.T if transpose and x.dim() == 2 else x).contiguous().to(p.device)


# ---------------------------------------------------------------------------
# the evaluation networks
# ---------------------------------------------------------------------------

def load_jax_inception(tree: Mapping, *, device="cuda") -> nn.Module:
    """The JAX FID InceptionV3 tree ({<Mixed_x>: {<branch>: {"w": HWIO,
    "b"}}, <stem conv>: {...}}, BatchNorm already folded) -> an
    ``evaluation.inception.InceptionV3``."""
    from textflux_torch.evaluation.inception import InceptionV3, all_conv_specs

    model = InceptionV3(device=device)
    for path, _ in all_conv_specs():
        node = tree
        for part in path.split("."):
            node = node[part]
        _conv(model.conv(path), node, path)
    return model


def load_jax_lpips(tree: Mapping, *, device="cuda") -> nn.Module:
    """The JAX LPIPS tree ({"net": {"convs": [{"w", "b"}]}, "lins": [{"w":
    (1, 1, C, 1)}]}) -> an ``evaluation.lpips.LPIPS``."""
    from textflux_torch.evaluation.lpips import LPIPS

    model = LPIPS(device=device)
    for i, p in enumerate(tree["net"]["convs"]):
        _conv(model.convs[i], p, f"net.convs[{i}]")
    for i, p in enumerate(tree["lins"]):
        _set(model.lins[i].weight, _t(p["w"]).permute(3, 2, 0, 1), f"lins[{i}].w")
    return model


def load_jax_ppocr(tree: Mapping, cfg, *, device="cuda") -> nn.Module:
    """The JAX PP-OCR tree (``init_ppocr_params`` / ``convert_ppocr_state_dict``
    layout: convs HWIO without bias, BatchNorm {scale, bias, mean, var},
    dense {"w": (in, out), "b"}, LayerNorm {scale, bias}) -> an
    ``evaluation.ppocr.RecModel`` for `cfg` (a ``PPOCRConfig``)."""
    from textflux_torch.evaluation.ppocr import RecModel

    model = RecModel(cfg, device=device)

    def conv_bn(mod, p, what):
        conv, bn = (getattr(mod, n) for n in mod.names)
        _set(conv.weight, _t(p["conv"]["w"]).permute(3, 2, 0, 1), what + ".conv.w")
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            _set(getattr(bn, ours), _t(p["bn"][theirs]), f"{what}.bn.{theirs}")

    def layer_norm(mod, p, what):
        _set(mod.weight, _t(p["scale"]), what + ".scale")
        _set(mod.bias, _t(p["bias"]), what + ".bias")

    bb, tb = model.backbone, tree["backbone"]
    conv_bn(bb.conv1, tb["conv1"], "backbone.conv1")
    for i, (blk, p) in enumerate(zip(bb.block_list, tb["blocks"])):
        conv_bn(blk._depthwise_conv, p["dw"], f"backbone.blocks[{i}].dw")
        conv_bn(blk._pointwise_conv, p["pw"], f"backbone.blocks[{i}].pw")
        if blk._se is not None:
            for name in ("conv1", "conv2"):
                _conv(getattr(blk._se, name), p["se"][name], f"backbone.blocks[{i}].se.{name}")
    enc, tn = model.neck.encoder, tree["neck"]
    for name in ("conv1", "conv2", "conv3", "conv4", "conv1x1"):
        conv_bn(getattr(enc, name), tn[name], f"neck.{name}")
    layer_norm(enc.norm, tn["norm"], "neck.norm")
    for i, (blk, p) in enumerate(zip(enc.svtr_block, tn["blocks"])):
        what = f"neck.blocks[{i}]"
        layer_norm(blk.norm1, p["norm1"], what + ".norm1")
        layer_norm(blk.norm2, p["norm2"], what + ".norm2")
        _dense(blk.mixer, "qkv", p["qkv"], what + ".qkv")
        _dense(blk.mixer, "proj", p["proj"], what + ".proj")
        _dense(blk.mlp, "fc1", p["fc1"], what + ".fc1")
        _dense(blk.mlp, "fc2", p["fc2"], what + ".fc2")
    _dense(model.head, "fc", tree["head"], "head")
    return model
