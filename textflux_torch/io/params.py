"""Checkpoint ingestion: diffusers/transformers safetensors -> the port's modules.

The port of ``textflux_tpu/io/params.py``. Names map straight onto the
port's modules: ``nn.Linear`` already holds (out, in) and ``nn.Conv2d``
OIHW, so nothing is transposed. The fused projections take their parts as
row blocks, in the JAX package's column order:

  * double blocks: ``img_qkv`` = to_q | to_k | to_v,
    ``txt_qkv`` = add_q_proj | add_k_proj | add_v_proj;
  * single blocks: ``linear1`` = to_q | to_k | to_v | proj_mlp.

Each ``*_key_map(model)`` gives, for every checkpoint key, the parameter it
fills and the rows it fills (None: all of it); ``io.export`` walks the same
maps the other way. Loading builds the module on the ``meta`` device and
allocates it with ``to_empty`` (no random-init pass), then copies tensor by
tensor from the mapped files into place: no host copy of the state dict is
made. Parameters whose name ends in ``scale`` (the RMSNorm/LayerNorm/
GroupNorm scales) stay float32, the rest take ``dtype``, as the JAX
package's ``to_device_params`` does; ``dtype`` may also be a function of
the parameter's name (full-parameter training's float32 masters beside
frozen bf16 weights). A checkpoint key the module does not
take, or a module parameter the checkpoint lacks, raises: a dropped tensor
would give wrong images and no error.

With ``quantize`` a mode of ``io.quantize``, the linears that
``io.quantize.quantize_tree`` picks are swapped for empty ``QuantLinear``s
on ``meta`` before anything is allocated, and each of their weights is
quantised row block by row block as it streams in (after the transform,
e.g. a LoRA fold): the device never holds the full-precision module.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from textflux_torch.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig
from textflux_torch.device import resolve_device
from textflux_torch.io.quantize import QuantLinear, quantize_plan, quantize_tree
from textflux_torch.io.safetensors import DTYPES, SafetensorsFile, read_header

# checkpoint key -> (parameter, or the QuantLinear a weight quantises into;
# rows of it or None)
KeyMap = Dict[str, Tuple[Union[torch.Tensor, QuantLinear], Optional[slice]]]
# (checkpoint key, tensor as stored) -> the tensor to copy in
Transform = Callable[[str, torch.Tensor], torch.Tensor]
# a module's parameter dtype: one for all, or one per parameter name
DType = Union[torch.dtype, Callable[[str], torch.dtype]]


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def safetensors_files(path: str) -> List[str]:
    """Every *.safetensors shard in a directory (sorted), or a single file."""
    files = []
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
    elif path.endswith(".safetensors") and os.path.exists(path):
        files = [path]
    if not files:
        raise FileNotFoundError(f"no safetensors found under {path}")
    return files


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every shard in a directory (or a single file) in one
    dict: CPU tensors that are views of the mapped files."""
    out: Dict[str, torch.Tensor] = {}
    for f in safetensors_files(path):
        with SafetensorsFile(f) as reader:
            for name in reader.keys():
                out[name] = reader.get_tensor(name)
    return out


def checkpoint_keys(path: str) -> List[str]:
    """The tensor names of a directory or file, from the headers alone."""
    keys = []
    for f in safetensors_files(path):
        header, _ = read_header(f)
        keys += [k for k in header if k != "__metadata__"]
    return keys


def checkpoint_bytes(path: str) -> int:
    return sum(os.path.getsize(f) for f in safetensors_files(path))


def checkpoint_dtypes(path: str, cfg) -> Dict[str, torch.dtype]:
    """From the headers alone: the dtype each parameter of the port's
    module for `cfg` is stored in under `path` (parameter name -> the dtype
    of the checkpoint tensors that fill it; float32 where they differ)."""
    model = _modules()[type(cfg)][0](cfg, device="meta")
    keys = key_map(model)
    name_of = {id(p): name for name, p in model.named_parameters()}
    use = _resolve_keys(keys, checkpoint_keys(path))
    found: Dict[str, set] = {}
    for f in safetensors_files(path):
        header, _ = read_header(f)
        for src_key, entry in header.items():
            if src_key in use:
                name = name_of[id(keys[use[src_key]][0])]
                found.setdefault(name, set()).add(DTYPES[entry["dtype"]])
    return {name: d.pop() if len(d) == 1 else torch.float32 for name, d in found.items()}


# ---------------------------------------------------------------------------
# Key maps: checkpoint names -> the port's parameters
# ---------------------------------------------------------------------------

def _lin(out: KeyMap, name: str, lin: nn.Module, rows: Optional[slice] = None) -> None:
    out[f"{name}.weight"] = (lin if isinstance(lin, QuantLinear) else lin.weight, rows)
    if lin.bias is not None:
        out[f"{name}.bias"] = (lin.bias, rows)


def _blocks(lin: nn.Linear, parts: Iterable[Tuple[str, int]]):
    """(name, row slice) of each part of a fused projection, in order."""
    start = 0
    for name, size in parts:
        yield name, slice(start, start + size)
        start += size
    if start != lin.out_features:
        raise ValueError(f"parts cover {start} of {lin.out_features} rows")


def flux_key_map(model) -> KeyMap:
    """diffusers FluxTransformer2DModel names -> FluxTransformer parameters."""
    cfg = model.cfg
    d, m = cfg.hidden_dim, cfg.mlp_dim
    out: KeyMap = {}
    _lin(out, "x_embedder", model.img_in)
    _lin(out, "context_embedder", model.txt_in)
    embedders = [("timestep_embedder", model.time_in), ("text_embedder", model.vector_in)]
    if cfg.guidance_embeds:
        embedders.append(("guidance_embedder", model.guidance_in))
    for name, mlp in embedders:
        _lin(out, f"time_text_embed.{name}.linear_1", mlp.fc1)
        _lin(out, f"time_text_embed.{name}.linear_2", mlp.fc2)
    _lin(out, "norm_out.linear", model.final_mod)
    _lin(out, "proj_out", model.final_proj)
    for i, blk in enumerate(model.double_blocks):
        pre = f"transformer_blocks.{i}"
        _lin(out, f"{pre}.norm1.linear", blk.img_mod)
        _lin(out, f"{pre}.norm1_context.linear", blk.txt_mod)
        for proj, rows in _blocks(blk.img_qkv, (("to_q", d), ("to_k", d), ("to_v", d))):
            _lin(out, f"{pre}.attn.{proj}", blk.img_qkv, rows)
        for proj, rows in _blocks(blk.txt_qkv, (("add_q_proj", d), ("add_k_proj", d),
                                                ("add_v_proj", d))):
            _lin(out, f"{pre}.attn.{proj}", blk.txt_qkv, rows)
        for norm, prm in (("norm_q", blk.img_q_scale), ("norm_k", blk.img_k_scale),
                          ("norm_added_q", blk.txt_q_scale), ("norm_added_k", blk.txt_k_scale)):
            out[f"{pre}.attn.{norm}.weight"] = (prm, None)
        _lin(out, f"{pre}.attn.to_out.0", blk.img_proj)
        _lin(out, f"{pre}.attn.to_add_out", blk.txt_proj)
        _lin(out, f"{pre}.ff.net.0.proj", blk.img_mlp.fc1)
        _lin(out, f"{pre}.ff.net.2", blk.img_mlp.fc2)
        _lin(out, f"{pre}.ff_context.net.0.proj", blk.txt_mlp.fc1)
        _lin(out, f"{pre}.ff_context.net.2", blk.txt_mlp.fc2)
    for i, blk in enumerate(model.single_blocks):
        pre = f"single_transformer_blocks.{i}"
        _lin(out, f"{pre}.norm.linear", blk.mod)
        for proj, rows in _blocks(blk.linear1, (("attn.to_q", d), ("attn.to_k", d),
                                                ("attn.to_v", d), ("proj_mlp", m))):
            _lin(out, f"{pre}.{proj}", blk.linear1, rows)
        out[f"{pre}.attn.norm_q.weight"] = (blk.q_scale, None)
        out[f"{pre}.attn.norm_k.weight"] = (blk.k_scale, None)
        _lin(out, f"{pre}.proj_out", blk.linear2)
    return out


def _conv(out: KeyMap, name: str, c: nn.Conv2d) -> None:
    out[f"{name}.weight"] = (c.weight, None)
    out[f"{name}.bias"] = (c.bias, None)


def _norm(out: KeyMap, name: str, p: nn.Module) -> None:
    out[f"{name}.weight"] = (p.scale, None)
    out[f"{name}.bias"] = (p.bias, None)


def vae_key_map(model) -> KeyMap:
    """diffusers AutoencoderKL names -> FluxVAE parameters."""
    out: KeyMap = {}

    def resnet(pre, r):
        _norm(out, f"{pre}.norm1", r.norm1)
        _conv(out, f"{pre}.conv1", r.conv1)
        _norm(out, f"{pre}.norm2", r.norm2)
        _conv(out, f"{pre}.conv2", r.conv2)
        if r.skip is not None:
            _conv(out, f"{pre}.conv_shortcut", r.skip)

    def mid(pre, mb):
        resnet(f"{pre}.resnets.0", mb.res1)
        resnet(f"{pre}.resnets.1", mb.res2)
        _norm(out, f"{pre}.attentions.0.group_norm", mb.attn.norm)
        for name, lin in (("to_q", mb.attn.q), ("to_k", mb.attn.k), ("to_v", mb.attn.v),
                          ("to_out.0", mb.attn.out)):
            _lin(out, f"{pre}.attentions.0.{name}", lin)

    enc, dec = model.encoder, model.decoder
    _conv(out, "encoder.conv_in", enc.conv_in)
    for i, block in enumerate(enc.down):
        for j, r in enumerate(block.resnets):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", r)
        if block.down is not None:
            _conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", block.down)
    mid("encoder.mid_block", enc.mid)
    _norm(out, "encoder.conv_norm_out", enc.norm_out)
    _conv(out, "encoder.conv_out", enc.conv_out)
    _conv(out, "decoder.conv_in", dec.conv_in)
    mid("decoder.mid_block", dec.mid)
    for i, block in enumerate(dec.up):
        for j, r in enumerate(block.resnets):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", r)
        if block.up is not None:
            _conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", block.up)
    _norm(out, "decoder.conv_norm_out", dec.norm_out)
    _conv(out, "decoder.conv_out", dec.conv_out)
    return out


def clip_key_map(model) -> KeyMap:
    """transformers CLIPTextModel names -> CLIPTextModel parameters."""
    pre = "text_model"
    out: KeyMap = {
        f"{pre}.embeddings.token_embedding.weight": (model.token_embedding, None),
        f"{pre}.embeddings.position_embedding.weight": (model.position_embedding, None),
    }
    for i, layer in enumerate(model.layers):
        lp = f"{pre}.encoder.layers.{i}"
        _norm(out, f"{lp}.layer_norm1", layer.ln1)
        for name, lin in (("self_attn.q_proj", layer.q), ("self_attn.k_proj", layer.k),
                          ("self_attn.v_proj", layer.v), ("self_attn.out_proj", layer.o),
                          ("mlp.fc1", layer.fc1), ("mlp.fc2", layer.fc2)):
            _lin(out, f"{lp}.{name}", lin)
        _norm(out, f"{lp}.layer_norm2", layer.ln2)
    _norm(out, f"{pre}.final_layer_norm", model.final_ln)
    return out


def t5_key_map(model) -> KeyMap:
    """transformers T5EncoderModel names -> T5Encoder parameters."""
    out: KeyMap = {
        "shared.weight": (model.embedding, None),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            (model.rel_bias, None),
        "encoder.final_layer_norm.weight": (model.final_norm, None),
    }
    for i, layer in enumerate(model.layers):
        lp = f"encoder.block.{i}"
        out[f"{lp}.layer.0.layer_norm.weight"] = (layer.attn_norm, None)
        for name in ("q", "k", "v", "o"):
            _lin(out, f"{lp}.layer.0.SelfAttention.{name}", getattr(layer, name))
        out[f"{lp}.layer.1.layer_norm.weight"] = (layer.mlp_norm, None)
        for name in ("wi_0", "wi_1", "wo"):
            _lin(out, f"{lp}.layer.1.DenseReluDense.{name}", getattr(layer, name))
    return out


# checkpoint keys that name the same tensor as a mapped one (loaded only
# when the mapped key is absent), and keys that hold no weight
ALIASES = {"encoder.embed_tokens.weight": "shared.weight"}   # T5's tied embedding
NOT_WEIGHTS = ("text_model.embeddings.position_ids",)       # a CLIP index buffer


def _modules():
    """config type -> (module class, key map)."""
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE

    return {FluxConfig: (FluxTransformer, flux_key_map), VAEConfig: (FluxVAE, vae_key_map),
            CLIPTextConfig: (CLIPTextModel, clip_key_map), T5Config: (T5Encoder, t5_key_map)}


def key_map(model) -> KeyMap:
    """The checkpoint key map of any of the port's four modules."""
    return _modules()[type(model.cfg)][1](model)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def _meta_module(cfg, dtype: DType) -> nn.Module:
    """The port's module for `cfg` on the meta device, each parameter in its
    dtype (see ``empty_module``)."""
    table = _modules()
    if type(cfg) not in table:
        raise TypeError(f"no port module for config type {type(cfg).__name__}")
    model = table[type(cfg)][0](cfg, device="meta",
                                dtype=torch.float32 if callable(dtype) else dtype)
    for prefix, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            want = (torch.float32 if name.endswith("scale")
                    else dtype(f"{prefix}.{name}" if prefix else name) if callable(dtype)
                    else dtype)
            if p.dtype != want:
                mod._parameters[name] = nn.Parameter(p.to(want), requires_grad=p.requires_grad)
    return model


def empty_module(cfg, *, device="cuda", dtype: DType = torch.bfloat16,
                 quantize: Optional[str] = None) -> nn.Module:
    """The port's module for `cfg` with uninitialised storage on `device`:
    built on the meta device, then allocated. Parameters named ``*scale``
    are float32, the rest `dtype`: one dtype, or a function of the
    parameter's name (``"double_blocks.3.img_qkv.weight"``) giving each its
    own, allocated once in it. With `quantize` (a ``quantize_tree`` mode),
    the linears it picks are empty ``QuantLinear``s."""
    device = resolve_device(device)
    model = _meta_module(cfg, dtype)
    if quantize:
        quantize_tree(model, mode=quantize)
    return model.to_empty(device=device)


def _resolve_keys(keys: KeyMap, present: Iterable[str]) -> Dict[str, str]:
    """checkpoint key -> key-map key for every tensor to load; raises on a
    key either side lacks."""
    present = set(present)
    use = {k: k for k in present if k in keys}
    for alias, canonical in ALIASES.items():
        if alias in present and canonical in keys and canonical not in present:
            use[alias] = canonical
    skipped = {k for k in present if k in ALIASES or k in NOT_WEIGHTS}
    unexpected = sorted(present - set(use) - skipped)
    missing = sorted(set(keys) - set(use.values()))
    if unexpected or missing:
        raise KeyError(f"checkpoint does not match the module: {len(missing)} missing "
                       f"{missing[:6]}, {len(unexpected)} unexpected {unexpected[:6]}")
    return use


@torch.no_grad()
def _copy(keys: KeyMap, key: str, src_key: str, tensor: torch.Tensor,
          transform: Optional[Transform]) -> None:
    target, rows = keys[key]
    if isinstance(target, QuantLinear):
        shape = target.rows_shape(rows)
    else:
        target = target if rows is None else target[rows]
        shape = target.shape
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{src_key}: checkpoint shape {tuple(tensor.shape)} != "
                         f"module shape {tuple(shape)}")
    if transform is not None:
        tensor = transform(src_key, tensor)
    if isinstance(target, QuantLinear):
        target.load_rows(rows, tensor)
    else:
        target.copy_(tensor)


def convert_state_dict(sd: Mapping[str, torch.Tensor], cfg, *, device="cuda",
                       dtype: DType = torch.bfloat16, transform: Optional[Transform] = None):
    """The port's module for `cfg`, filled from a state dict in the
    diffusers/transformers naming."""
    model = empty_module(cfg, device=device, dtype=dtype)
    keys = key_map(model)
    for src_key, key in _resolve_keys(keys, sd.keys()).items():
        _copy(keys, key, src_key, sd[src_key], transform)
    return model


def convert_flux_state_dict(sd, cfg: FluxConfig, **kw):
    """A diffusers FluxTransformer2DModel state dict -> FluxTransformer."""
    return convert_state_dict(sd, cfg, **kw)


def convert_vae_state_dict(sd, cfg: VAEConfig, **kw):
    """A diffusers AutoencoderKL state dict -> FluxVAE."""
    return convert_state_dict(sd, cfg, **kw)


def convert_clip_state_dict(sd, cfg: CLIPTextConfig, **kw):
    """A transformers CLIPTextModel state dict -> CLIPTextModel."""
    return convert_state_dict(sd, cfg, **kw)


def convert_t5_state_dict(sd, cfg: T5Config, **kw):
    """A transformers T5EncoderModel state dict -> T5Encoder (``shared.weight``
    preferred over its tied alias ``encoder.embed_tokens.weight``)."""
    return convert_state_dict(sd, cfg, **kw)


def load_checkpoint_dir(path: str, cfg, *, device="cuda", dtype: DType = torch.bfloat16,
                        transform: Optional[Transform] = None,
                        quantize: Optional[str] = None):
    """The port's module for `cfg`, streamed from the safetensors shards of
    `path` (a directory or one file): shard by shard, tensor by tensor in
    file order, each copied from the mapping straight into its parameter
    (or quantised into its ``QuantLinear`` with `quantize`), cast on the way
    to its parameter's dtype (`dtype`, see ``empty_module``). Each shard's
    mapping is dropped once its tensors are in."""
    model = empty_module(cfg, device=device, dtype=dtype, quantize=quantize)
    keys = key_map(model)
    use = _resolve_keys(keys, checkpoint_keys(path))
    for f in safetensors_files(path):
        with SafetensorsFile(f) as reader:
            for src_key in reader.keys():
                if src_key in use:
                    _copy(keys, use[src_key], src_key, reader.get_tensor(src_key), transform)
    return model


FLUX_CONFIG_CHECKS = {
    "in_channels": "in_channels",
    "num_layers": "num_double_layers",
    "num_single_layers": "num_single_layers",
    "num_attention_heads": "num_heads",
    "attention_head_dim": "head_dim",
    # the one mismatch that would otherwise fail silently: the guidance
    # embedder would be dropped and flux_vec would skip guidance
    # conditioning -- wrong images, no error
    "guidance_embeds": "guidance_embeds",
}


def check_flux_config(path: str, cfg: FluxConfig) -> None:
    """Hold a checkpoint directory's config.json (when present) against `cfg`."""
    config_file = os.path.join(path, "config.json")
    if not os.path.exists(config_file):
        return
    with open(config_file) as f:
        ref = json.load(f)
    for k, field in FLUX_CONFIG_CHECKS.items():
        ours = getattr(cfg, field)
        if k in ref and ref[k] != ours:
            raise ValueError(f"checkpoint {k}={ref[k]} != config {ours}")


def load_flux_transformer(path: str, cfg: FluxConfig, *, dtype: DType = torch.bfloat16,
                          device="cuda", transform: Optional[Transform] = None,
                          quantize: Optional[str] = None, mesh=None):
    """Load a diffusers-format transformer checkpoint (a directory of
    safetensors shards, optionally with a config.json that is validated
    against `cfg`) onto `device` in `dtype` (one, or one per parameter
    name: full-parameter training keeps its masters float32 and the frozen
    weights in the compute dtype), quantised as it streams in with
    `quantize`. Returns the FluxTransformer in the checkpoint's
    ("interleaved") q/k layout.

    With `mesh` (``parallel.partitioning.Mesh``) of a tensor axis tp > 1,
    the module is this rank's shard (``load_flux_shard``): the whole DiT
    never sits on one rank."""
    check_flux_config(path, cfg)
    if mesh is not None and mesh.tensor > 1:
        return load_flux_shard(path, cfg, tp=mesh.tensor, rank=mesh.tensor_rank,
                               device=device, dtype=dtype, transform=transform,
                               quantize=quantize)
    return load_checkpoint_dir(path, cfg, device=device, dtype=dtype, transform=transform,
                               quantize=quantize)


@torch.no_grad()
def load_flux_shard(path: str, cfg: FluxConfig, *, tp: int, rank: int, device="cuda",
                    dtype: DType = torch.bfloat16, transform: Optional[Transform] = None,
                    quantize: Optional[str] = None, min_size: Optional[int] = None):
    """Rank `rank` of `tp`'s shard of a transformer checkpoint, permuted
    device-major on the way in (``models.transformer.tp_permutations``) and
    sliced as ``parallel.partitioning.shard_linears`` slices a module: the
    same tensors as loading the whole DiT, then ``tp_permute_flux_params``
    and ``shard_module``. Each checkpoint tensor is read from the mapped
    file at the rows or columns of the shard (the whole tensor only where
    `transform` is given, e.g. a LoRA fold, which runs on the whole tensor
    before the slice) and quantised (with `quantize`) as
    ``shard_linears`` quantises: int8 row-parallel codes from the whole
    weight, NF4 ones from the slice (``quantize_plan``'s `min_size`)."""
    from textflux_torch.models.transformer import tp_permutations
    from textflux_torch.parallel import partitioning as PT

    device = resolve_device(device)
    model = _meta_module(cfg, dtype)
    whole = flux_key_map(model)              # shapes and rows of the whole module
    name_of = {id(p): name for name, p in model.named_parameters()}
    use = _resolve_keys(whole, checkpoint_keys(path))
    specs = PT.flux_param_specs(cfg)
    plan = quantize_plan(model, mode=quantize, min_size=min_size) if quantize else None
    PT.shard_linears(model, specs, tp, rank, plan)
    model = model.to_empty(device=device)
    model.tp_layout, model.tp_rank = tp, rank
    perms = tp_permutations(cfg, tp)

    def shard_index(mod_path: str, axis: int, n: int) -> torch.Tensor:
        part = PT.shard_range(n, tp, rank)
        axis_perm = perms.get(mod_path.rpartition(".")[2])
        if axis_perm is not None and axis_perm[0] == axis:
            return torch.as_tensor(axis_perm[1][part])
        return torch.arange(part.start, part.stop)

    for f in safetensors_files(path):
        with SafetensorsFile(f) as reader:
            for src_key in reader.keys():
                if src_key not in use:
                    continue
                key = use[src_key]
                param, rows = whole[key]
                tensor = reader.get_tensor(src_key)
                want = tuple(param.shape if rows is None else param[rows].shape)
                if tuple(tensor.shape) != want:
                    raise ValueError(f"{src_key}: checkpoint shape {tuple(tensor.shape)} != "
                                     f"module shape {want}")
                if transform is not None:
                    tensor = transform(src_key, tensor)
                mod_path, _, attr = name_of[id(param)].rpartition(".")
                kind = specs.get(mod_path, PT.REPLICATED)
                mod = model.get_submodule(mod_path)
                quant = isinstance(mod, QuantLinear)
                if kind == PT.COLUMN:
                    idx = shard_index(mod_path, 0, param.shape[0])
                    lo = 0 if rows is None else rows.start
                    hi = param.shape[0] if rows is None else rows.stop
                    sel = ((idx >= lo) & (idx < hi)).nonzero()[:, 0]
                    dst = slice(int(sel[0]), int(sel[-1]) + 1)   # contiguous: see _devmajor_idx
                    piece = tensor.index_select(0, (idx[sel] - lo).to(tensor.device))
                    if quant and attr == "weight":
                        mod.load_rows(dst, piece)
                    else:
                        getattr(mod, attr)[dst].copy_(piece)
                elif kind == PT.ROW and attr == "weight":
                    cols = shard_index(mod_path, 1, param.shape[1])
                    if quant:
                        mod.load_cols(cols, tensor)
                    else:
                        mod.weight.copy_(tensor.index_select(1, cols.to(tensor.device)))
                elif quant and attr == "weight":     # replicated
                    mod.load_rows(rows, tensor)
                else:                                # replicated, or a row-parallel bias
                    target = getattr(mod, attr)
                    (target if rows is None else target[rows]).copy_(tensor)
    return model


@torch.no_grad()
def load_flux_fsdp(path: str, cfg: FluxConfig, mesh, *, dtype: DType = torch.bfloat16,
                   device="cuda", compute_dtype: torch.dtype = torch.bfloat16,
                   prepare: Optional[Callable[[nn.Module], None]] = None):
    """This rank's FSDP shard of a transformer checkpoint for training over
    the fsdp axis of `mesh`: the module is built on the meta device (each
    parameter in its dtype, see ``empty_module``), handed to `prepare` (to
    attach what must shard with it, e.g. LoRA factors on the meta device),
    sharded by ``parallel.partitioning.shard_for_training`` and allocated,
    and each checkpoint tensor's rows or columns of this rank's slices are
    copied from the mapped file: the whole DiT never sits on a rank. What
    `prepare` attached is left uninitialised for the caller to fill."""
    from textflux_torch.parallel import partitioning as PT

    check_flux_config(path, cfg)
    device = resolve_device(device)
    model = _meta_module(cfg, dtype)
    if prepare is not None:
        prepare(model)
    PT.shard_for_training(model, mesh, compute_dtype=compute_dtype)
    model.to_empty(device=device)
    keys = flux_key_map(model)
    use = _resolve_keys(keys, checkpoint_keys(path))
    for f in safetensors_files(path):
        with SafetensorsFile(f) as reader:
            for src_key in reader.keys():
                if src_key not in use:
                    continue
                param, rows = keys[use[src_key]]
                tensor = reader.get_tensor(src_key)
                want = (param.shape[0] if rows is None else rows.stop - rows.start,
                        *param.shape[1:])
                if tuple(tensor.shape) != want:
                    raise ValueError(f"{src_key}: checkpoint shape {tuple(tensor.shape)} != "
                                     f"module shape {want}")
                spec, dst = PT.shard_spec(param), PT.local(param)
                lo = 0 if rows is None else rows.start
                if spec.dim == 0:   # rows [lo, lo + len) of the whole, this rank's part
                    a, b = max(lo, spec.start), min(lo + tensor.shape[0], spec.stop)
                    if a < b:
                        dst[a - spec.start:b - spec.start].copy_(tensor[a - lo:b - lo])
                else:
                    part = tensor.narrow(spec.dim, spec.start, spec.stop - spec.start)
                    (dst if rows is None else dst[rows]).copy_(part)
    return model
