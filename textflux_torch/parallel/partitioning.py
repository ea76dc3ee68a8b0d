"""Device mesh and tensor-parallel partitioning over ``torch.distributed``.

The port of ``textflux_tpu/parallel/partitioning.py``. Mesh axes:

  data   -- batch parallelism: each data rank serves its own slice of a batch;
  fsdp   -- parameter sharding: FSDP2 in training (``shard_for_training``),
            storage shards gathered block by block in serving and for a
            quantised base (``shard_storage``); the batch shards over (data,
            fsdp) jointly;
  tensor -- Megatron tensor parallelism over attention heads and MLP columns,
            in serving and in training.

The JAX package places whole arrays on the mesh and lets GSPMD insert the
collectives. Here every rank holds plain local shards and runs explicit
collectives, as the JAX package's ``shard_map`` bodies do by hand: a
column-parallel linear holds its rank's output rows and, where its output
must be whole, all-gathers it; a row-parallel linear holds its rank's input
columns, and its partial products are summed with an all-reduce over the
tensor sub-group, its bias added once after the sum. The hand-written
attention kernel takes raw pointers, so each rank launches it on its own
heads. In training the collectives are autograd functions that follow the
Megatron schedule (``copy_to_tensor``, ``reduce_from_tensor``,
``gather_from_tensor``); with no gradient to carry they are the plain
collectives above.

``flux_param_specs`` names each linear of the DiT column-parallel, row-parallel or
replicated (the JAX package's assignment); ``adapt_specs_to_params`` maps
that onto every tensor of a module, quantised layouts included;
``shard_module`` slices a module to one rank's shard and records on each
sharded linear where its share lies in the natural layout
(``TensorShare``): LoRA factors stay whole and replicated, and a rank's
forward takes its share of them. Each collective here counts its calls
(``<function>.calls``; the backward's all-reduce apart), beside the
kernels' launch counters.

Training shards over the fsdp axis with FSDP2 (``shard_for_training``):
every parameter becomes a ``DTensor`` holding this rank's slice, each block
and the root gather their weights as they are called and reduce-scatter
their gradients; ``ShardSpec`` says where a rank's slice lies in the whole
tensor, for the optimizer's reductions, checkpoints and export. Over a
tensor axis too, FSDP shards each rank's tensor shard over the fsdp
sub-mesh; ``whole_tensor`` / ``cut_whole`` go between a rank's slice and
the whole tensor in its natural layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from textflux_torch.device import resolve_device
from textflux_torch.io.quantize import OUT_AXIS_KEYS, QuantLinear, leaf_mode, quantize_plan

MESH_AXES = ("data", "fsdp", "tensor")
COLUMN, ROW, REPLICATED = "column", "row", "replicated"
# adapt_specs_to_params: a tensor that is not sliced but quantised anew from
# the rank's slice of the unquantised weight (an NF4 row-parallel linear)
REQUANTIZE = "requantize"
LORA_KEYS = ("lora_a", "lora_b", "lora_ga", "lora_gb")


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A ("data", "fsdp", "tensor") mesh over the ranks of the default
    process group: the ``DeviceMesh``, this rank's device and coordinates,
    and the sub-groups the serving collectives run over."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(MESH_AXES, (int(x) for x in device_mesh.mesh.shape)))
        self.coords = dict(zip(MESH_AXES, (int(x) for x in device_mesh.get_coordinate())))
        self.rank = dist.get_rank()
        self.tensor_group = device_mesh.get_group("tensor")
        self.fsdp_group = device_mesh.get_group("fsdp")
        self.batch_group = _batch_group(device_mesh, self.shape)

    @property
    def tensor(self) -> int:
        return self.shape["tensor"]

    @property
    def tensor_rank(self) -> int:
        return self.coords["tensor"]

    @property
    def batch_shards(self) -> int:
        """How many slices a batch is cut into (over ``batch_spec``'s axes)."""
        return math.prod(self.shape[a] for a in batch_spec())

    @property
    def batch_rank(self) -> int:
        """Which of those slices this rank serves."""
        rank = 0
        for a in batch_spec():
            rank = rank * self.shape[a] + self.coords[a]
        return rank

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, {self.device})"


def _batch_group(device_mesh, shape):
    """The process group of this rank's (data, fsdp) plane, its group ranks
    in ``batch_rank`` order: every rank makes each plane's group (``new_group``
    is a collective over the default group)."""
    ranks = device_mesh.mesh    # (data, fsdp, tensor) of global ranks
    mine = None
    for t in range(shape["tensor"]):
        members = [int(r) for r in ranks[:, :, t].reshape(-1).tolist()]
        group = dist.new_group(members)
        if dist.get_rank() in members:
            mine = group
    return mine


def make_mesh(shape: Optional[Sequence[int]] = None, *, device="cuda",
              timeout: Optional[timedelta] = None) -> Mesh:
    """A ("data", "fsdp", "tensor") mesh of `shape` (default: every rank on
    fsdp, as the JAX package's) over all ranks of the default process group.

    Without a default group, one is initialised from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for a
    CUDA `device`, gloo for ``device="cpu"``. An existing default group is
    used with its own backend (gloo for two ranks sharing one card, which
    NCCL refuses). This rank's device is ``cuda:{LOCAL_RANK}`` for
    ``device="cuda"``, or the device given. `timeout` bounds a collective of
    a group made here (default: torch's). A one-element all-reduce over
    every rank checks that all of them are there before the mesh is used."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no process group: run under torchrun --nproc-per-node N (it sets RANK, "
                "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or call "
                "torch.distributed.init_process_group first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", timeout=timeout)
    world = dist.get_world_size()
    shape = (1, world, 1) if shape is None else tuple(int(x) for x in shape)
    if len(shape) != 3 or min(shape) < 1 or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} must be 3 positive sizes (data, fsdp, tensor) "
                         f"whose product is the world size {world}")
    from torch.distributed.device_mesh import init_device_mesh

    mesh = Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=MESH_AXES), dev)
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    if int(ones.item()) != world:
        raise RuntimeError(f"all-reduce over {world} ranks gave {ones.item()}")
    return mesh


def serving_mesh_shape(text: str) -> Tuple[int, int, int]:
    """A CLI's ``--mesh dp,fsdp,tp`` as a shape, checked before anything
    loads."""
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: expected three positive sizes dp,fsdp,tp")
    return shape


def batch_spec() -> Tuple[str, str]:
    """The mesh axes a batch shards over, jointly: fsdp doubles as extra data
    parallelism."""
    return ("data", "fsdp")


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the tensor axis, in place: a row-parallel linear's
    partial products."""
    dist.all_reduce(x, group=mesh.tensor_group)
    all_reduce_sum.calls += 1
    return x


def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x's elementwise max over the tensor axis, in place: the per-token
    scale of w8a8 activations whose features are split over the ranks."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.tensor_group)
    all_reduce_max.calls += 1
    return x


def all_gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A column-parallel output made whole: every rank's x, in tensor-rank
    order, concatenated along the last axis."""
    parts = [torch.empty_like(x) for _ in range(mesh.tensor)]
    dist.all_gather(parts, x.contiguous(), group=mesh.tensor_group)
    all_gather_last.calls += 1
    return torch.cat(parts, dim=-1)


def all_reduce_grad(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A gradient summed over the tensor axis, out of place: the backward of
    ``copy_to_tensor``, the input gradient of a column-parallel product
    whose input every rank holds whole."""
    g = g.clone()
    dist.all_reduce(g, group=mesh.tensor_group)
    all_reduce_grad.calls += 1
    return g


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every batch slice's x, in ``batch_rank`` order, concatenated along
    the first axis (the whole batch on every rank): gathered over (data,
    fsdp) jointly, the ranks of one tensor group holding the same slice."""
    parts = [torch.empty_like(x) for _ in range(mesh.batch_shards)]
    dist.all_gather(parts, x.contiguous(), group=mesh.batch_group)
    all_gather_batch.calls += 1
    return torch.cat(parts)


class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the input gradient summed over the tensor axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_grad(g, ctx.mesh), None


class _ReduceFromTensor(torch.autograd.Function):
    """The partial products summed over the tensor axis; identity backward
    (every rank's partial product gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    """Every rank's columns, concatenated; backward, this rank's columns of
    the gradient (which every rank computes whole)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.part = (mesh.tensor_rank * x.shape[-1], x.shape[-1])
        return all_gather_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.part
        return g.narrow(-1, start, n).contiguous(), None


def _carries_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel product, which every rank holds
    whole: as it is, its gradient all-reduced over the tensor axis in the
    backward (the Megatron schedule's f)."""
    return _CopyToTensor.apply(x, mesh) if _carries_grad(x) else x


def reduce_from_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-parallel product's partial sums summed over the tensor axis
    (the Megatron schedule's g): in place where no gradient flows, as
    serving runs it."""
    return _ReduceFromTensor.apply(x, mesh) if _carries_grad(x) else all_reduce_sum(x, mesh)


def gather_from_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A column-parallel output made whole (``all_gather_last``), its
    gradient sliced back to this rank's columns."""
    return _GatherFromTensor.apply(x, mesh) if _carries_grad(x) else all_gather_last(x, mesh)


def agree(flags: Sequence[bool]) -> list:
    """Each flag AND-ed over every rank: a decision the ranks take together
    before any collective depends on it (an item one rank drops would leave
    the others waiting in a collective)."""
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [bool(f) for f in flags])
    return [all(col) for col in zip(*lists)]


def all_gather_storage(x: torch.Tensor, bounds, group) -> torch.Tensor:
    """A storage shard made whole over the fsdp ranks (``shard_storage``):
    rank r's part of `x`'s flat elements is bounds[r]."""
    all_gather_storage.calls += 1
    return all_gather_parts(x, bounds, group)


COLLECTIVES = (all_reduce_sum, all_reduce_max, all_gather_last, all_gather_batch,
               all_reduce_grad, all_gather_storage)


def reset_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = 0


def counts() -> Dict[str, int]:
    """{collective: calls since the last reset_counts}."""
    return {fn.__name__: fn.calls for fn in COLLECTIVES}


reset_counts()


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def flux_param_specs(cfg) -> Dict[str, str]:
    """{module path: COLUMN | ROW | REPLICATED} for every linear of the
    ``FluxTransformer`` of `cfg`, as the JAX package assigns them: the
    modulation linears, the fused q|k|v projections, linear1, every fc1 and
    the input embedders split their output (column-parallel); the attention
    output projections, every fc2 and linear2 split their input
    (row-parallel); the time / guidance / pooled embedders and the output
    head are replicated. The q/k norm scales are replicated (not linears)."""
    specs = {"img_in": COLUMN, "txt_in": COLUMN, "final_mod": REPLICATED,
             "final_proj": REPLICATED}
    embedders = ["time_in", "vector_in"] + (["guidance_in"] if cfg.guidance_embeds else [])
    for name in embedders:
        specs[f"{name}.fc1"] = specs[f"{name}.fc2"] = REPLICATED
    for i in range(cfg.num_double_layers):
        pre = f"double_blocks.{i}"
        for name in ("img_mod", "txt_mod", "img_qkv", "txt_qkv", "img_mlp.fc1", "txt_mlp.fc1"):
            specs[f"{pre}.{name}"] = COLUMN
        for name in ("img_proj", "txt_proj", "img_mlp.fc2", "txt_mlp.fc2"):
            specs[f"{pre}.{name}"] = ROW
    for i in range(cfg.num_single_layers):
        pre = f"single_blocks.{i}"
        specs[f"{pre}.mod"] = specs[f"{pre}.linear1"] = COLUMN
        specs[f"{pre}.linear2"] = ROW
    return specs


# each tensor of a linear in the port's (output axis first) layout: which
# axis a column / row split cuts
_ROW_CUT = {"weight": 1, "w_q": 1, "w_q8a8": 1}
_NF4_KEYS = ("w_nf4", "absmax4", "absmax8", "amax_lo", "amax_hi")


def adapt_specs_to_params(specs: Dict[str, str], model: nn.Module) -> Dict[str, object]:
    """{tensor name: the axis split over the tensor mesh axis, None
    (replicated) or REQUANTIZE} for every parameter and buffer of `model`.

    A column-parallel linear splits every tensor along its output axis (the
    first, in every quantised layout: codes, scales, NF4 absmax and the
    bias). A row-parallel one splits its weight or int8 codes along the
    input axis and keeps the per-output scale and the bias whole (the bias
    is added once, after the sum); its NF4 codes pack two input rows a byte
    as a half split, so a contiguous slice of them holds two apart chunks of
    input rows: they are REQUANTIZEd from the rank's slice of the
    unquantised weight instead. LoRA factors and the q/k norm scales are
    replicated. A tensor of unknown layout raises."""
    out = {}
    named = list(model.named_parameters()) + list(model.named_buffers())
    for name, _ in named:
        path, _, leaf = name.rpartition(".")
        kind = specs.get(path, REPLICATED)
        if kind == REPLICATED or leaf in LORA_KEYS:
            out[name] = None
        elif leaf not in OUT_AXIS_KEYS:
            raise KeyError(f"unknown tensor {name!r} of a sharded linear: add its layout to "
                           "adapt_specs_to_params")
        elif kind == COLUMN:
            out[name] = 0
        elif leaf in _NF4_KEYS:
            out[name] = REQUANTIZE
        else:
            out[name] = _ROW_CUT.get(leaf)
    return out


# ---------------------------------------------------------------------------
# Sharding a module
# ---------------------------------------------------------------------------

def shard_range(n: int, tp: int, rank: int) -> slice:
    """Rank `rank`'s contiguous share of an axis of `n` split `tp` ways."""
    if n % tp:
        raise ValueError(f"an axis of {n} does not split {tp} ways")
    return slice(rank * n // tp, (rank + 1) * n // tp)


def devmajor_index(segs: Sequence[int], tp: int) -> np.ndarray:
    """Index permutation mapping a fused axis [seg0 | seg1 | ...] to
    device-major layout [seg0_0 | seg1_0 | ... | seg0_1 | seg1_1 | ...]:
    contiguous share d of the permuted axis holds every segment's d-th
    chunk."""
    offs = np.concatenate([[0], np.cumsum(segs)[:-1]])
    parts = []
    for dev in range(tp):
        for off, seg in zip(offs, segs):
            c = seg // tp
            parts.append(off + dev * c + np.arange(c))
    return np.concatenate(parts)


def fused_segments(cfg) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """{linear name within a block: (axis, segments)} of each fused
    projection (axis 0: output rows, 1: input columns): img_qkv / txt_qkv
    out rows (d, d, d), linear1 out rows (d, d, d, mlp), linear2 in columns
    (d, mlp), matching the local [attn_r | gelu(mlp_r)] a rank's single
    block feeds it."""
    d, m = cfg.hidden_dim, cfg.mlp_dim
    return {"img_qkv": (0, (d, d, d)), "txt_qkv": (0, (d, d, d)),
            "linear1": (0, (d, d, d, m)), "linear2": (1, (d, m))}


@dataclasses.dataclass(frozen=True)
class TensorShare:
    """Where a sharded linear's share lies in its natural layout: a COLUMN
    linear holds output rows, a ROW linear input columns, of an axis made of
    `segs` (one segment, or a fused projection's), permuted device-major
    over `tp` and cut into contiguous shares, rank `rank`'s here."""

    kind: str
    segs: Tuple[int, ...]
    tp: int
    rank: int

    def index(self, rank: Optional[int] = None) -> torch.Tensor:
        """The natural indices, along the split axis, of `rank`'s share
        (default: this one's), in the order the shard holds them (rising)."""
        rank = self.rank if rank is None else rank
        part = shard_range(sum(self.segs), self.tp, rank)
        return torch.as_tensor(devmajor_index(self.segs, self.tp)[part])

    @functools.lru_cache(maxsize=None)
    def index_on(self, device: torch.device) -> torch.Tensor:
        return self.index().to(device)

    def segment_part(self) -> slice:
        """This rank's share of each segment (a grouped LoRA's columns)."""
        return shard_range(self.segs[0], self.tp, self.rank)


def _cut(t: torch.Tensor, axis: int, part: slice) -> torch.Tensor:
    return (t[part] if axis == 0 else t[:, part]).clone()


@torch.no_grad()
def _shard_linear(lin: nn.Module, kind: str, tp: int, rank: int) -> None:
    """Slice `lin` in place to rank `rank`'s shard. LoRA factors stay whole
    (replicated, as the JAX package's ``lora_param_specs``): the rank's
    forward takes its share of them (``models.layers.dense``)."""
    quant = isinstance(lin, QuantLinear)
    if quant and kind == ROW and lin.mode == "nf4":
        raise ValueError("cannot slice the input rows of NF4 codes (packed as a half "
                         "split): quantise the rank's slice of the unquantised weight")
    n = lin.out_features if kind == COLUMN else lin.in_features
    part = shard_range(n, tp, rank)
    for name, t in list(lin.named_parameters(recurse=False)) + list(
            lin.named_buffers(recurse=False)):
        axis = 0 if kind == COLUMN else _ROW_CUT.get(name)
        if axis is None or name in LORA_KEYS:
            continue
        if quant:
            lin._buffers[name] = _cut(t, axis, part)
        else:
            setattr(lin, name, nn.Parameter(_cut(t, axis, part), requires_grad=t.requires_grad))
    if kind == COLUMN:
        lin.out_features = part.stop - part.start
    else:
        lin.in_features = part.stop - part.start


def shard_linears(model: nn.Module, specs: Dict[str, str], tp: int, rank: int,
                  plan: Optional[Dict[str, str]] = None) -> nn.Module:
    """Slice every linear of `model` to rank `rank` of `tp` in place
    (contiguous shares: the caller has permuted the fused projections), and
    quantise those in `plan` ({path: mode}, of ``io.quantize.quantize_plan``
    on the whole module): an int8 row-parallel linear is quantised whole,
    then sliced (its per-output scale over the whole input row, as the JAX
    package shards it); an NF4 row-parallel one is quantised from its slice
    (the NF4 blocks of 64 input rows do not straddle a share of a multiple
    of 128, so the codes are those of the whole weight); a column-parallel
    or replicated one is quantised per output channel, the same either way.
    Each sharded linear records its ``TensorShare`` (``tp_share``); at tp =
    1 nothing is sliced. Works on the ``meta`` device too (the sharded
    checkpoint load)."""
    plan = plan or {}
    fused = fused_segments(model.cfg) if hasattr(model, "cfg") else {}
    for path, kind in specs.items():
        owner_path, _, name = path.rpartition(".")
        owner = model.get_submodule(owner_path) if owner_path else model
        lin = getattr(owner, name)
        mode = plan.get(path)
        if mode is not None and kind == ROW:
            # the mode the rank's slice can be stored in
            mode = leaf_mode(mode, lin.in_features // tp)
        late = kind == ROW and mode == "nf4"
        if mode is not None and not late:
            lin = QuantLinear.from_linear(lin, mode)
        split = kind != REPLICATED and tp > 1
        if split:
            n = lin.out_features if kind == COLUMN else lin.in_features
            _shard_linear(lin, kind, tp, rank)
            segs = fused.get(name, (None, (n,)))[1]
            share = TensorShare(kind, tuple(int(x) for x in segs), tp, rank)
        if late:
            lin = QuantLinear.from_linear(lin, mode)
        if split:
            lin.tp_share = share
        setattr(owner, name, lin)
    return model


def shard_module(model: nn.Module, specs: Dict[str, str], mesh: Mesh, *,
                 quantize: Optional[str] = None, min_size: Optional[int] = None) -> nn.Module:
    """Slice every linear of `model` (whose fused projections are already
    tp-permuted, ``models.transformer.tp_permute_flux_params``) to this
    rank's shard over the tensor axis, in place, quantised in `quantize`
    mode by ``quantize_tree``'s policy where asked (see ``shard_linears``).
    Records the rank on the module (``tp_rank``). This takes the place of
    the JAX package's ``shard_tree`` / ``replicate_tree``: what is
    replicated stays whole on every rank."""
    plan = quantize_plan(model, mode=quantize, min_size=min_size) if quantize else None
    shard_linears(model, specs, mesh.tensor, mesh.tensor_rank, plan)
    model.tp_rank = mesh.tensor_rank
    return model



# ---------------------------------------------------------------------------
# Storage shards over the fsdp axis: serving, and a quantised base
# ---------------------------------------------------------------------------

class StorageShard:
    """The tensors of one unit (a block, or the root without its blocks)
    kept as this rank's 1/fsdp of their elements, gathered whole while the
    unit runs and dropped after: the fsdp axis for what FSDP2 does not
    shard (a quantised base's codes and scales, which are buffers, and
    every weight in serving, where no gradient flows). Each tensor's
    elements split along its first axis by ``chunk_bounds``; the shards of
    one dtype share one flat buffer, gathered in one collective."""

    def __init__(self, entries, group):
        self.group = group
        self.depth = 0
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        self.rank = rank
        self.groups = []
        by_dtype: Dict[torch.dtype, list] = {}
        for owner, name, is_param, t in entries:
            by_dtype.setdefault(t.dtype, []).append((owner, name, is_param, t))
        for dtype, items in by_dtype.items():
            sizes, pieces = [], []
            for owner, name, is_param, t in items:
                inner = t[0].numel()
                sizes.append([(b - a) * inner for a, b in chunk_bounds(t.shape[0], n)])
                start = sum(sizes[-1][:rank])
                pieces.append(t.detach().reshape(-1)[start:start + sizes[-1][rank]])
            totals = [sum(col) for col in zip(*sizes)]
            bounds = [(sum(totals[:r]), sum(totals[:r + 1])) for r in range(n)]
            self.groups.append(dict(items=[(o, nm, ip, tuple(t.shape)) for o, nm, ip, t in items],
                                    sizes=sizes, flat=torch.cat(pieces), bounds=bounds))
            for owner, name, is_param, _ in items:
                _set(owner, name, is_param, None)

    def to_empty(self, device) -> None:
        """Allocate the shards on `device`, uninitialised (a shard made on
        the meta device, for a load to fill: ``stage`` / ``unstage``)."""
        for g in self.groups:
            g["flat"] = torch.empty_like(g["flat"], device=device)

    def _owned(self, owner: nn.Module):
        """(group, item, its offset in the group's shard) of each of
        `owner`'s tensors."""
        for g in self.groups:
            at = 0
            for item, sizes in zip(g["items"], g["sizes"]):
                if item[0] is owner:
                    yield g, item, sizes, at
                at += sizes[self.rank]

    def stage(self, owner: nn.Module) -> None:
        """Give `owner`'s tensors uninitialised whole storage, to be filled
        in place and kept by ``unstage``."""
        for g, (_, name, is_param, shape), _, _ in self._owned(owner):
            _set(owner, name, is_param, torch.empty(shape, dtype=g["flat"].dtype,
                                                    device=g["flat"].device))

    def unstage(self, owner: nn.Module) -> None:
        """Keep this rank's slice of `owner`'s (staged, filled) tensors in
        the shard, and drop them whole."""
        for g, (_, name, is_param, _), sizes, at in self._owned(owner):
            t = (owner._parameters if is_param else owner._buffers)[name]
            start = sum(sizes[:self.rank])
            g["flat"][at:at + sizes[self.rank]].copy_(
                t.reshape(-1)[start:start + sizes[self.rank]])
            _set(owner, name, is_param, None)

    def bytes(self) -> int:
        """The bytes this rank holds."""
        return sum(g["flat"].numel() * g["flat"].element_size() for g in self.groups)

    def gather(self) -> None:
        self.depth += 1
        if self.depth > 1:
            return
        for g in self.groups:
            whole = all_gather_storage(g["flat"], g["bounds"], self.group)
            offsets = [a for a, _ in g["bounds"]]
            for (owner, name, is_param, shape), sizes in zip(g["items"], g["sizes"]):
                parts = []
                for r, size in enumerate(sizes):
                    parts.append(whole[offsets[r]:offsets[r] + size])
                    offsets[r] += size
                _set(owner, name, is_param, torch.cat(parts).view(shape))

    def release(self) -> None:
        self.depth -= 1
        if self.depth > 0:
            return
        for g in self.groups:
            for owner, name, is_param, _ in g["items"]:
                _set(owner, name, is_param, None)


def _set(owner: nn.Module, name: str, is_param: bool, t: Optional[torch.Tensor]) -> None:
    if is_param:
        owner._parameters[name] = None if t is None else nn.Parameter(t, requires_grad=False)
    else:
        owner._buffers[name] = t


def _units(model: nn.Module) -> list:
    return [*model.double_blocks, *model.single_blocks, model]


def shard_storage(model: nn.Module, group, *, params: bool) -> nn.Module:
    """Keep 1/fsdp of every buffer (and, with `params`, every parameter) of
    `model`'s units as this rank's storage shard over `group`, in place:
    each double and single block, and the root (embedders and head), is
    gathered whole by a hook when it is called and dropped after its call
    (``StorageShard``); ``gathered`` does the same around a use outside a
    call. Over a tensor axis, the tensors are the rank's tensor shard."""
    units = _units(model)
    inner = {id(m) for u in units[:-1] for m in u.modules()}
    for unit in units:
        mods = [m for m in unit.modules() if unit is not model or id(m) not in inner]
        entries = []
        for m in mods:
            tensors = [(n, False, t) for n, t in m._buffers.items() if t is not None]
            if params:
                tensors += [(n, True, t) for n, t in m._parameters.items() if t is not None]
            entries += [(m, n, is_param, t) for n, is_param, t in tensors]
        unit._storage = StorageShard(entries, group)
        unit.register_forward_pre_hook(lambda mod, args: mod._storage.gather())
        unit.register_forward_hook(lambda mod, args, out: mod._storage.release())
    return model


@contextlib.contextmanager
def gathered(unit: nn.Module):
    """`unit`'s storage shards made whole for a use outside its call (the
    serving path's modulation vectors for a whole schedule); a unit without
    storage shards as it is."""
    storage = getattr(unit, "_storage", None)
    if storage is None:
        yield unit
        return
    storage.gather()
    try:
        yield unit
    finally:
        storage.release()


def storage_shards(model: nn.Module) -> Dict[int, StorageShard]:
    """{id(module): the ``StorageShard`` holding its tensors} over
    `model`'s units (empty without storage shards)."""
    out = {}
    for unit in _units(model):
        storage = getattr(unit, "_storage", None)
        for g in [] if storage is None else storage.groups:
            for owner, *_ in g["items"]:
                out[id(owner)] = storage
    return out


def storage_bytes(model: nn.Module) -> int:
    """Bytes of the storage shards a rank holds (0 without them)."""
    return sum(u._storage.bytes() for u in _units(model) if hasattr(u, "_storage"))


# ---------------------------------------------------------------------------
# Training over the mesh: FSDP2 over fsdp, tensor parallelism over tensor
# ---------------------------------------------------------------------------

def check_training_mesh(mesh: Mesh, model: Optional[nn.Module] = None) -> None:
    """Training shards parameters over fsdp, the batch over (data, fsdp) and
    heads and MLP columns over tensor: with tp > 1 the model must hold this
    rank's tensor shard (``shard_module`` or ``io.params.load_flux_shard``)."""
    tp = mesh.tensor
    if model is not None and tp > 1 and (getattr(model, "tp_layout", 1) != tp
                                         or getattr(model, "tp_rank", None) != mesh.tensor_rank):
        raise ValueError(f"training at tp = {tp} needs this rank's tensor shard (the model has "
                         f"tp_layout={getattr(model, 'tp_layout', 1)}, "
                         f"tp_rank={getattr(model, 'tp_rank', None)})")


def fsdp_mesh(mesh: Mesh):
    """The ``DeviceMesh`` FSDP shards over: the fsdp axis, or (data, fsdp)
    with data > 1 (HSDP: each data replica holds the same fsdp shards, as
    the JAX package replicates its fsdp-sharded arrays over data)."""
    dm = mesh.device_mesh
    return dm["fsdp"] if mesh.shape["data"] == 1 else dm["data", "fsdp"]


def shard_for_training(model: nn.Module, mesh: Mesh, *,
                       compute_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """FSDP over the fsdp axis of `mesh` (the JAX ``shard_tree`` of
    ``flux_param_specs``), in place: ``fully_shard`` of each double and
    single block, then of the root, which takes the embedders and the
    output head. Each parameter becomes a ``DTensor`` holding this rank's
    slice: an ``nn.Linear`` weight, stored (out, in), is split along its
    input axis (dim 1; the JAX package's fsdp axis of a column-parallel
    weight), every other tensor along dim 0 (biases, q/k scales, LoRA
    factors). A module gathers its weights when called, in `compute_dtype`
    (each product casts its weight to the activation dtype anyway:
    ``models.layers.dense``), and reduce-scatters the gradients in float32,
    averaged over the batch's ranks. Attached LoRA factors shard with their
    block. A quantised base's codes and scales (buffers, which FSDP does not
    shard, and never cast to `compute_dtype`) become storage shards over the
    fsdp ranks (``shard_storage``).

    With a tensor axis, `model` is this rank's tensor shard, which FSDP
    shards over the fsdp sub-mesh (2-D), and the module records the mesh
    (``tp_mesh``: the tensor group its whole tensors are gathered over). A
    mesh whose batch does not split (data = fsdp = 1) leaves the module
    unsharded: nothing to reduce."""
    check_training_mesh(mesh, model)
    if mesh.tensor > 1:
        model.tp_mesh = mesh
    if mesh.batch_shards == 1:
        return model
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    weights = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}
    kw = dict(mesh=fsdp_mesh(mesh),
              mp_policy=MixedPrecisionPolicy(param_dtype=compute_dtype,
                                             reduce_dtype=torch.float32,
                                             cast_forward_inputs=False),
              shard_placement_fn=lambda p: Shard(1) if id(p) in weights else Shard(0))
    for blk in [*model.double_blocks, *model.single_blocks]:
        fully_shard(blk, **kw)
    fully_shard(model, **kw)
    if mesh.shape["fsdp"] > 1 and any(isinstance(m, QuantLinear) for m in model.modules()):
        shard_storage(model, mesh.fsdp_group, params=False)
    return model


def chunk_bounds(size: int, n: int) -> list:
    """[(start, stop)] of each of `n` ranks' slices of an axis of `size`:
    torch.chunk's split, as FSDP2 shards (the last slices may be short or
    empty)."""
    c = -(-size // n)
    return [(min(r * c, size), min((r + 1) * c, size)) for r in range(n)]


def all_gather_parts(x: torch.Tensor, bounds, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, rank r's holding
    bounds[r]'s extent there (``all_gather`` of the parts padded to the
    longest, which gloo runs on CUDA tensors too)."""
    shape = list(x.shape)
    shape[dim] = max(b - a for a, b in bounds)
    pad = x.new_zeros(shape)
    pad.narrow(dim, 0, x.shape[dim]).copy_(x)
    parts = [torch.empty_like(pad) for _ in bounds]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([part.narrow(dim, 0, b - a) for part, (a, b) in zip(parts, bounds)],
                     dim=dim)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Where a ``shard_for_training`` parameter's local slice lies: indices
    [start, stop) of dim `dim` of the whole tensor of `shape` (torch.chunk's
    split over the fsdp ranks; a slice may be empty), gathered over
    `group`, the fsdp ranks (data replicas hold the same slices)."""

    dim: int
    start: int
    stop: int
    shape: torch.Size
    group: Any

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor (a view)."""
        return full.narrow(self.dim, self.start, self.stop - self.start)

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every fsdp rank's `local` slice (shaped as
        this parameter's), on every rank: a collective."""
        bounds = chunk_bounds(self.shape[self.dim], dist.get_world_size(self.group))
        return all_gather_parts(local, bounds, self.group, self.dim)

    def run(self, transpose: bool) -> Tuple[int, int]:
        """[first, last) of the slice's elements in the whole tensor
        flattened in the JAX package's order (transposed first where the
        port stores it so): one contiguous run, as the split dim comes first
        in that order."""
        shape = tuple(self.shape)[::-1] if transpose else tuple(self.shape)
        if self.dim != (len(shape) - 1 if transpose else 0):
            raise ValueError(f"dim {self.dim} of {shape} is not the leading one in the JAX order")
        inner = math.prod(shape[1:])
        return self.start * inner, self.stop * inner


def shard_spec(p: torch.Tensor) -> Optional[ShardSpec]:
    """The ``ShardSpec`` of a parameter ``shard_for_training`` sharded;
    None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(p, DTensor):
        return None
    axes = [i for i, pl in enumerate(p.placements) if isinstance(pl, Shard)]
    if len(axes) != 1:
        raise ValueError(f"expected one sharded mesh axis, got placements {p.placements}")
    axis = axes[0]
    dim = p.placements[axis].dim
    start, stop = chunk_bounds(p.shape[dim], p.device_mesh.size(axis))[
        p.device_mesh.get_local_rank(axis)]
    if p.to_local().shape[dim] != stop - start:
        raise ValueError(f"a local slice of {tuple(p.to_local().shape)} is not rows "
                         f"[{start}, {stop}) of dim {dim} of {tuple(p.shape)}")
    return ShardSpec(dim, start, stop, p.shape, p.device_mesh.get_group(axis))


def local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A ``DTensor``'s local slice (sharing its storage), a plain tensor as
    it is."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def full_tensor(p: torch.Tensor, *, host: bool = False) -> torch.Tensor:
    """The whole value of a parameter: a plain one detached as it is, a
    sharded one gathered (a collective: every fsdp rank calls this in the
    same order), on the host with `host`."""
    spec = shard_spec(p)
    if spec is None:
        return p.detach()
    whole = spec.full(local(p.detach()))
    return whole.cpu() if host else whole


# ---------------------------------------------------------------------------
# Whole tensors over fsdp and tensor
# ---------------------------------------------------------------------------

# the q/k norm scales -> the linear (in their block) whose output heads
# they scale: split over the tensor axis, a rank sees only its heads
NORM_SCALES = {"img_q_scale": "img_qkv", "img_k_scale": "img_qkv", "txt_q_scale": "txt_qkv",
               "txt_k_scale": "txt_qkv", "q_scale": "linear1", "k_scale": "linear1"}


# a LoRA factor's leaf: as attached to its linear, or as the optimizer names
# it (training.train.lora_named_parameters: "<linear path>.a" / ".b")
LORA_LEAVES = LORA_KEYS + ("a", "b")


def partial_over_tensor(model: nn.Module, name: str) -> bool:
    """Whether the gradient of `model`'s replicated parameter `name` is a
    tensor rank's part of the whole (to be summed over the tensor axis),
    decided from the sharding (each split linear's ``tp_share``): a LoRA
    factor of a split linear (the rank's forward uses its share of the
    factors), or a q/k norm scale of a block whose q|k|v projection is split
    (the rank sees its heads). Every other replicated parameter (the time /
    vector / guidance embedders, final_mod, final_proj, a row-parallel bias,
    a factor of a replicated linear) has its whole gradient on every rank,
    and is not summed."""
    path, _, leaf = name.rpartition(".")
    owner = model.get_submodule(path) if path else model
    if leaf in LORA_LEAVES:
        return getattr(owner, "tp_share", None) is not None
    if leaf in NORM_SCALES:
        return getattr(getattr(owner, NORM_SCALES[leaf]), "tp_share", None) is not None
    return False


def tensor_split(model: nn.Module, name: str) -> Optional[Tuple[int, TensorShare]]:
    """(the axis split over the tensor mesh axis, the share) of a parameter
    of a tensor-sharded `model` (``adapt_specs_to_params``' axis, with the
    owning linear's ``tp_share``), or None where it is replicated."""
    path, _, leaf = name.rpartition(".")
    owner = model.get_submodule(path) if path else model
    share = getattr(owner, "tp_share", None)
    if share is None or leaf in LORA_LEAVES:
        return None
    axis = 0 if share.kind == COLUMN else _ROW_CUT.get(leaf)
    return None if axis is None else (axis, share)


def gather_split(x: torch.Tensor, axis: int, share: TensorShare, group) -> torch.Tensor:
    """Every tensor rank's share of a split tensor, put back in the natural
    order along `axis` (a collective over `group`)."""
    parts = [torch.empty_like(x) for _ in range(share.tp)]
    dist.all_gather(parts, x.contiguous(), group=group)
    index = torch.cat([share.index(r) for r in range(share.tp)]).to(x.device)
    shape = list(x.shape)
    shape[axis] = index.numel()
    return x.new_empty(shape).index_copy_(axis, index, torch.cat(parts, dim=axis))


def whole_tensor(model: nn.Module, name: str, p: torch.Tensor, *,
                 host: bool = False) -> torch.Tensor:
    """The whole value of `model`'s parameter `name` (`p`) in its natural
    layout: gathered over the fsdp ranks where FSDP shards it
    (``full_tensor``), then, split over the tensor axis of the mesh the
    model is trained over (``tp_mesh``), over the tensor ranks with the
    device-major permutation undone. A collective: every rank calls it in
    the same order."""
    x = full_tensor(p)
    split = tensor_split(model, name)
    if split is not None:
        x = gather_split(x, *split, model.tp_mesh.tensor_group)
    return x.cpu() if host else x


def cut_whole(model: nn.Module, name: str, p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's part of a parameter's whole natural value: its tensor
    share (where split), then its fsdp slice (where sharded)."""
    split = tensor_split(model, name) if getattr(model, "tp_rank", None) is not None else None
    if split is not None:
        axis, share = split
        whole = whole.index_select(axis, share.index().to(whole.device))
    spec = shard_spec(p)
    return whole if spec is None else spec.cut(whole)
