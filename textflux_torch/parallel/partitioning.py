"""Device mesh and tensor-parallel partitioning over ``torch.distributed``.

The port of ``textflux_tpu/parallel/partitioning.py``. Mesh axes:

  data   -- batch parallelism: each data rank serves its own slice of a batch;
  fsdp   -- parameter sharding (training, ``shard_for_training``; serving
            refuses fsdp > 1, see ``ITEM_6B_II``); the batch shards over
            (data, fsdp) jointly;
  tensor -- Megatron tensor parallelism over attention heads and MLP columns
            (serving; training refuses tp > 1).

The JAX package places whole arrays on the mesh and lets GSPMD insert the
collectives. Here every rank holds plain local shards and runs explicit
collectives, as the JAX package's ``shard_map`` bodies do by hand: a
column-parallel linear holds its rank's output rows and, where its output
must be whole, all-gathers it; a row-parallel linear holds its rank's input
columns, and its partial products are summed with an all-reduce over the
tensor sub-group, its bias added once after the sum. The hand-written
attention kernel takes raw pointers, so each rank launches it on its own
heads.

``flux_param_specs`` names each linear of the DiT column-parallel, row-parallel or
replicated (the JAX package's assignment); ``adapt_specs_to_params`` maps
that onto every tensor of a module, quantised layouts included;
``shard_module`` slices a module to one rank's shard. Each collective here
counts its calls (``<function>.calls``), beside the kernels' launch
counters.

Training shards over the fsdp axis with FSDP2 (``shard_for_training``):
every parameter becomes a ``DTensor`` holding this rank's slice, each block
and the root gather their weights as they are called and reduce-scatter
their gradients; ``ShardSpec`` says where a rank's slice lies in the whole
tensor, for the optimizer's reductions, checkpoints and export.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

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
# what stays open of the sharded axes: tensor parallelism in training, the
# fsdp axis in serving, a quantised base over fsdp > 1
ITEM_6B_II = "ROADMAP Queue 1 item 6b-ii"
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
        self.data_group = device_mesh.get_group("data")

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
    loads: serving takes no fsdp axis yet (``ITEM_6B_II``)."""
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: expected three positive sizes dp,fsdp,tp")
    if shape[1] > 1:
        raise NotImplementedError(
            f"--mesh {text}: serving with fsdp > 1 (weights sharded for training) is not "
            f"ported yet ({ITEM_6B_II}); use dp,1,tp")
    return shape


def check_serving_mesh(mesh: Mesh) -> None:
    if mesh.shape["fsdp"] > 1:
        raise NotImplementedError(f"serving on a mesh with fsdp = {mesh.shape['fsdp']} > 1 "
                                  f"is not ported yet ({ITEM_6B_II})")


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


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's x, in data-rank order, concatenated along the
    first axis (the whole batch on every rank)."""
    check_serving_mesh(mesh)   # the data group alone spans the batch's slices
    parts = [torch.empty_like(x) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    all_gather_batch.calls += 1
    return torch.cat(parts)


def agree(flags: Sequence[bool]) -> list:
    """Each flag AND-ed over every rank: a decision the ranks take together
    before any collective depends on it (an item one rank drops would leave
    the others waiting in a collective)."""
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [bool(f) for f in flags])
    return [all(col) for col in zip(*lists)]


COLLECTIVES = (all_reduce_sum, all_reduce_max, all_gather_last, all_gather_batch)


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


def _cut(t: torch.Tensor, axis: int, part: slice) -> torch.Tensor:
    return (t[part] if axis == 0 else t[:, part]).clone()


@torch.no_grad()
def _shard_linear(lin: nn.Module, kind: str, tp: int, rank: int) -> None:
    """Slice `lin` in place to rank `rank`'s shard."""
    if any(getattr(lin, k, None) is not None for k in LORA_KEYS):
        raise NotImplementedError(
            "a linear carrying LoRA factors cannot be sharded: fold the LoRA into the "
            f"base first (serving folds it at load); LoRA over a sharded base is {ITEM_6B_II}")
    quant = isinstance(lin, QuantLinear)
    if quant and kind == ROW and lin.mode == "nf4":
        raise ValueError("cannot slice the input rows of NF4 codes (packed as a half "
                         "split): quantise the rank's slice of the unquantised weight")
    n = lin.out_features if kind == COLUMN else lin.in_features
    part = shard_range(n, tp, rank)
    for name, t in list(lin.named_parameters(recurse=False)) + list(
            lin.named_buffers(recurse=False)):
        axis = 0 if kind == COLUMN else _ROW_CUT.get(name)
        if axis is None:
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
    Works on the ``meta`` device too (the sharded checkpoint load)."""
    plan = plan or {}
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
        if kind != REPLICATED:
            _shard_linear(lin, kind, tp, rank)
        if late:
            lin = QuantLinear.from_linear(lin, mode)
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
# FSDP: training over the fsdp axis (tp = 1)
# ---------------------------------------------------------------------------

def check_training_mesh(mesh: Mesh) -> None:
    """Training shards parameters over fsdp and the batch over (data, fsdp);
    a tensor axis in training is not ported yet."""
    if mesh.tensor > 1:
        raise NotImplementedError(f"training at tp = {mesh.tensor} > 1 (mesh {mesh.shape}) is "
                                  f"not ported yet ({ITEM_6B_II}); use dp,fsdp,1")


def fsdp_mesh(mesh: Mesh):
    """The ``DeviceMesh`` FSDP shards over: the fsdp axis, or (data, fsdp)
    with data > 1 (HSDP: each data replica holds the same fsdp shards, as
    the JAX package replicates its fsdp-sharded arrays over data)."""
    dm = mesh.device_mesh
    return dm["fsdp"] if mesh.shape["data"] == 1 else dm["data", "fsdp"]


def shard_for_training(model: nn.Module, mesh: Mesh, *,
                       compute_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """FSDP over the fsdp axis of `mesh` (the JAX ``shard_tree`` of
    ``flux_param_specs`` at tp = 1), in place: ``fully_shard`` of each
    double and single block, then of the root, which takes the embedders
    and the output head. Each parameter becomes a ``DTensor`` holding this
    rank's slice: an ``nn.Linear`` weight, stored (out, in), is split along
    its input axis (dim 1; the JAX package's fsdp axis of a column-parallel
    weight), every other tensor along dim 0 (biases, q/k scales, LoRA
    factors). A module gathers its weights when called, in
    `compute_dtype` (each product casts its weight to the activation dtype
    anyway: ``models.layers.dense``), and reduce-scatters the gradients in
    float32, averaged over the batch's ranks. Attached LoRA factors shard
    with their block. A quantised base (buffers, which FSDP does not
    shard) raises."""
    check_training_mesh(mesh)
    if any(isinstance(m, QuantLinear) for m in model.modules()):
        raise NotImplementedError(f"a quantised base over fsdp > 1 is not ported yet "
                                  f"({ITEM_6B_II}): its codes are buffers, which FSDP does "
                                  "not shard")
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
