"""Ranks for the port's multi-process tests: gloo on the CPU, spawned with
torch.multiprocessing.

Imports torch, numpy and textflux_torch only (no JAX): every rank is a
fresh process, one thread each. ``Ranks`` bounds its own time: every join
has a timeout, and a rank still alive at the end is killed. Each rank
function runs its cases one by one and returns {case: result}, a case that
raises giving {"error": traceback} instead, so one broken case does not
hide the others (a case that raises on one rank only leaves the others in
a collective until the group's timeout, ``GROUP_TIMEOUT``).
"""

import contextlib
import os
import pickle
import socket
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT = timedelta(seconds=120)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out_dir, args):
    torch.set_num_threads(1)
    result = None
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        result = fn(rank, world, *args)
    except BaseException:
        result = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """fn(rank, world, *args) started in `world` spawned ranks of one gloo
    group; ``results`` waits for them (the caller works meanwhile). Used as
    a context manager: every rank still alive on leaving it is killed."""

    def __init__(self, fn, world: int, *args):
        self.world = world
        self._dir = tempfile.TemporaryDirectory()
        ctx = mp.get_context("spawn")
        port = free_port()
        self.procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, self._dir.name,
                                                           args))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 240.0) -> list:
        """Each rank's result, in rank order."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} of {self.world} still running after {timeout} s")
        out = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self._dir.name, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with {p.exitcode} and no result")
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        self._dir.cleanup()


def run_cases(cases: dict) -> dict:
    """{name: result of fn()} over `cases` ({name: fn}); a case that raises
    gives {"error": traceback}."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


# ---------------------------------------------------------------------------
# pipelines from parameter trees (the tests/helpers.py tokenizers, copied: that
# module imports JAX)
# ---------------------------------------------------------------------------

def dummy_clip_tokenize(prompt: str) -> np.ndarray:
    ids = (np.frombuffer(prompt.encode()[:23].ljust(23), np.uint8) % 90).astype(np.int32)
    return np.concatenate([ids, [99]])[None]


def dummy_t5_tokenize(prompt: str) -> np.ndarray:
    ids = (np.frombuffer(prompt.encode()[:16].ljust(16), np.uint8) % 99).astype(np.int32)
    return ids[None]


def build_pipeline(spec: dict, **kw):
    """A port FillPipeline on the CPU from a spec of numpy parameter trees
    and port configs ({"flux", "vae", "clip", "t5"}: (tree, cfg); "pipe_cfg")."""
    from textflux_torch.io.from_jax import load_jax_params
    from textflux_torch.pipeline.fill import FillPipeline

    mods = {k: load_jax_params(tree, cfg, device="cpu")
            for k, (tree, cfg) in spec["modules"].items()}
    return FillPipeline(**mods, clip_tokenize=dummy_clip_tokenize,
                        t5_tokenize=dummy_t5_tokenize, pipe_cfg=spec["pipe_cfg"],
                        attn_impl=kw.pop("attn_impl", "plain"), device="cpu", **kw)


@contextlib.contextmanager
def float_images():
    """FillPipeline's generate_batch returns the float images (no uint8
    rounding) while the block runs."""
    from textflux_torch.pipeline import image_processor as improc

    orig = improc.postprocess_image
    improc.postprocess_image = lambda x: x
    try:
        yield
    finally:
        improc.postprocess_image = orig


@contextlib.contextmanager
def float32_pipelines():
    """FillPipeline.from_pretrained loads, and its pipelines serve, in
    float32 while the block runs (the CLIs' bf16 default rounds differently
    on the CPU's kernels at each shape)."""
    from textflux_torch.pipeline.fill import FillPipeline

    class F32(FillPipeline):
        def __call__(self, **kw):
            return super().__call__(**dict(kw, dtype=torch.float32))

        def generate_batch(self, *a, **kw):
            return super().generate_batch(*a, **dict(kw, dtype=torch.float32))

    orig = FillPipeline.__dict__["from_pretrained"]

    def load(cls, *a, **kw):
        pipe = orig.__func__(cls, *a, **dict(kw, dtype=torch.float32))
        pipe.__class__ = F32
        return pipe

    FillPipeline.from_pretrained = classmethod(load)
    try:
        yield
    finally:
        FillPipeline.from_pretrained = orig


class Float32:
    """A pipeline whose every call runs in float32 (the demo callbacks call
    it with no dtype)."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __call__(self, **kw):
        return self.pipe(**dict(kw, dtype=torch.float32))


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def flux_apply_rank(rank, world, spec):
    """flux_apply of a tiny DiT at mesh (1, 1, world), plain and fused."""
    import copy

    from textflux_torch.io.from_jax import load_jax_params
    from textflux_torch.models import transformer as TT
    from textflux_torch.ops.rope import rope_tables, rope_tables_half
    from textflux_torch.parallel import partitioning as PT

    cfg, x = spec["cfg"], spec["inputs"]
    mesh = PT.make_mesh((1, 1, world), device="cpu")
    base = load_jax_params(spec["tree"], cfg, device="cpu")
    args = [torch.as_tensor(x[k]) for k in ("img", "txt", "pooled", "timestep", "guidance")]

    def run(impl):
        model = copy.deepcopy(base)
        tables = rope_tables
        if impl == "fused":
            TT.half_permute_flux_params(model)
            tables = rope_tables_half
        TT.tp_permute_flux_params(model, world)
        PT.shard_module(model, PT.flux_param_specs(cfg), mesh)
        cos, sin = (torch.as_tensor(t) for t in tables(x["ids"], cfg.axes_dims_rope))
        PT.reset_counts()
        with torch.no_grad():
            out = TT.flux_apply(model, *args, cos, sin, attn_impl=impl, mesh=mesh)
        return dict(out=out.numpy(), counts=PT.counts(),
                    heads=model.double_blocks[0].img_qkv.out_features // 3 // cfg.head_dim)

    return run_cases({"plain": lambda: run("plain"), "fused": lambda: run("fused")})


def generate_batch_rank(rank, world, spec):
    """generate_batch of the tiny pipeline on a mesh, float images."""
    from textflux_torch.parallel import partitioning as PT

    mesh = PT.make_mesh(spec["shape"], device="cpu")
    pipe = build_pipeline(spec)
    pipe.shard_for_serving(mesh, quantize=spec.get("quantize", False),
                           quantize_min_size=spec.get("min_size"))
    PT.reset_counts()
    with float_images():
        out = pipe.generate_batch(**spec["call"], dtype=torch.float32)
    from textflux_torch.io.quantize import quantized_bytes

    whole = build_pipeline(spec).flux
    if spec.get("quantize"):
        from textflux_torch.io.quantize import quantize_tree

        quantize_tree(whole, mode=spec["quantize"], min_size=spec.get("min_size"))
    return dict(images=np.asarray(out), counts=PT.counts(), tp_rank=pipe.flux.tp_rank,
                batch_rank=mesh.batch_rank, storage_bytes=PT.storage_bytes(pipe.flux),
                whole_bytes=quantized_bytes(whole))


def quantized_rank(rank, world, specs):
    """generate_batch of the wide tiny pipeline sharded at (1, 1, world),
    one case per quantise mode."""
    return run_cases({mode: (lambda s=s: generate_batch_rank(rank, world, s))
                      for mode, s in specs.items()})


def from_pretrained_rank(rank, world, spec):
    """FillPipeline.from_pretrained(mesh=) on a tiny checkpoint: the DiT
    loaded as each rank's shard, with and without a LoRA, and deferred."""
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.pipeline import fill as TF
    from textflux_torch.pipeline.fill import FillPipeline

    mesh = PT.make_mesh(spec["shape"], device="cpu")

    def run(lora, deferred=False):
        pipe = FillPipeline.from_pretrained(
            spec["checkpoint"], lora_path=lora, lora_scale=spec["lora_scale"],
            dtype=torch.float32, pipe_cfg=spec["pipe_cfg"], defer_transformer=deferred,
            mesh=mesh)
        kw = dict(spec["call"])
        if deferred:
            kw["text_embeds"] = pipe.encode_prompts(*TF.build_prompts(kw.pop("words")),
                                                    dtype=torch.float32)
            pipe.release_text_encoders()
            pipe.load_transformer()
        out = pipe(**kw, dtype=torch.float32, output_type="np")
        return dict(image=out, dit_bytes=pipe.load_stats["transformer"]["device_bytes"],
                    tp_rank=pipe.flux.tp_rank)

    return run_cases({"base": lambda: run(None), "lora": lambda: run(spec["lora"]),
                      "deferred": lambda: run(None, deferred=True)})


def run_eval_rank(rank, world, runs):
    """cli.run_eval.main with --mesh, each rank writing into its own output
    directory (only rank 0's may fill)."""
    from textflux_torch.cli import run_eval

    def run(name, argv):
        with float32_pipelines():
            run_eval.main(argv + ["--output-dir",
                                  os.path.join(runs["root"], name, f"rank{rank}")])
        return True

    return run_cases({name: (lambda n=name, a=argv: run(n, a))
                      for name, argv in runs["argv"].items()})


def demo_rank(rank, world, spec):
    """The demo's callbacks on a mesh: rank 0 leads (each click broadcast),
    the others follow."""
    from textflux_torch.cli import demo as TD
    from textflux_torch.parallel import partitioning as PT

    mesh = PT.make_mesh(spec["shape"], device="cpu")
    pipe = build_pipeline(spec)
    pipe.shard_for_serving(mesh)
    callbacks = TD.ui_callbacks(Float32(pipe), beta=True)
    if rank != 0:
        return {"followed": TD.follow(callbacks)}
    led = TD.lead(callbacks)
    try:
        custom = led["custom"](*spec["custom_args"])
        normal = led["normal"](*spec["normal_args"])
    finally:
        TD.stop_followers()
    return {"custom": np.asarray(custom), "normal": np.asarray(normal)}


def tp_grad_rank(rank, world, spec):
    """flux_apply's forward and backward at (1, 1, world) against tp = 1 on
    the same weights, per attention path and remat: the output's and each
    parameter's gradient's error (gathered whole, un-permuted, a replicated
    one's rank parts summed), relative to its largest |value|."""
    import copy

    from textflux_torch.io.from_jax import load_jax_params
    from textflux_torch.models import transformer as TT
    from textflux_torch.ops.rope import rope_tables
    from textflux_torch.parallel import partitioning as PT

    cfg, x = spec["cfg"], spec["inputs"]
    mesh = PT.make_mesh((1, 1, world), device="cpu")
    base = load_jax_params(spec["tree"], cfg, device="cpu")
    args = [torch.as_tensor(x[k]) for k in ("img", "txt", "pooled", "timestep", "guidance")]
    cos, sin = (torch.as_tensor(t) for t in rope_tables(x["ids"], cfg.axes_dims_rope))

    def run(impl, remat):
        ref = copy.deepcopy(base)
        y = TT.flux_apply(ref, *args, cos, sin, attn_impl="plain", remat=remat)
        y.square().mean().backward()
        model = tensor_shard(copy.deepcopy(base), mesh)
        PT.shard_for_training(model, mesh)
        with torch.no_grad():
            served = TT.flux_apply(model, *args, cos, sin, attn_impl=impl, mesh=mesh)
        PT.reset_counts()
        out = TT.flux_apply(model, *args, cos, sin, attn_impl=impl, remat=remat, mesh=mesh)
        out.square().mean().backward()
        counts = PT.counts()
        want = dict(ref.named_parameters())
        errs = {}
        for name, p in model.named_parameters():
            g = p.grad
            if PT.partial_over_tensor(model, name):
                g = g.clone()
                dist.all_reduce(g, group=mesh.tensor_group)
            split = PT.tensor_split(model, name)
            if split is not None:
                g = PT.gather_split(g, *split, mesh.tensor_group)
            w = want[name].grad
            errs[name] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        return dict(out_err=float((out.detach() - y.detach()).abs().max()), grad_err=errs,
                    no_grad_bitwise=bool(torch.equal(served, out.detach())), counts=counts)

    return run_cases({f"{impl}_{remat}": (lambda i=impl, r=remat: run(i, r))
                      for impl in ("plain", "flash") for remat in (False, True)})


def four_rank_cases(rank, world, spec):
    return run_cases({"flux": lambda: flux_apply_rank(rank, world, spec["flux"]),
                      "batch": lambda: generate_batch_rank(rank, world, spec["batch"])})


def two_rank_cases(rank, world, spec):
    return run_cases({
        "flux": lambda: flux_apply_rank(rank, world, spec["flux"]),
        "quant": lambda: quantized_rank(rank, world, spec["quant"]),
        "pretrained": lambda: from_pretrained_rank(rank, world, spec["pretrained"]),
        "pretrained_fsdp": lambda: from_pretrained_rank(rank, world, spec["pretrained_fsdp"]),
        "tp_grad": lambda: tp_grad_rank(rank, world, spec["tp_grad"]),
        "run_eval": lambda: run_eval_rank(rank, world, spec["run_eval"]),
        "demo": lambda: demo_rank(rank, world, spec["demo"]),
    })


# ---------------------------------------------------------------------------
# training over the fsdp axis
# ---------------------------------------------------------------------------

def sharded_grad(p, whole: torch.Tensor):
    """A gradient for a parameter shard_for_training sharded: this rank's
    slice of `whole`, as the DTensor FSDP would leave in ``.grad``."""
    from torch.distributed.tensor import DTensor

    from textflux_torch.parallel import partitioning as PT

    return DTensor.from_local(PT.shard_spec(p).cut(whole).clone(), p.device_mesh,
                              p.placements, run_check=False, shape=p.shape, stride=p.stride())


def tensor_shard(model, mesh, quantize=None):
    """`model` (whole) cut to this rank's tensor shard of `mesh`, in place,
    as the trainer's sharded load gives it, quantised in `quantize` mode
    (every linear) as ``shard_module`` quantises a shard."""
    from textflux_torch.io.quantize import quantize_tree
    from textflux_torch.models.transformer import tp_permute_flux_params
    from textflux_torch.parallel import partitioning as PT

    if mesh.tensor > 1:
        tp_permute_flux_params(model, mesh.tensor)
        PT.shard_module(model, PT.flux_param_specs(model.cfg), mesh, quantize=quantize,
                        min_size=0)
    elif quantize:
        quantize_tree(model, mode=quantize, min_size=0)
    return model


def _train_model(case, mesh):
    """The port's DiT, VAE, optimizer and step of a step case, sharded
    over `mesh` (tensor, then fsdp): full-parameter modes with float32
    masters beside frozen bf16 weights, LoRA over a float32 base (or one
    quantised as ``case["quantize"]`` says)."""
    from textflux_torch.io.from_jax import load_jax_lora, load_jax_params
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import train as TR

    tc = TR.TrainConfig(**case["tc"])
    cfg = case["flux_cfg"]
    if tc.mode == "lora":
        model = load_jax_params(case["flux"], cfg, device="cpu")
        lora = load_jax_lora(case["lora"], model)
        tensor_shard(model, mesh, case.get("quantize"))
        TR.lora_insert(model, lora, tc.lora_alpha / tc.lora_rank)
        PT.shard_for_training(model, mesh, compute_dtype=torch.float32)
        lora = TR.attached_lora(model, lora)
        named, masks = TR.lora_named_parameters(lora), None
    else:
        from textflux_torch.models.transformer import FluxTransformer

        masks = TR.trainable_mask(FluxTransformer(cfg, device="meta"), tc)
        model = load_jax_params(case["flux"], cfg, device="cpu",
                                dtype=TR.mask_dtypes(masks, lambda name: torch.bfloat16))
        tensor_shard(model, mesh)
        masks = TR.trainable_mask(model, tc)
        TR.freeze_to_mask(model, masks)
        PT.shard_for_training(model, mesh, compute_dtype=torch.float32)
        named = {n: p for n, p in model.named_parameters() if n in masks}
    vae = load_jax_params(case["vae"], case["vae_cfg"], device="cpu")
    opt = TR.make_optimizer(tc, named, masks, model=model, mesh=mesh)
    return model, vae, opt, TR.make_train_step(tc, attn_impl="plain", mesh=mesh), named


def fsdp_step_case(rank, world, case):
    """Steps of make_train_step over a mesh, each rank on its rows of each
    whole batch (each microbatch's) with its rows of the whole batch's
    noise; returns the
    losses, norms and (rank 0) every trained tensor gathered whole."""
    from textflux_torch.cli.train import batch_part
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import train as TR

    if "estim_lr0" in case:
        TR.ClippedProdigy.estim_lr0 = case["estim_lr0"]
    mesh = PT.make_mesh(case["shape"], device="cpu")
    model, vae, opt, step, named = _train_model(case, mesh)
    losses, norms = [], []
    for batch, noise in zip(case["batches"], case["noise"]):
        b = batch["pixel_values"].shape[1]
        part = batch_part(mesh, b)
        local = {k: torch.tensor(v[:, part]) for k, v in batch.items()}
        local_noise = [{k: torch.tensor(v[part]) for k, v in mb.items()} for mb in noise]
        got = step(model, vae, opt, local, noise=local_noise, batch_rows=(part.start, b))
        losses.append(float(got["loss"]))
        norms.append(float(got["grad_norm"]))
    whole = {n: PT.whole_tensor(model, n, p).float().numpy()
             for n, p in model.named_parameters()}
    local_leaves = sum(getattr(opt, "local", []))
    return dict(losses=losses, norms=norms, params=whole if rank == 0 else None,
                local_leaves=local_leaves, leaves=len(getattr(opt, "leaves", [])),
                trained=sorted(named), counts=PT.counts())


def fsdp_optimizer_case(rank, world, case):
    """An optimizer over a sharded DiT given the same whole gradients on
    every rank, step after step: the norms, Prodigy's D and the state in
    its whole layout."""
    from textflux_torch.io.from_jax import load_jax_params
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import train as TR

    if "estim_lr0" in case:
        TR.ClippedProdigy.estim_lr0 = case["estim_lr0"]
    mesh = PT.make_mesh(case["shape"], device="cpu")
    tc = TR.TrainConfig(**case["tc"])
    model = tensor_shard(load_jax_params(case["flux"], case["flux_cfg"], device="cpu"), mesh)
    masks = TR.trainable_mask(model, tc)
    TR.freeze_to_mask(model, masks)
    PT.shard_for_training(model, mesh, compute_dtype=torch.float32)
    named = {n: p for n, p in model.named_parameters() if n in masks}
    opt = TR.make_optimizer(tc, named, masks, model=model, mesh=mesh)
    norms = []
    for grads in case["grads"]:
        opt.zero_grad()
        for name, p in named.items():
            whole = torch.tensor(grads[name])
            if mesh.tensor > 1 and PT.partial_over_tensor(model, name):
                whole = whole / mesh.tensor    # each rank's part; their sum is the whole
            split = PT.tensor_split(model, name)
            if split is not None:   # the rank's tensor share
                whole = whole.index_select(split[0], split[1].index())
            p.grad = sharded_grad(p, whole) if PT.shard_spec(p) is not None else whole.clone()
        norms.append(float(opt.step()))
    state = opt.state_dict()

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [host(v) for v in x]
        return x

    return dict(norms=norms, state=host(state) if rank == 0 else None,
                local=list(getattr(opt, "local", [])),
                leaf_names=[TR.jax_leaf(opt.names[idx[0]])[0]
                            for idx, _, _ in getattr(opt, "leaves", [])],
                params={n: PT.whole_tensor(model, n, p).numpy() for n, p in named.items()})


_RESTORED = {}


def _capture_restore():
    """Wrap cli.train's two state loaders (once per process) to record in
    ``_RESTORED``, right after a resume, the live state in the checkpoint's
    layout (gathered: every rank)."""
    from textflux_torch.cli import train as CLI

    if _RESTORED.get("installed"):
        return
    _RESTORED["installed"] = True
    for load, dump in (("load_full_train_state", CLI.full_train_state),
                       ("load_train_state", CLI.train_state)):
        orig = getattr(CLI, load)

        def wrapped(live, opt, state, orig=orig, dump=dump):
            step = orig(live, opt, state)
            _RESTORED["state"] = torch_tree_to_numpy(dump(live, opt, step))
            return step

        setattr(CLI, load, wrapped)


def fsdp_main_case(rank, world, runs):
    """cli.train.main over the default mesh (1, world, 1) or its --mesh, one
    run after another (every rank writes into the same output directories;
    rank 0 alone writes files). A run may start from a copy of another's
    checkpoints, resume (the restored state, gathered, is returned) or be
    preempted by a SIGTERM that only rank 0 receives."""
    import signal as sig
    import threading

    from textflux_torch.cli import train as CLI

    import shutil

    out = {}
    for name, run in runs:
        if run.get("copy"):   # rank 0 copies a run's checkpoints for this one to resume
            if rank == 0:
                shutil.copytree(*run["copy"])
            dist.barrier()
        _RESTORED.pop("state", None)
        if run.get("capture"):
            _capture_restore()
        if run.get("sigterm") and rank == 0:
            log = os.path.join(run["argv"][run["argv"].index("--output-dir") + 1],
                               "train_log.jsonl")

            def preempt(log=log):
                deadline = time.time() + 120
                while time.time() < deadline:
                    if os.path.exists(log) and open(log).read().strip():
                        os.kill(os.getpid(), sig.SIGTERM)
                        return
                    time.sleep(0.05)

            threading.Thread(target=preempt, daemon=True).start()
        try:
            CLI.main(run["argv"])
            result = {"ok": True}
            if "state" in _RESTORED and rank == 0:
                result["restored"] = _RESTORED["state"]
        except BaseException:
            result = {"error": traceback.format_exc()}
        out[name] = result
    return out


def torch_tree_to_numpy(x):
    """A nested state's tensors as numpy copies (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return np.array((x.float() if x.dtype == torch.bfloat16 else x).numpy())
    if isinstance(x, dict):
        return {k: torch_tree_to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [torch_tree_to_numpy(v) for v in x]
    return x


def fsdp_load_case(rank, world, spec):
    """io.params.load_flux_fsdp of a checkpoint at mesh (1, world, 1), each
    rank reading its slices from the files, with --mode attn's dtypes;
    returns every parameter gathered whole (rank 0)."""
    from textflux_torch.io.params import load_flux_fsdp
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import train as TR

    mesh = PT.make_mesh((1, world, 1), device="cpu")
    masks = TR.trainable_mask(FluxTransformer(spec["cfg"], device="meta"),
                              TR.TrainConfig(mode="attn"))
    model = load_flux_fsdp(spec["path"], spec["cfg"], mesh, device="cpu",
                           dtype=TR.mask_dtypes(masks, lambda name: torch.bfloat16))
    whole = {n: torch_tree_to_numpy(PT.full_tensor(p)) for n, p in model.named_parameters()}
    dtypes = {n: str(p.dtype) for n, p in model.named_parameters()}
    return dict(params=whole if rank == 0 else None, dtypes=dtypes)


def fsdp_cases(rank, world, spec):
    """Every FSDP case of tests/test_torch_fsdp.py in one spawn."""
    cases = {f"step:{k}": (lambda c=c: fsdp_step_case(rank, world, c))
             for k, c in spec["steps"].items()}
    cases.update({f"opt:{k}": (lambda c=c: fsdp_optimizer_case(rank, world, c))
                  for k, c in spec["optimizers"].items()})
    cases["load"] = lambda: fsdp_load_case(rank, world, spec["load"])
    cases["main"] = lambda: fsdp_main_case(rank, world, spec["main"])
    return run_cases(cases)


def gloo_cuda_collectives(rank, world, n):
    """all_gather_into_tensor (bf16) and reduce_scatter_tensor (float32,
    FSDP's reduce dtype) over the gloo group on CUDA tensors of cuda:0:
    what FSDP2 calls for ranks sharing one card."""
    torch.cuda.set_device(0)
    small = torch.full((n,), float(rank + 1), device="cuda", dtype=torch.bfloat16)
    big = torch.empty(n * world, device="cuda", dtype=torch.bfloat16)
    dist.all_gather_into_tensor(big, small)
    out = torch.empty(n, device="cuda", dtype=torch.float32)
    dist.reduce_scatter_tensor(out, torch.full((n * world,), float(rank + 1), device="cuda"))
    return dict(gathered=big.float().cpu().numpy(), reduced=out.cpu().numpy())


# ---------------------------------------------------------------------------
# the three (2, 2, 2) surfaces of the JAX package's multi-chip dry run
# ---------------------------------------------------------------------------

def dryrun_clip_tokenize(prompt: str) -> np.ndarray:
    """__graft_entry__.py's _dryrun_serving CLIP tokenizer (vocab 64)."""
    ids = (np.frombuffer(prompt.encode()[:23].ljust(23), np.uint8) % 63).astype(np.int32)
    return np.concatenate([ids, [63]])[None]


def dryrun_t5_tokenize(prompt: str) -> np.ndarray:
    ids = (np.frombuffer(prompt.encode()[:16].ljust(16), np.uint8) % 64).astype(np.int32)
    return ids[None]


def multichip_serving_case(rank, world, spec):
    """generate_batch of an int8 DiT served at mesh (2, 2, 2): the DiT
    tensor-sharded and storage-sharded over fsdp, a sample a (data, fsdp)
    rank; float images."""
    from textflux_torch.io.from_jax import load_jax_params
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.pipeline.fill import FillPipeline

    mesh = PT.make_mesh(spec["shape"], device="cpu")
    mods = {k: load_jax_params(tree, cfg, device="cpu")
            for k, (tree, cfg) in spec["modules"].items()}
    pipe = FillPipeline(**mods, clip_tokenize=dryrun_clip_tokenize,
                        t5_tokenize=dryrun_t5_tokenize, pipe_cfg=spec["pipe_cfg"],
                        attn_impl="plain", device="cpu")
    pipe.shard_for_serving(mesh, quantize="weight_only", quantize_min_size=0)
    PT.reset_counts()
    with float_images():
        out = pipe.generate_batch(**spec["call"], dtype=torch.float32)
    return dict(images=np.asarray(out), counts=PT.counts(), coords=mesh.coords,
                storage_bytes=PT.storage_bytes(pipe.flux))


def multichip_cases(rank, world, spec):
    """The JAX package's three dry-run surfaces at (2, 2, 2), one spawn of 8
    ranks: --mode attn with AdamW and grad_accum 2, LoRA over an int8
    base, and int8 serving at batch 4."""
    return run_cases({
        "train": lambda: fsdp_step_case(rank, world, spec["train"]),
        "lora": lambda: fsdp_step_case(rank, world, spec["lora"]),
        "serving": lambda: multichip_serving_case(rank, world, spec["serving"]),
    })
