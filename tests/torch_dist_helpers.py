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
    return dict(images=np.asarray(out), counts=PT.counts(), tp_rank=pipe.flux.tp_rank,
                batch_rank=mesh.batch_rank)


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


def four_rank_cases(rank, world, spec):
    return run_cases({"flux": lambda: flux_apply_rank(rank, world, spec["flux"]),
                      "batch": lambda: generate_batch_rank(rank, world, spec["batch"])})


def two_rank_cases(rank, world, spec):
    return run_cases({
        "flux": lambda: flux_apply_rank(rank, world, spec["flux"]),
        "quant": lambda: quantized_rank(rank, world, spec["quant"]),
        "pretrained": lambda: from_pretrained_rank(rank, world, spec["pretrained"]),
        "run_eval": lambda: run_eval_rank(rank, world, spec["run_eval"]),
        "demo": lambda: demo_rank(rank, world, spec["demo"]),
    })
