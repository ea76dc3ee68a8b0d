"""serve_wan_closed_loop: one client editing clips one at a time with
Wan2.1-VACE through ``textflux_torch.cli.run_inference.run``, CFG against
the negative prompt, on a pipeline built from seeded weights.

Set-up: the configuration is written as a diffusers-layout set of
config.json files and read by the program's own readers; the DiT (40 main
and 8 VACE blocks), UMT5-XXL and the Wan VAE are built on the meta device
and take the seed's bf16 weights (``weights``, the DiT grouped by block
with ``reference.wan_vace.groups``); the tokenizer is a byte stand-in (the
bytes + 3, then EOS); the pool of clip requests is written (``clips``);
each frame size of the mix runs once at a few steps, so every graph key the
window uses is captured before it. The window then sends the pool's
requests back to back and closes at the end of the first whole cycle of
sizes after ``--seconds``. With ``--trace 1`` the program's stages run
under CUDA-event spans and one request of the first cycle runs under the
profiler.

Wrappers on the pipeline's stages and a forward hook on the DiT keep, for
every request, what the comparison judges (``reference.wan_check``): the
embeddings, the control, the initial latents, the two velocities and the
guided one at two steps drawn from the seed, the state around the first of
them and the DiT's arguments there, and the final latents. After the
window: one eager forward on the first sampled request's arguments, with
CUDA events around it and around its VACE branch (``vace_share.wan``);
then, for one finished request per size drawn from the seed, the DiT runs
again eagerly on the arguments it got at the first judged step, keeping on
the host its streams and parts in four blocks drawn from the seed (a main
block that takes a hint and one that does not, the first branch block and
the one whose hint the first joins); then the program is freed and the
reference judges those requests.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.utils._pytree import tree_map

from h100_bench import clips, flops_wan, harness, weights
from h100_bench.reference import canvas, wan_check
from h100_bench.reference import umt5 as U, vae_wan as W, wan_vace as R
from textflux_torch.cli.run_inference import run as edit
from textflux_torch.config import WanPipelineConfig
from textflux_torch.pipeline.wan_vace import WanVACEPipeline

TRACE_REQUEST = 1   # the first cycle's second size
SPANS = (("encode_prompts", "text_encode"), ("_prepare_video", "vae_encode"),
         ("_decode", "vae_decode"), ("_denoise_step", "denoise_step"))
# the configuration's models: (key, checkpoint folder, reference skeleton, grouping)
PARTS = (("wan_dit", "transformer", R.WanDiT, R.groups),
         ("umt5", "text_encoder", U.UMT5, weights.groups),
         ("wan_vae", "vae", W.WanVAE, weights.groups))


def byte_tokenize(text: str) -> np.ndarray:
    """The stand-in tokenizer: the text's UTF-8 bytes + 3, then EOS (1)."""
    return canvas.t5_ids(text, len(text.encode("utf-8")) + 1)


def build_pipeline(cfg: dict, seed: int, device):
    """The program's WanVACEPipeline on `device` with the seed's weights."""
    from textflux_torch.io import config_io
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.vae_wan import WanVAE
    from textflux_torch.models.wan import WanVACETransformer

    programs = {"wan_dit": (WanVACETransformer, config_io.wan_vace_config_from),
                "umt5": (T5Encoder, config_io.t5_config_from),
                "wan_vae": (WanVAE, config_io.wan_vae_config_from)}
    folder = tempfile.mkdtemp(prefix="h100_bench_cfg_")
    models = {}
    try:
        for kind, sub, skeleton, grouping in PARTS:
            os.makedirs(os.path.join(folder, sub))
            with open(os.path.join(folder, sub, "config.json"), "w") as f:
                json.dump(cfg[kind], f)
            cls, read = programs[kind]
            module = cls(read(os.path.join(folder, sub)), device="meta", dtype=torch.bfloat16)
            module.load_state_dict(weights.state_dict(seed, kind, grouping(skeleton(cfg[kind])),
                                                      device), assign=True, strict=True)
            models[kind] = module.requires_grad_(False)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    pipe_cfg = WanPipelineConfig(guidance_scale=cfg["guidance_scale"],
                                 flow_shift=cfg["scheduler"]["flow_shift"])
    return WanVACEPipeline(dit=models["wan_dit"], text_encoder=models["umt5"],
                           vae=models["wan_vae"], tokenize=byte_tokenize, pipe_cfg=pipe_cfg,
                           device=device)


class Recorder:
    """Keeps, for the request under way, what ``wan_check`` judges (module
    docstring)."""

    def __init__(self, pipe, seed: int, steps: int):
        self.seed, self.steps = seed, steps
        self.records, self.active = {}, None
        pipe.dit.register_forward_hook(self._dit, with_kwargs=True)
        for attr in ("encode_prompts", "_prepare_video", "_denoise_step", "_guidance",
                     "_decode"):
            self._wrap(pipe, attr)

    def _wrap(self, pipe, attr):
        inner, seen = getattr(pipe, attr), getattr(self, "_" + attr.strip("_"))

        def wrapped(*a, **kw):
            out = inner(*a, **kw)
            if self.active is not None:
                seen(out, *a, **kw)
            return out

        setattr(pipe, attr, wrapped)

    def begin(self, index: int) -> None:
        k = int(np.random.default_rng([self.seed % 2 ** 63, index, 1]).integers(0, self.steps - 1))
        self.active = dict(step=0, k=k, x={}, v_pos={}, v_neg={}, v={}, calls=0, call={})

    def end(self, index: int, extra: dict) -> None:
        if self.active is not None:
            self.records[index] = dict(self.active, **extra)
        self.active = None

    def _judged(self) -> bool:
        a = self.active
        return a["step"] in (a["k"], a["k"] + 1)

    def _encode_prompts(self, out, *a, **kw):
        self.active["txt_pos"], self.active["txt_neg"] = (t.clone() for t in out)

    def _prepare_video(self, out, *a, **kw):
        self.active["control"] = out.clone()

    def _denoise_step(self, out, lat, texts, mods, sigma, sigma_next, *, step, **kw):
        a = self.active
        if step == 0:
            a["lat0"] = lat.clone()
        if step in (a["k"], a["k"] + 1):
            a["x"][step] = lat.clone()
        a["step"] = step + 1
        a["calls"] = 0

    def _guidance(self, out, *a, **kw):
        if self._judged():
            self.active["v"][self.active["step"]] = out.clone()

    def _decode(self, out, latents, *a, **kw):
        self.active["final"] = latents.clone()

    def _dit(self, module, args, kwargs, output):
        a = self.active
        if a is None:
            return
        kind = "pos" if a["calls"] == 0 else "neg"
        if self._judged():
            a["v_" + kind][a["step"]] = output.clone()
        if a["step"] == a["k"]:
            a["call"][kind] = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                       (args, kwargs))
        a["calls"] += 1


def judged_blocks(cfg: dict, rng) -> tuple:
    """(main blocks, branch blocks) to judge: a main block that takes a hint
    and one that does not; the first branch block and the one whose hint
    the first joins."""
    layers = list(cfg["vace_layers"])
    hinted = int(rng.choice(layers))
    plain = int(rng.choice([i for i in range(cfg["num_layers"]) if i not in layers]))
    return sorted({hinted, plain}), sorted({0, layers.index(hinted)})


def rerun(dit, call, blocks, vace) -> dict:
    """The DiT's forward run again eagerly on a recorded call's (args,
    kwargs), with ``taps`` on the main `blocks` and the branch's `vace`
    blocks, everything kept moved to the host: the velocity v, the inputs
    (latents, control, text), first, last, blocks and vace."""
    taps = {"blocks": {i: {} for i in blocks}, "vace": {j: {} for j in vace}}
    args, kwargs = call
    with torch.inference_mode():
        v = dit._forward(*args, **kwargs, taps=taps)
    host = tree_map(lambda t: t.to("cpu") if isinstance(t, torch.Tensor) else t, taps)
    return dict(host, v=v, latents=args[0].to("cpu"), control=args[1].to("cpu"),
                text=args[2].to("cpu"))


def vace_timing(dit, call) -> dict:
    """An eager forward on a recorded call with CUDA events around it and
    around its VACE branch: {"vace_ms", "forward_ms"}."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    inner = dit._vace

    def timed(*a, **kw):
        ev[1].record()
        out = inner(*a, **kw)
        ev[2].record()
        return out

    dit._vace = timed
    try:
        with torch.inference_mode():
            ev[0].record()
            dit._forward(*call[0], **call[1])
            ev[3].record()
        torch.cuda.synchronize()
    finally:
        del dit._vace
    return {"vace_ms": ev[1].elapsed_time(ev[2]), "forward_ms": ev[0].elapsed_time(ev[3])}


def canvas_hw(size) -> tuple:
    """The canvas of a frame: the strip above it, both snapped to multiples
    of 32."""
    w, h = size
    return ((h + int(w * canvas.STRIP_RATIO)) // 32) * 32, (w // 32) * 32


def run(cell: dict, args, ctx: dict) -> dict:
    cfg, mix = cell["cfg"], cell["mix"]
    if (mix["loop"], mix["clients"], mix["batch"], cfg["dtype"]) != ("closed", 1, 1, "bfloat16"):
        raise ValueError("serve_wan_closed_loop sends one bf16 request at a time from one client")
    dev = torch.device(ctx["device"])
    cycle, steps, frames = len(mix["sizes"]), mix["steps"], mix["frames"]
    work = tempfile.mkdtemp(prefix="h100_bench_requests_")
    try:
        t_build = time.time()
        pipe = build_pipeline(cfg, args.seed, dev)
        ctx["sync"]()
        phases = {"start_s": t_build - ctx["t_start"], "build_s": time.time() - t_build}
        pool = clips.make_clip_pool(mix, args.seed, work)
        recorder = Recorder(pipe, args.seed, steps)

        def send(req, n_steps):
            return edit(pipe, req.scene, req.mask, req.words_file, steps=n_steps,
                        guidance_scale=mix["cfg_scale"], seed=req.noise_seed,
                        sampler=mix["sampler"], device=dev.type)

        t_warm = time.time()
        for req in pool[:cycle]:           # every canvas the window sends
            send(req, mix["warmup_steps"])
        ctx["sync"]()
        phases["warmup_s"] = time.time() - t_warm
        spans = harness.Spans(torch) if args.trace and dev.type == "cuda" else None
        if spans:
            for attr, name in SPANS:
                spans.wrap(pipe, attr, name)
        ctx["sync"]()
        setup_s = time.time() - ctx["t_start"]
        ctx["reset_peak"]()
        graphs = pipe.dit.graphs
        counted = (graphs.replays, graphs.calls, dict(pipe.tokens))

        latencies, images, failed, trace, traced, out = [], {}, 0, {}, None, None
        t0 = time.perf_counter()
        i = 0
        while True:
            req = pool[i % len(pool)]
            recorder.begin(i)
            profiled = bool(args.trace) and i == TRACE_REQUEST and dev.type == "cuda"
            ts = time.perf_counter()
            try:
                if profiled:
                    from torch.profiler import ProfilerActivity, profile
                    ctx["sync"]()
                    ts = time.perf_counter()
                    spans.paused = True
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        out = send(req, steps)
                        ctx["sync"]()
                    wall = time.perf_counter() - ts
                    spans.paused = False
                else:
                    out = send(req, steps)
                latencies.append(time.perf_counter() - ts)
                images[i] = np.stack([np.asarray(f) for f in out[0]])
                recorder.end(i, dict(request=req))
                if profiled:
                    traced = (i, wall, prof)
            except Exception:  # counted against the attempts; the run goes on
                failed += 1
                recorder.active = None
                print(f"request {i} failed:\n{traceback.format_exc()}", file=sys.stderr)
            i += 1
            if i % cycle == 0 and time.perf_counter() - t0 >= args.seconds:
                break
        window_s = time.perf_counter() - t0
        ctx["sync"]()
        peak = ctx["peak"]()
        if dev.type == "cuda":   # the allocator's pool, the graphs' included
            phases["reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
        ctx["closed"]()
        replays, calls = graphs.replays - counted[0], graphs.calls - counted[1]
        tokens = {k: pipe.tokens[k] - counted[2][k] for k in counted[2]}

        def shape(j):
            h, w = canvas_hw(pool[j % len(pool)].size)
            return dict(height=h, width=w, frames=frames, steps=steps)

        if traced:
            trace = harness.reduce_trace(traced[2], traced[1], spans={n for _, n in SPANS})
            s = shape(traced[0])
            trace["clips"] = [dict(seq=flops_wan.video_tokens(cfg, frames, s["height"],
                                                              s["width"]), steps=steps)]
        span_ms = spans.ms() if spans else {}
        done = [j for j in range(i) if j in images]
        work_flops = [flops_wan.edit_clip(cfg, **shape(j)) for j in done]
        untraced = [n for n, j in enumerate(done) if traced is None or j != traced[0]]
        data = dict(spans=span_ms, trace=trace, images=len(done), cfg=cfg,
                    flops=sum(work_flops[n] for n in untraced),
                    busy_wall_s=sum(latencies[n] for n in untraced),
                    graphs=dict(replays=replays, calls=calls), tokens=tokens)

        # the sample: one finished request of each size, drawn from the seed
        rng = np.random.default_rng([args.seed % 2 ** 63, 2])
        sample = []
        for pos in range(cycle):
            finished = [j for j in done if j % cycle == pos]
            if finished:
                sample.append(finished[int(rng.integers(0, len(finished)))])
        if sample and dev.type == "cuda":
            first = recorder.records[sample[0]]["call"]
            data["vace"] = vace_timing(pipe.dit, first.get("pos") or next(iter(first.values())))
        recs = []
        for j in sample:
            r = recorder.records[j]
            req, dit_calls = r.pop("request"), r.pop("call")
            stages, gap = {}, 0.0
            for n, (kind, call) in enumerate(sorted(dit_calls.items())):
                blocks, vace = judged_blocks(cfg["wan_dit"], np.random.default_rng(
                    [args.seed % 2 ** 63, j, n, 3]))
                stages[kind] = rerun(pipe.dit, call, blocks, vace)
                gap = max(gap, float((stages[kind].pop("v").float()
                                      - r["v_" + kind][r["k"]].float()).abs().max()))
            recs.append(dict(r, words=req.words, scene=req.scene, mask_file=req.mask,
                             noise_seed=req.noise_seed, steps=steps, cfg_scale=mix["cfg_scale"],
                             image=images[j], stages=stages, rerun_max_abs=gap))
        recorder.records.clear()
        del pipe, recorder, spans, traced, send, out, graphs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            phases["held_after_window_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        t_ref = time.perf_counter()
        layers = cfg["wan_dit"]["vace_layers"]
        ref = wan_check.reference_outputs(cfg, args.seed, recs, dev, cfg["reference_rounding"])
        numbers = wan_check.judge(recs, ref, vace_layers=layers)
        if ctx.get("control"):
            ctl = wan_check.reference_outputs(cfg, args.seed, recs, dev, cfg["control_rounding"])
            numbers = {"program": numbers,
                       "control": wan_check.judge(recs, ref, ctl, vace_layers=layers)}
        numbers_s = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lat_sorted = sorted(latencies)
    return dict(
        end_to_end={"img_per_s": len(done) / window_s,
                    "img_latency_p90_s": harness.quantile(lat_sorted, 0.9),
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        data=data, numbers=numbers, attempted=i, failed=failed, memory_peak_bytes=peak,
        info=dict(phases, window_s=window_s, images=len(done), sample=sample, reference_s=numbers_s,
                  latency_median_s=harness.quantile(lat_sorted, 0.5),
                  graphs=dict(replays=replays, calls=calls), tokens=tokens,
                  vace=data.get("vace")))
