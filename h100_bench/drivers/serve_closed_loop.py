"""serve_closed_loop: one client editing images one at a time through
``textflux_torch.cli.run_inference.run``, as the published inference script
does, on a pipeline built from seeded weights.

Set-up: the configuration is written as a diffusers-layout set of
config.json files and read by the program's own readers; the models are
built on the meta device and take the seed's bf16 weights (``weights``);
a quantised configuration goes through ``io.quantize.quantize_tree`` as
``--quantize-mode`` does; the pool of requests is written; each of the
mix's canvas shapes runs once at a few steps. The window then sends the
pool's requests back to back, each when the last one's image and crop are
back, and closes at the end of the first whole cycle of shapes after
``--seconds``. With ``--trace 1`` the program's stages run under CUDA-event
spans and one request of the second cycle runs under the profiler.

A forward hook on the DiT and a wrapper on the decode keep, for every
request, what the comparison judges: the first step's inputs, two steps
drawn from the seed, and the final latents. After the window the program is
freed and ``reference.serve_check`` judges a sample of one finished request
per shape, drawn from the seed.
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

from h100_bench import flops, harness, requests, weights
from h100_bench.reference import canvas, models as M, serve_check

TRACE_REQUEST = 2   # the first cycle's 4:3 canvas (joint 1,408), after the warm-up
# the program's stages under CUDA-event spans in a traced run: (method, span)
SPANS = (("encode_prompts", "text_encode"), ("_prepare_cond", "vae_encode"),
         ("_decode", "vae_decode"), ("_denoise_step", "denoise_step"))


def write_checkpoint_configs(cfg: dict, folder: str) -> str:
    """The configuration as a checkpoint's config.json files."""
    for sub, key in (("transformer", "flux"), ("vae", "vae"), ("text_encoder", "clip"),
                     ("text_encoder_2", "t5")):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
        with open(os.path.join(folder, sub, "config.json"), "w") as f:
            json.dump(cfg[key], f)
    return folder


def build_pipeline(cfg: dict, seed: int, device):
    """The program's FillPipeline on `device` with the seed's weights."""
    from textflux_torch.config import PipelineConfig
    from textflux_torch.io import config_io
    from textflux_torch.io.quantize import quantize_tree
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.pipeline.fill import FillPipeline

    folder = write_checkpoint_configs(cfg, tempfile.mkdtemp(prefix="h100_bench_cfg_"))
    try:
        specs = {"flux": (FluxTransformer, config_io.flux_config_from, "transformer"),
                 "vae": (FluxVAE, config_io.vae_config_from, "vae"),
                 "clip": (CLIPTextModel, config_io.clip_config_from, "text_encoder"),
                 "t5": (T5Encoder, config_io.t5_config_from, "text_encoder_2")}
        models = {}
        for kind, (cls, read, sub) in specs.items():
            module = cls(read(os.path.join(folder, sub)), device="meta", dtype=torch.bfloat16)
            spec = weights.groups(M.MODELS[kind](cfg[kind]))
            module.load_state_dict(weights.state_dict(seed, kind, spec, device), assign=True,
                                   strict=True)
            module.requires_grad_(False)
            mode = (cfg.get("quantize") or {}).get(kind)
            if mode:
                quantize_tree(module, mode=mode)
            models[kind] = module
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    n = cfg["max_sequence_length"]
    return FillPipeline(**models, clip_tokenize=canvas.clip_ids,
                        t5_tokenize=lambda p: canvas.t5_ids(p, n),
                        pipe_cfg=PipelineConfig(max_sequence_length=n), device=device)


class Recorder:
    """Keeps, for the request under way, the DiT's inputs at its first step
    (latents, conditioning, embeddings), its latents and velocity at two
    steps drawn from the seed, and the final latents."""

    def __init__(self, pipe, seed: int, steps: int):
        self.seed, self.steps = seed, steps
        self.records, self.active = {}, None
        pipe.flux.register_forward_hook(self._hook, with_kwargs=True)
        decode = pipe._decode

        def recorded_decode(latents, lat_h, lat_w):
            if self.active is not None:
                self.active["final"] = latents.clone()
            return decode(latents, lat_h, lat_w)

        pipe._decode = recorded_decode

    def begin(self, index: int) -> None:
        k = int(np.random.default_rng([self.seed % 2 ** 63, index, 1]).integers(0, self.steps - 1))
        self.active = dict(step=0, k=k, x={}, v={})

    def end(self, index: int, extra: dict) -> None:
        if self.active is not None:
            self.records[index] = dict(self.active, **extra)
        self.active = None

    def _hook(self, module, args, kwargs, output):
        a = self.active
        if a is None:
            return
        tokens, c, s = args[0], output.shape[-1], a["step"]
        if s == 0:
            a.update(lat0=tokens[..., :c].clone(), cond=tokens[..., c:].clone(),
                     txt=args[1].clone(), pooled=args[2].clone())
        if s in (a["k"], a["k"] + 1):
            a["x"][s], a["v"][s] = tokens[..., :c].clone(), output.clone()
        a["step"] += 1


def canvas_hw(size) -> tuple:
    """The canvas the single-line edit sends: the strip above the scene, both
    snapped to multiples of 32."""
    w, h = size
    return ((h + int(w * canvas.STRIP_RATIO)) // 32) * 32, (w // 32) * 32


def run(cell: dict, args, ctx: dict) -> dict:
    from textflux_torch.cli.run_inference import run as edit

    cfg, mix = cell["cfg"], cell["mix"]
    if (mix["loop"], mix["clients"], mix["batch"], cfg["dtype"]) != ("closed", 1, 1, "bfloat16"):
        raise ValueError("serve_closed_loop sends one bf16 request at a time from one client")
    dev = torch.device(ctx["device"])
    cycle, steps = len(mix["aspects"]), mix["steps"]
    work = tempfile.mkdtemp(prefix="h100_bench_requests_")
    try:
        t_build = time.time()
        pipe = build_pipeline(cfg, args.seed, dev)
        ctx["sync"]()
        phases = {"start_s": t_build - ctx["t_start"], "build_s": time.time() - t_build}
        pool = requests.make_pool(mix, args.seed, work)
        recorder = Recorder(pipe, args.seed, steps)

        def send(req, n_steps):
            return edit(pipe, req.scene, req.mask, req.words_file, steps=n_steps,
                        guidance_scale=mix["guidance"], seed=req.noise_seed,
                        sampler=mix["sampler"], device=dev.type)

        t_warm = time.time()
        for req in pool[:cycle]:           # every canvas shape the window sends
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
                images[i] = np.asarray(out[0])
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
        ctx["closed"]()
        if traced:
            trace = harness.reduce_trace(traced[2], traced[1], spans={n for _, n in SPANS})
            trace["images"] = [dict(zip(("n_txt", "n_img"), flops.edit_tokens(
                cfg, *canvas_hw(pool[traced[0] % len(pool)].size))), steps=steps)]
        span_ms = spans.ms() if spans else {}

        done = [j for j in range(i) if j in images]
        work_flops = [flops.edit_image(cfg, *canvas_hw(pool[j % len(pool)].size), steps)
                      for j in done]
        untraced = [n for n, j in enumerate(done) if traced is None or j != traced[0]]
        data = dict(spans=span_ms, trace=trace, images=len(done), cfg=cfg,
                    flops=sum(work_flops[n] for n in untraced),
                    busy_wall_s=sum(latencies[n] for n in untraced))

        # the sample: one finished request of each shape, drawn from the seed
        rng = np.random.default_rng([args.seed % 2 ** 63, 2])
        sample = []
        for pos in range(cycle):
            finished = [j for j in done if j % cycle == pos]
            if finished:
                sample.append(finished[int(rng.integers(0, len(finished)))])
        recs = []
        for j in sample:
            r = recorder.records[j]
            req = r.pop("request")
            recs.append(dict(r, words=req.words, scene=req.scene, mask=req.mask,
                             noise_seed=req.noise_seed, steps=steps, guidance=mix["guidance"],
                             image=images[j]))
        recorder.records.clear()
        del pipe, recorder, spans, traced, send, out
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            phases["held_after_window_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        t_ref = time.perf_counter()
        ref = serve_check.reference_outputs(cfg, args.seed, recs, dev, cfg["reference_rounding"])
        numbers = serve_check.judge(recs, ref)
        if ctx.get("control"):
            ctl = serve_check.reference_outputs(cfg, args.seed, recs, dev, cfg["control_rounding"])
            numbers = {"program": numbers, "control": serve_check.judge(recs, ref, ctl)}
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
                  latency_median_s=harness.quantile(lat_sorted, 0.5)))
