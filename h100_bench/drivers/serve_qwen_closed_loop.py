"""serve_qwen_closed_loop: one client editing images one at a time with
Qwen-Image through ``textflux_torch.cli.run_inference.run``, true CFG and
inpainting by latent blending, on a pipeline built from seeded weights.

Set-up: the configuration is written as a diffusers-layout set of
config.json files and read by the program's own readers; the DiT, the
Qwen2.5 text encoder and the Wan VAE are built on the meta device and take
the seed's bf16 weights (``weights``); the tokenizer is a byte stand-in
(the reference's ``qwen_text.byte_ids`` without the template, which the
program adds); the pool of requests is written; each canvas shape of the
mix runs once at a few steps, so every graph key the window uses
(canvas x text bucket) is captured before it. The window then sends the
pool's requests back to back and closes at the end of the first whole
cycle of shapes after ``--seconds``. With ``--trace 1`` the program's
stages run under CUDA-event spans and one request of the first cycle
runs under the profiler.

Wrappers on the pipeline's stages and a forward hook on the DiT keep, for
every request, what the comparison judges (``reference.qwen_check``): the
embeddings, z0 and the mask, the initial latents, the two velocities and
the guided one at two steps drawn from the seed, the state around the
first of them and the DiT's arguments there, and the final latents; on
every step, the blend's largest deviation on the unmasked tokens (a few
elementwise kernels a step, left on the device until the window ends).
After the window, for one finished request per shape drawn from the seed,
the DiT runs again eagerly on the arguments it got at the first judged
step, and its streams between blocks are kept on the host; then the
program is freed and the reference judges those requests.
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

from h100_bench import flops_qwen, harness, requests, weights
from h100_bench.reference import canvas, qwen_check
from h100_bench.reference import qwen_image as Q, qwen_text as QT, vae_wan as W
from textflux_torch.cli.run_inference import run as edit
from textflux_torch.pipeline.qwen_image import QwenImagePipeline

TRACE_REQUEST = 2   # the first cycle's 4:3 canvas, after the warm-up
JUDGED_BLOCKS = 4   # blocks judged part by part in each sampled forward, drawn from the seed
SPANS = (("encode_prompts", "text_encode"), ("_prepare_image", "vae_encode"),
         ("_decode", "vae_decode"), ("_denoise_step", "denoise_step"))
# the configuration's models: (key, checkpoint folder, reference skeleton)
PARTS = (("qwen_dit", "transformer", Q.QwenDiT), ("qwen_text", "text_encoder", QT.QwenText),
         ("wan_vae", "vae", W.WanVAE))


def byte_tokenize(text: str) -> np.ndarray:
    """The stand-in tokenizer: the text's UTF-8 bytes, (1, L) int64."""
    return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)[None]


def build_pipeline(cfg: dict, seed: int, device):
    """The program's QwenImagePipeline on `device` with the seed's weights."""
    from textflux_torch.io import config_io
    from textflux_torch.models.qwen_image import QwenImageTransformer
    from textflux_torch.models.qwen_text import QwenTextEncoder
    from textflux_torch.models.vae_wan import WanVAE

    programs = {"qwen_dit": (QwenImageTransformer, config_io.qwen_image_config_from),
                "qwen_text": (QwenTextEncoder, config_io.qwen_text_config_from),
                "wan_vae": (WanVAE, config_io.wan_vae_config_from)}
    folder = tempfile.mkdtemp(prefix="h100_bench_cfg_")
    models = {}
    try:
        for kind, sub, skeleton in PARTS:
            os.makedirs(os.path.join(folder, sub))
            with open(os.path.join(folder, sub, "config.json"), "w") as f:
                json.dump(cfg[kind], f)
            cls, read = programs[kind]
            module = cls(read(os.path.join(folder, sub)), device="meta", dtype=torch.bfloat16)
            module.load_state_dict(weights.state_dict(seed, kind, weights.groups(
                skeleton(cfg[kind])), device), assign=True, strict=True)
            models[kind] = module.requires_grad_(False)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return QwenImagePipeline(dit=models["qwen_dit"], text_encoder=models["qwen_text"],
                             vae=models["wan_vae"], tokenize=byte_tokenize,
                             template_drop=QT.TEMPLATE_DROP, device=device)


class Recorder:
    """Keeps, for the request under way, what ``qwen_check`` judges (module
    docstring)."""

    def __init__(self, pipe, seed: int, steps: int):
        self.seed, self.steps = seed, steps
        self.records, self.active = {}, None
        self.blend = None
        pipe.dit.register_forward_hook(self._dit, with_kwargs=True)
        for attr in ("encode_prompts", "_prepare_image", "_denoise_step", "_guidance",
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

    def _prepare_image(self, out, *a, **kw):
        self.active["z0"], self.active["mask"] = (t.clone() for t in out)

    def _denoise_step(self, out, lat, texts, mods, sigma, sigma_next, *, mask, z0, noise,
                      step, **kw):
        a = self.active
        if step == 0:
            a["lat0"] = lat.clone()
        if step in (a["k"], a["k"] + 1):
            a["x"][step] = lat.clone()
        # the blend's deviation on the unmasked tokens, in bf16 last places
        s = np.float32(sigma_next)
        exact = float(np.float32(1.0) - s) * z0.float() + float(s) * noise.float()
        _, e = torch.frexp(out.float())
        dev = (out.float() - exact).abs() / torch.ldexp(torch.ones_like(exact), e - 8)
        worst = (dev * (1.0 - mask.float())).amax()
        self.blend = worst if self.blend is None else torch.maximum(self.blend, worst)
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


def rerun(dit, call, blocks, n_txt: int) -> dict:
    """The DiT's forward run again eagerly on a recorded call's (args,
    kwargs), keeping on the host what ``qwen_image.stage_gaps`` judges:
    the velocity v, the (txt, img) streams before the first block (first)
    and the image stream after the last (last), and for each block of
    `blocks` its modulation vectors and (txt, img) at its input (in), out
    of the attention's output projections (attn), into and out of the MLPs
    (mlp_in, mlp) and at its output (out); the text cut to its own
    `n_txt` tokens (its padding dropped).

    The parts inside a block are read by wrapping the transformer module's
    row- and column-parallel linear helpers for the call: each wrapper
    returns what the helper returns."""
    from textflux_torch.models import transformer as T

    kwargs = call[1]
    kept = dict(blocks={i: dict(mods=tuple(t.to("cpu") for t in kwargs["mods"]["double"][i]))
                        for i in blocks})

    def pair(txt_, img_):
        return txt_[:, :n_txt].to("cpu"), img_.to("cpu")

    # a linear's id -> (block, part, stream, whether its input or output is kept)
    roles = {}
    for i in blocks:
        blk = dit.double_blocks[i]
        for stream in ("txt", "img"):
            mlp = getattr(blk, stream + "_mlp")
            roles[id(getattr(blk, stream + "_proj"))] = (i, "attn", stream, False)
            roles[id(mlp.fc1)] = (i, "mlp_in", stream, True)
            roles[id(mlp.fc2)] = (i, "mlp", stream, False)
    parts = {}

    def spy(helper):
        def wrapped(lin, x, mesh):
            y = helper(lin, x, mesh)
            if id(lin) in roles:
                i, part, stream, is_input = roles[id(lin)]
                parts[i, part, stream] = x if is_input else y
            return y
        return wrapped

    def at(i, part):
        return lambda m, a, out=None: kept["blocks"][i].update({part: pair(*(out or a)[:2])})

    last = len(dit.double_blocks) - 1
    hooks = [dit.double_blocks[0].register_forward_pre_hook(
                 lambda m, a: kept.update(first=pair(*a[:2]))),
             dit.double_blocks[last].register_forward_hook(
                 lambda m, a, out: kept.update(last=out[1].to("cpu")))]
    for i in blocks:
        hooks += [dit.double_blocks[i].register_forward_pre_hook(at(i, "in")),
                  dit.double_blocks[i].register_forward_hook(at(i, "out"))]
    helpers = T._row, T._col
    T._row, T._col = (spy(h) for h in helpers)
    try:
        with torch.inference_mode():
            kept["v"] = dit._forward(*call[0], **call[1])
    finally:
        T._row, T._col = helpers
        for h in hooks:
            h.remove()
    for i, part, stream in parts:
        if stream == "txt":
            kept["blocks"][i][part] = pair(parts[i, part, "txt"], parts[i, part, "img"])
    return kept


def canvas_hw(size) -> tuple:
    """The canvas the single-line edit sends: the strip above the scene, both
    snapped to multiples of 32."""
    w, h = size
    return ((h + int(w * canvas.STRIP_RATIO)) // 32) * 32, (w // 32) * 32


def text_lengths(words) -> tuple:
    """(positive, negative) text tokens the DiT gets for a request's words."""
    return tuple(QT.byte_ids(p).shape[1] - QT.TEMPLATE_DROP
                 for p in (canvas.prompts(words)[1], qwen_check.NEGATIVE_PROMPT))


def run(cell: dict, args, ctx: dict) -> dict:
    cfg, mix = cell["cfg"], cell["mix"]
    if (mix["loop"], mix["clients"], mix["batch"], cfg["dtype"]) != ("closed", 1, 1, "bfloat16"):
        raise ValueError("serve_qwen_closed_loop sends one bf16 request at a time from one client")
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
                        guidance_scale=mix["true_cfg_scale"], seed=req.noise_seed,
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
        graphs = pipe.dit.graphs
        counted = (graphs.replays, graphs.calls, dict(pipe.text_tokens))
        recorder.blend = None

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
        if dev.type == "cuda":   # the allocator's pool, the graphs' included
            phases["reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
        ctx["closed"]()
        replays, calls = graphs.replays - counted[0], graphs.calls - counted[1]
        tokens = {k: pipe.text_tokens[k] - counted[2][k] for k in counted[2]}
        blend_ulp = float(recorder.blend) if recorder.blend is not None else float("inf")

        def shape(j):
            req = pool[j % len(pool)]
            h, w = canvas_hw(req.size)
            n_pos, n_neg = text_lengths(req.words)
            return dict(height=h, width=w, n_pos=n_pos, n_neg=n_neg, steps=steps,
                        n_img=flops_qwen.image_tokens(cfg, h, w))

        if traced:
            trace = harness.reduce_trace(traced[2], traced[1], spans={n for _, n in SPANS})
            trace["images"] = [shape(traced[0])]
        span_ms = spans.ms() if spans else {}
        done = [j for j in range(i) if j in images]
        work_flops = [flops_qwen.edit_image(cfg, **{k: v for k, v in shape(j).items()
                                                    if k != "n_img"}) for j in done]
        untraced = [n for n, j in enumerate(done) if traced is None or j != traced[0]]
        data = dict(spans=span_ms, trace=trace, images=len(done), cfg=cfg,
                    flops=sum(work_flops[n] for n in untraced),
                    busy_wall_s=sum(latencies[n] for n in untraced),
                    graphs=dict(replays=replays, calls=calls), text_tokens=tokens)

        # the sample: one finished request of each shape, drawn from the seed
        rng = np.random.default_rng([args.seed % 2 ** 63, 2])
        sample = []
        for pos in range(cycle):
            finished = [j for j in done if j % cycle == pos]
            if finished:
                sample.append(finished[int(rng.integers(0, len(finished)))])
        recs, n_blocks = [], len(pipe.dit.double_blocks)
        for j in sample:
            r = recorder.records[j]
            req, dit_calls = r.pop("request"), r.pop("call")
            stages, gap = {}, 0.0
            for n, (kind, call) in enumerate(sorted(dit_calls.items())):
                blocks = np.random.default_rng([args.seed % 2 ** 63, j, n, 3]).choice(
                    n_blocks, min(JUDGED_BLOCKS, n_blocks), replace=False)
                stages[kind] = rerun(pipe.dit, call, sorted(int(b) for b in blocks),
                                     r["txt_" + kind].shape[1])
                gap = max(gap, float((stages[kind].pop("v").float()
                                      - r["v_" + kind][r["k"]].float()).abs().max()))
            recs.append(dict(r, words=req.words, scene=req.scene, mask_file=req.mask,
                             noise_seed=req.noise_seed, steps=steps,
                             cfg_scale=mix["true_cfg_scale"], image=images[j],
                             blend_ulp=blend_ulp, stages=stages, rerun_max_abs=gap))
        recorder.records.clear()
        del pipe, recorder, spans, traced, send, out, graphs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            phases["held_after_window_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        t_ref = time.perf_counter()
        ref = qwen_check.reference_outputs(cfg, args.seed, recs, dev, cfg["reference_rounding"])
        numbers = qwen_check.judge(recs, ref)
        if ctx.get("control"):
            ctl = qwen_check.reference_outputs(cfg, args.seed, recs, dev, cfg["control_rounding"])
            numbers = {"program": numbers, "control": qwen_check.judge(recs, ref, ctl)}
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
                  graphs=dict(replays=replays, calls=calls), text_tokens=tokens))
