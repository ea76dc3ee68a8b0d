"""Batch evaluation entry point (the reference's scripts/run_eval.py).

The port of ``textflux_tpu/cli/run_eval.py``. Generates single-line edits
for every item in an AnyText-format json and saves full + cropped results
for the OCR/FID harnesses.

The reference farms one process per GPU from a Manager queue
(scripts/run_eval.py:221-247); here one process groups items into
//32-snapped resolution buckets and runs each bucket as batches through
``FillPipeline.generate_batch`` (``--batch-size``). RNG is per sample, so
batched outputs are the per-item path's (the default at batch size 1).
Runs on CUDA unless ``--device cpu``.

``--mesh dp,fsdp,tp`` serves over a mesh of the ranks torchrun starts
(``torchrun --nproc-per-node dp*fsdp*tp -m textflux_torch.cli.run_eval
--mesh dp,fsdp,tp ...``): the DiT tensor-parallel over tp and
storage-sharded over fsdp, each batch data-parallel over dp x fsdp
(``FillPipeline.generate_batch``). Every rank prepares the same
items from the same json; rank 0 alone writes images, crops and
failures.json. The ranks agree on every skip or failure before the denoise
starts (an item is served only when every rank prepared, and with
``--staged-text`` encoded, it; ``--skip-existing`` follows rank 0's
outputs): an item one rank dropped would leave the others waiting in a
collective. A failure inside the denoise is not recorded per item on a
mesh: it ends the run (torchrun then stops every rank).

Failures are caught per item (reference worker: scripts/run_eval.py:195-198)
and written with context to <output-dir>/failures.json so runs are auditable.

Usage:
  python -m textflux_torch.cli.run_eval \
      --model /path/to/FLUX.1-Fill-dev --transformer ... \
      --json-path data.json --original-images-dir imgs/ --output-dir out/ \
      [--batch-size 4] [--steps 30] [--guidance-scale 30] \
      [--scheduler default|overshoot] [--overshoot-c 2.0] \
      [--text-height-ratio 0.15625] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np
from PIL import Image

from textflux_torch.data.native import fill_poly as native_fill_poly
from textflux_torch.pipeline.prompts import build_prompts
from textflux_torch.rendering import (
    concat_multiline,
    crop_multiline_result,
    draw_glyph_flexible,
    draw_glyph_strip,
    load_font,
    render_glyph_regions,
)


def _host_f32(x) -> np.ndarray:
    return x.float().cpu().numpy()


def safe_name(img_name: str) -> str:
    """Flat, collision-free output filename for an eval item: subdirectory
    separators become '_'. A bare basename would let part1/0001.jpg and
    part2/0001.jpg silently overwrite each other (and --skip-existing would
    then skip both)."""
    return img_name.replace("\\", "/").strip("/").replace("/", "_")


def load_items(json_path: str) -> List[dict]:
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or "data_list" not in data:
        # reference format (scripts/run_eval.py:47-51): {"data_list": [...]}
        raise ValueError(
            f"{json_path}: expected the reference eval format "
            "{'data_list': [{'img_name', 'annotations': [{'text', "
            "'polygon'}]}, ...]}; got "
            f"{type(data).__name__} at top level")
    items, dropped = [], 0
    for it in data.get("data_list", []):
        # an item stays if ANY annotation is usable (gating on annotations[0]
        # alone silently excluded multiline items whose first region was
        # malformed but whose others were fine); items with nothing usable
        # are counted out loud rather than vanishing from the report's total
        if valid_annotations(it):
            items.append(it)
        else:
            dropped += 1
    if dropped:
        print(f"warning: skipped {dropped} item(s) with no usable annotation "
              f"(need both 'text' and 'polygon')")
    return items


def valid_annotations(item: dict) -> List[dict]:
    return [a for a in item.get("annotations") or []
            if a.get("text") and a.get("polygon")]


def prepare_item(item: dict, images_dir: str, font, text_height_ratio: float,
                 strip_renderer: str = "inference"):
    """Build the conditioning canvas for one eval item. Returns a dict with the
    combined image/mask, prompts, and crop geometry.

    strip_renderer: "inference" renders the antialiased RGB strip the
    reference inference scripts use (run_inference.py:123); "dataset" renders
    the hard-binary mode-'1' strip of the reference DATASET pipeline
    (image_datasets/dataset.py:62) — the conditioning distribution a model
    trained by cli.train actually saw. The published checkpoints tolerate the
    antialiasing gap; a model trained from scratch on little data may not."""
    ann = valid_annotations(item)[0]   # first USABLE region, not blindly [0]
    text = ann["text"]
    polygon = np.asarray(ann["polygon"], np.int32)
    img = Image.open(os.path.join(images_dir, item["img_name"])).convert("RGB")
    w, h = img.size

    if strip_renderer == "dataset":
        strip = draw_glyph_strip(font, text, w, h).convert("RGB")
        strip_h = strip.height
    else:
        strip_h = int(w * text_height_ratio)
        strip = draw_glyph_flexible(font, text, w, strip_h)

    # native scanline fill (the port's C++ library; raises without g++ — a
    # silently empty mask would make every edit a no-op that still counts
    # as done=N)
    mask1 = np.zeros((h, w), np.uint8)
    native_fill_poly(mask1, polygon.astype(np.float32), 255)
    mask = np.repeat(mask1[..., None], 3, axis=-1)
    combined = Image.fromarray(np.vstack((np.array(strip), np.array(img))))
    combined_mask = Image.fromarray(
        np.vstack((np.zeros((strip_h, w, 3), np.uint8), mask)))

    new_w, new_h = (w // 32) * 32, ((h + strip_h) // 32) * 32
    prompt, prompt_2 = build_prompts([text])
    return {
        # flattened (see safe_name): an img_name with a subdirectory would
        # crash the flat-directory save after a full 30-step generation
        "img_name": safe_name(item["img_name"]),
        "image": combined.resize((new_w, new_h)),
        "mask": combined_mask.resize((new_w, new_h)),
        "words": [text],
        "prompt": prompt,
        "prompt_2": prompt_2,
        "size": (new_w, new_h),
        "orig_h": h,
        "strip_h": strip_h,
    }


def prepare_item_multiline(item: dict, images_dir: str, font):
    """Multi-line conditioning for one eval item (the original TextFlux
    protocol, the reference's run_inference.py:409-441): every annotation's
    glyph is rendered INTO its polygon region on a scene-sized canvas
    (render_glyph_regions — explicit polygons, so annotation order is exact),
    which concatenates with the scene along the shorter axis. The mask covers
    all regions; the prompt lists all texts."""
    anns = valid_annotations(item)
    texts = [a["text"] for a in anns]
    polygons = [np.asarray(a["polygon"], np.float32) for a in anns]
    img = Image.open(os.path.join(images_dir, item["img_name"])).convert("RGB")
    w, h = img.size

    mask1 = np.zeros((h, w), np.uint8)
    for poly in polygons:
        native_fill_poly(mask1, poly, 255)
    mask = Image.fromarray(np.repeat(mask1[..., None], 3, axis=-1))
    rendered = render_glyph_regions((w, h), polygons, texts, font)
    combined, combined_mask, direction = concat_multiline(img, mask, rendered)

    cw, ch = combined.size
    new_w, new_h = (cw // 32) * 32, (ch // 32) * 32
    prompt, prompt_2 = build_prompts(texts)
    return {
        "img_name": safe_name(item["img_name"]),
        "image": combined.resize((new_w, new_h)),
        "mask": combined_mask.resize((new_w, new_h)),
        "words": texts,
        "prompt": prompt,
        "prompt_2": prompt_2,
        "size": (new_w, new_h),
        "direction": direction,
    }


def crop_scene(result: Image.Image, orig_h: int, strip_h: int) -> Image.Image:
    res_w, res_h = result.size
    top = int(res_h * strip_h / (orig_h + strip_h))
    return result.crop((0, top, res_w, res_h))


def group_by_bucket(prepared: List[dict]) -> dict:
    """Group prepared items by their //32-snapped (W, H): each bucket runs
    as batches of one shape."""
    buckets: dict = {}
    for prep in prepared:
        buckets.setdefault(prep["size"], []).append(prep)
    return buckets


def run_items(pipe, prepared: List[dict], *, batch_size: int, steps: int,
              guidance_scale: float, seed: int, sampler: str, overshoot_c,
              seq_pad_multiple, save_fn, failures: List[dict], strict: bool = False):
    """Drive prepared items through the pipeline in (H, W)-bucketed batches.

    batch_size 1 uses the per-item __call__ path; larger sizes use
    generate_batch (identical outputs — per-sample RNG). A generation that
    raises is recorded in `failures` and the run goes on, unless `strict`
    (on a mesh, where the other ranks may wait in a collective): then it
    raises."""
    caught = () if strict else (Exception,)
    if batch_size <= 1:
        for prep in prepared:
            try:
                te = prep.get("text_embeds")
                result = pipe(
                    image=prep["image"], mask_image=prep["mask"],
                    prompt=prep["prompt"], prompt_2=prep["prompt_2"],
                    width=prep["size"][0], height=prep["size"][1],
                    num_inference_steps=steps, guidance_scale=guidance_scale,
                    seed=seed, sampler=sampler, overshoot_c=overshoot_c,
                    seq_pad_multiple=seq_pad_multiple, text_embeds=te,
                )[0]
                save_fn(prep, result)
            except caught as e:  # per-item resilience, like the reference worker
                failures.append({"img_name": prep.get("img_name"), "error": repr(e)})
                print(f"FAILED {prep.get('img_name')}: {e}")
        return

    for (w, h), bucket in group_by_bucket(prepared).items():
        for i in range(0, len(bucket), batch_size):
            chunk = bucket[i:i + batch_size]
            te = None
            if all("text_embeds" in p for p in chunk):
                te = (np.concatenate([p["text_embeds"][0] for p in chunk]),
                      np.concatenate([p["text_embeds"][1] for p in chunk]))
            try:
                results = pipe.generate_batch(
                    [p["image"] for p in chunk],
                    [p["mask"] for p in chunk],
                    [p["words"] for p in chunk],
                    width=w, height=h,
                    num_inference_steps=steps, guidance_scale=guidance_scale,
                    seed=seed, sampler=sampler, overshoot_c=overshoot_c,
                    seq_pad_multiple=seq_pad_multiple, text_embeds=te,
                )
            except caught as e:  # whole chunk failed (e.g. OOM): record each
                for p in chunk:
                    failures.append({"img_name": p.get("img_name"), "error": repr(e)})
                print(f"FAILED batch of {len(chunk)} at {w}x{h}: {e}")
                continue
            for prep, result in zip(chunk, results):
                try:
                    save_fn(prep, result)
                except Exception as e:
                    failures.append({"img_name": prep.get("img_name"), "error": repr(e)})
                    print(f"FAILED {prep.get('img_name')}: {e}")


def main(argv=None):
    p = argparse.ArgumentParser(description="textflux batch evaluation (PyTorch)")
    p.add_argument("--model", required=True)
    p.add_argument("--transformer", default=None)
    p.add_argument("--lora", default=None)
    p.add_argument("--json-path", required=True)
    p.add_argument("--original-images-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--max-sequence-length", type=int, default=512,
                   help="T5 token length (reference run_inference.py:516-521; "
                        "must match the trained model's text stream length)")
    p.add_argument("--guidance-scale", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--scheduler", choices=["default", "overshoot"], default="default")
    p.add_argument("--overshoot-c", type=float, default=None,
                   help="AMO overshoot strength (reference set_c; default 2.0)")
    p.add_argument("--text-height-ratio", type=float, default=0.15625)
    p.add_argument("--strip-renderer", choices=["inference", "dataset"],
                   default="inference",
                   help="single-line strip style: 'inference' = antialiased "
                        "RGB (reference run_inference.py:123); 'dataset' = "
                        "hard-binary mode-'1' with the min(w//6,h) height "
                        "clamp (image_datasets/dataset.py:62) — match a "
                        "from-scratch cli.train model's conditioning")
    p.add_argument("--multiline", action="store_true",
                   help="original full-canvas conditioning: render every "
                        "annotation's glyph into its polygon region and "
                        "concat canvas+scene (reference run_inference.py:"
                        "409-441); default is the beta single-line strip")
    p.add_argument("--font", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--skip-existing", action="store_true",
                   help="resume an interrupted run: skip items whose full + "
                        "cropped outputs already exist in --output-dir")
    p.add_argument("--batch-size", type=int, default=1,
                   help="batch per (H,W) bucket; 1 = per-item path")
    p.add_argument("--mesh", default=None,
                   help="dp,fsdp,tp: serve over the ranks torchrun starts (dp*fsdp*tp "
                        "of them): the DiT tensor-parallel over tp and sharded over "
                        "fsdp, batches data-parallel over dp x fsdp. Rank 0 writes")
    p.add_argument("--quantize", action="store_true",
                   help="quantise the DiT as it loads (int8 weight-only by default)")
    p.add_argument("--quantize-mode", choices=["weight_only", "w8a8", "nf4", "mixed"],
                   default=None,
                   help="weight_only: int8 codes dequantised into the matmuls; w8a8: "
                        "int8 x int8 products; nf4: 4-bit codes; mixed: int8 on the "
                        "input/output modules, nf4 inside the blocks. Passing a mode "
                        "implies --quantize")
    p.add_argument("--seq-pad-multiple", type=int, default=256,
                   help="pad image-token counts to a multiple (padded keys masked), "
                        "so resolutions share sequence buckets")
    p.add_argument("--staged-text", action="store_true",
                   help="staged residency: encode every prompt first, free the "
                        "text encoders, then load the DiT")
    p.add_argument("--no-quantize-t5", action="store_true",
                   help="keep the T5 encoder unquantised when --quantize is on "
                        "(default: T5 goes int8 weight-only with the DiT)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from textflux_torch.config import PipelineConfig
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.pipeline.fill import FillPipeline

    mesh = None
    if args.mesh:
        shape = PT.serving_mesh_shape(args.mesh)   # checked before anything loads
        mesh = PT.make_mesh(shape, device=args.device)
    writer = mesh is None or mesh.rank == 0

    def agree(flags):
        return flags if mesh is None else PT.agree(flags)

    pipe = FillPipeline.from_pretrained(
        args.model, transformer_path=args.transformer, lora_path=args.lora,
        quantize=((args.quantize_mode or "weight_only")
                  if (args.quantize or args.quantize_mode) else False),
        quantize_t5=False if args.no_quantize_t5 else None,
        defer_transformer=args.staged_text, mesh=mesh,
        pipe_cfg=PipelineConfig(max_sequence_length=args.max_sequence_length),
        device=args.device)
    sampler = "overshoot" if args.scheduler == "overshoot" else "euler"
    # reference font sizing: 40 for in-region multi-line glyphs, 60 for strips
    font = load_font(args.font, 40 if args.multiline else 60)

    full_dir = os.path.join(args.output_dir, "full_images")
    crop_dir = os.path.join(args.output_dir, "cropped_images")
    if writer:
        os.makedirs(full_dir, exist_ok=True)
        os.makedirs(crop_dir, exist_ok=True)
    log = print if writer else (lambda *a, **k: None)

    items = load_items(args.json_path)
    if args.limit:
        items = items[: args.limit]
    skipped = 0
    if args.skip_existing:
        def _done(it):
            n = safe_name(it.get("img_name", ""))
            return (os.path.exists(os.path.join(full_dir, n))
                    and os.path.exists(os.path.join(crop_dir, n)))

        before = len(items)
        # the writer's outputs decide
        keep = agree([not (writer and _done(it)) for it in items])
        items = [it for it, k in zip(items, keep) if k]
        skipped = before - len(items)
        if skipped:
            log(f"skipping {skipped} already-generated items")
    log(f"{len(items)} eval items")

    failures: List[dict] = []
    prepared = []
    for item in items:
        try:
            prepared.append(
                prepare_item_multiline(item, args.original_images_dir, font)
                if args.multiline else
                prepare_item(item, args.original_images_dir, font,
                             args.text_height_ratio, args.strip_renderer))
        except Exception as e:
            prepared.append(None)
            failures.append({"img_name": item.get("img_name"), "error": repr(e)})
            log(f"FAILED prepare {item.get('img_name')}: {e}")
    ready = agree([p is not None for p in prepared])
    for item, prep, ok in zip(items, prepared, ready):
        if not ok and prep is not None:
            failures.append({"img_name": item.get("img_name"),
                             "error": "failed to prepare on another rank"})
    prepared = [p for p, ok in zip(prepared, ready) if ok]

    if args.staged_text:
        # phase 1: text encoders resident, DiT deferred — encode every prompt
        # in device-batch chunks (one T5 forward per chunk, not per item)
        enc_bs = max(args.batch_size, 8)
        for i in range(0, len(prepared), enc_bs):
            chunk = prepared[i:i + enc_bs]
            try:
                pooled, txt = pipe.encode_batch_prompts(
                    [p["words"] for p in chunk])
                for j, prep in enumerate(chunk):
                    prep["text_embeds"] = (_host_f32(pooled[j:j + 1]),
                                           _host_f32(txt[j:j + 1]))
            except Exception as e:  # fall back per item so one bad prompt
                # doesn't take down the chunk
                for prep in chunk:
                    try:
                        pooled, txt = pipe.encode_batch_prompts([prep["words"]])
                        prep["text_embeds"] = (_host_f32(pooled), _host_f32(txt))
                    except Exception as e2:
                        failures.append({"img_name": prep.get("img_name"),
                                         "error": repr(e2)})
                        log(f"FAILED encode {prep.get('img_name')}: {e2}")
        encoded = agree(["text_embeds" in p for p in prepared])
        for prep, ok in zip(prepared, encoded):
            if not ok and "text_embeds" in prep:
                failures.append({"img_name": prep.get("img_name"),
                                 "error": "failed to encode on another rank"})
        prepared = [p for p, ok in zip(prepared, encoded) if ok]
        # phase 2: free the encoders, load the DiT
        pipe.release_text_encoders()
        pipe.load_transformer()

    saved = []

    def save_fn(prep, result):
        if not writer:
            return
        result.save(os.path.join(full_dir, prep["img_name"]))
        cropped = (crop_multiline_result(result, prep["direction"])
                   if "direction" in prep else
                   crop_scene(result, prep["orig_h"], prep["strip_h"]))
        cropped.save(os.path.join(crop_dir, prep["img_name"]))
        saved.append(prep["img_name"])

    run_items(
        pipe, prepared, batch_size=args.batch_size, steps=args.steps,
        guidance_scale=args.guidance_scale, seed=args.seed, sampler=sampler,
        overshoot_c=args.overshoot_c,
        seq_pad_multiple=args.seq_pad_multiple or None,
        save_fn=save_fn, failures=failures, strict=mesh is not None)

    if writer:
        report = {"total": len(items), "done": len(saved), "failed": len(failures),
                  "skipped_existing": skipped, "failures": failures}
        with open(os.path.join(args.output_dir, "failures.json"), "w",
                  encoding="utf-8") as f:
            json.dump(report, f, ensure_ascii=False, indent=2)
        print(f"done={len(saved)} failed={len(failures)}")

if __name__ == "__main__":
    main()
