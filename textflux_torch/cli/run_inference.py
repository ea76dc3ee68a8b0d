"""Single-image inference CLI: render the glyph conditioning, fill, crop, save.

The port of ``textflux_tpu/cli/run_inference.py``:

  python -m textflux_torch.cli.run_inference \
      --model /path/to/FLUX.1-Fill-dev \
      --transformer /path/to/textflux-beta/transformer \
      --image ori.png --mask mask.png --words words.txt \
      [--lora path] [--steps 30] [--guidance-scale 30 | 4] [--seed 42]
      [--scheduler default|overshoot] [--staged-text] [--output-dir outputs]
      [--quantize] [--quantize-mode weight_only|w8a8|nf4|mixed] [--no-quantize-t5]
      [--device cuda|cpu]

Loads a diffusers-layout checkpoint onto the device (a LoRA folded in at
load): FLUX.1-Fill into ``FillPipeline``, or, when the transformer's
config.json names ``QwenImageTransformer2DModel``, Qwen-Image into
``pipeline.qwen_image.QwenImagePipeline`` (bf16, true CFG against " ",
inpainting by latent blending), or, when it names
``WanVACETransformer3DModel``, Wan2.1-VACE into
``pipeline.wan_vace.WanVACEPipeline`` (bf16, CFG 5 against the negative
prompt). For Wan, ``--image`` is a clip: a directory of numbered PNG frames
(1 + 4k of them), ``--mask`` one mask for every frame or a directory of one
mask a frame; the results are directories of numbered frames. Auto-detects single-line (glyph strip stacked above) vs multi-line
(per-region rotated glyphs) conditioning from the word file, mirrors the
reference's //32 snap and saves the same artifact set (full result, crop,
mask, ori, rendered, txt). Runs on CUDA unless ``--device cpu`` is asked.
``--quantize`` serves an int8 DiT (``--quantize-mode``: weight_only, the
default; w8a8; nf4; mixed; a mode implies ``--quantize``), quantised as it
loads, with T5 int8 weight-only unless ``--no-quantize-t5``.
"""

from __future__ import annotations

import argparse
import os
import shutil

from PIL import Image

from textflux_torch.device import resolve_device
from textflux_torch.pipeline.image_processor import snap_to_multiple
from textflux_torch.pipeline.prompts import build_prompts, read_words
from textflux_torch.rendering import (
    SINGLE_LINE_STRIP_RATIO,
    concat_multiline,
    concat_singleline,
    crop_multiline_result,
    crop_singleline_result,
    draw_glyph_flexible,
    load_font,
    render_glyph_multi,
)
from textflux_torch.utils.tracking import span


def render_conditioning(original: Image.Image, mask: Image.Image, words, font=None):
    """Build the concat canvas. Returns (image, mask, crop_fn, rendered)."""
    if len(words) > 1:
        rendered = render_glyph_multi(original, mask, words, font=font)
        combined, combined_mask, direction = concat_multiline(original, mask, rendered)
        return combined, combined_mask, (
            lambda result: crop_multiline_result(result, direction)), rendered
    font = font or load_font(size=60)
    w = original.size[0]
    strip_h = int(w * SINGLE_LINE_STRIP_RATIO)
    strip = draw_glyph_flexible(font, " ".join(words), w, strip_h)
    combined, combined_mask, sh = concat_singleline(original, mask, strip)
    orig_h = original.size[1]
    return combined, combined_mask, (
        lambda result: crop_singleline_result(result, orig_h, sh)), strip


def clip_frames(path: str) -> list:
    """The PNG frames of a clip directory, in the order of their names."""
    names = sorted(n for n in os.listdir(path) if n.lower().endswith(".png"))
    if not names:
        raise ValueError(f"no PNG frames in {path}")
    return [os.path.join(path, n) for n in names]


def run(pipe, image_path, mask_path, words_path, *, steps=30, guidance_scale=30.0,
        seed=42, sampler="euler", overshoot_c=None, font_path=None, device="cuda"):
    """Fill one image with `pipe` (a ``FillPipeline`` or a
    ``QwenImagePipeline``; `guidance_scale` is the latter's true-CFG scale,
    None for the pipeline's default), or, when `image_path` is a directory,
    a clip with a ``WanVACEPipeline``: then every returned image is a list
    of frames. `device` names where the caller expects `pipe` to run; it
    must match the pipeline's own device (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    if pipe.device.type != dev.type:
        raise ValueError(f"the pipeline runs on {pipe.device}, but device={device!r} was asked")
    if os.path.isdir(image_path):
        return _run_clip(pipe, image_path, mask_path, words_path, steps=steps,
                         guidance_scale=guidance_scale, seed=seed, sampler=sampler,
                         font_path=font_path)
    with span("edit.request"):
        original = Image.open(image_path).convert("RGB")
        mask = Image.open(mask_path).convert("RGB")
        words = read_words(words_path)
        font = load_font(font_path, 40 if len(words) > 1 else 60)

        with span("edit.render"):
            combined, combined_mask, crop_fn, rendered = render_conditioning(
                original, mask, words, font)
            # snap to //32 like the reference
            w, h = combined.size
            new_w, new_h = snap_to_multiple(w, h)
            combined = combined.resize((new_w, new_h))
            combined_mask = combined_mask.resize((new_w, new_h))

        prompt, prompt_2 = build_prompts(words)
        text_embeds = None
        if getattr(pipe, "flux", None) is None and hasattr(pipe, "_deferred_flux"):
            # staged residency: encode now, free the encoders, then load the
            # DiT, so the T5 encoder and the DiT never share the device
            text_embeds = pipe.encode_prompts(prompt, prompt_2)
            pipe.release_text_encoders()
            pipe.load_transformer()
        result = pipe(
            image=combined, mask_image=combined_mask,
            prompt=prompt, prompt_2=prompt_2,
            height=new_h, width=new_w,
            num_inference_steps=steps, guidance_scale=guidance_scale,
            seed=seed, sampler=sampler, overshoot_c=overshoot_c,
            text_embeds=text_embeds,
        )[0]
        with span("edit.crop"):
            cropped = crop_fn(result)
        return result, cropped, rendered, original, mask


def _run_clip(pipe, frames_dir, mask_path, words_path, *, steps, guidance_scale, seed,
              sampler, font_path):
    """``run`` for a clip: the single-line canvas of every frame (one glyph
    strip, drawn once), the pipeline over all of them, each result cropped."""
    with span("edit.request"):
        originals = [Image.open(f).convert("RGB") for f in clip_frames(frames_dir)]
        masks = ([Image.open(f).convert("RGB") for f in clip_frames(mask_path)]
                 if os.path.isdir(mask_path) else
                 [Image.open(mask_path).convert("RGB")] * len(originals))
        if len(masks) != len(originals):
            raise ValueError(f"{len(originals)} frames but {len(masks)} masks")
        words = read_words(words_path)
        if len(words) > 1:
            raise ValueError("a clip takes the single-line edit: one line of words")
        font = load_font(font_path, 60)
        with span("edit.render"):
            canvases, canvas_masks, crops = [], [], []
            strip = None
            for frame, m in zip(originals, masks):
                combined, combined_mask, crop_fn, rendered = render_conditioning(
                    frame, m, words, font)
                strip = strip or rendered
                new_w, new_h = snap_to_multiple(*combined.size)
                canvases.append(combined.resize((new_w, new_h)))
                canvas_masks.append(combined_mask.resize((new_w, new_h)))
                crops.append(crop_fn)
        prompt, prompt_2 = build_prompts(words)
        result = pipe(image=canvases, mask_image=canvas_masks, prompt=prompt, prompt_2=prompt_2,
                      height=new_h, width=new_w, num_inference_steps=steps,
                      guidance_scale=guidance_scale, seed=seed, sampler=sampler)
        with span("edit.crop"):
            cropped = [crop(r) for crop, r in zip(crops, result)]
        return result, cropped, strip, originals, masks


def save_clip_results(out_dir, result, cropped, masks, originals, rendered, words_path):
    """A clip's artifacts: numbered frames under result_NNNN/ and
    crop/crop_NNNN/, the masks and originals likewise, the strip and the
    words once."""
    n = 1
    while os.path.exists(os.path.join(out_dir, f"result_{n:04d}")):
        n += 1
    seq = f"{n:04d}"
    for sub, frames in ((f"result_{seq}", result), (f"crop/crop_{seq}", cropped),
                        (f"mask/mask_{seq}", masks), (f"ori/ori_{seq}", originals)):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        for i, frame in enumerate(frames):
            frame.save(os.path.join(out_dir, sub, f"{i:04d}.png"))
    os.makedirs(os.path.join(out_dir, "rendered"), exist_ok=True)
    rendered.convert("RGB").save(os.path.join(out_dir, "rendered", f"rendered_{seq}.png"))
    os.makedirs(os.path.join(out_dir, "txt"), exist_ok=True)
    shutil.copy2(words_path, os.path.join(out_dir, "txt", f"words_{seq}.txt"))
    return seq


def save_results(out_dir, result, cropped, mask, original, rendered, words_path):
    for sub in ("", "crop", "mask", "ori", "txt", "rendered"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    n = 1
    while os.path.exists(os.path.join(out_dir, f"result_{n:04d}.png")):
        n += 1
    seq = f"{n:04d}"
    result.save(os.path.join(out_dir, f"result_{seq}.png"))
    cropped.save(os.path.join(out_dir, "crop", f"crop_{seq}.png"))
    mask.save(os.path.join(out_dir, "mask", f"mask_{seq}.png"))
    original.save(os.path.join(out_dir, "ori", f"ori_{seq}.png"))
    rendered.convert("RGB").save(os.path.join(out_dir, "rendered", f"rendered_{seq}.png"))
    if os.path.exists(words_path):
        shutil.copy2(words_path, os.path.join(out_dir, "txt", f"words_{seq}.txt"))
    return seq


def main(argv=None):
    p = argparse.ArgumentParser(description="textflux single-image inference (PyTorch)")
    p.add_argument("--model", required=True, help="FLUX.1-Fill-dev checkpoint dir")
    p.add_argument("--transformer", default=None, help="fine-tuned transformer dir")
    p.add_argument("--lora", default=None, help="LoRA weights (folded at load)")
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--words", required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--max-sequence-length", type=int, default=512,
                   help="T5 token length")
    p.add_argument("--guidance-scale", type=float, default=None,
                   help="FLUX's guidance (default 30), or Qwen-Image's true-CFG scale "
                        "(default 4), or Wan's CFG scale (default 5)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--scheduler", choices=["default", "overshoot"], default="default")
    p.add_argument("--overshoot-c", type=float, default=None,
                   help="AMO overshoot strength (default 2.0)")
    p.add_argument("--font", default=None)
    p.add_argument("--quantize", action="store_true",
                   help="quantise the DiT as it loads (int8 weight-only by default)")
    p.add_argument("--quantize-mode", choices=["weight_only", "w8a8", "nf4", "mixed"],
                   default=None,
                   help="weight_only: int8 codes dequantised into the matmuls; w8a8: "
                        "int8 x int8 products; nf4: 4-bit codes; mixed: int8 on the "
                        "input/output modules, nf4 inside the blocks. Passing a mode "
                        "implies --quantize")
    p.add_argument("--staged-text", action="store_true",
                   help="staged residency: encode the prompt, free the text "
                        "encoders, then load the DiT")
    p.add_argument("--no-quantize-t5", action="store_true",
                   help="keep the T5 encoder unquantised when --quantize is on "
                        "(default: T5 goes int8 weight-only with the DiT)")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    # read_words treats a non-existent path as raw text (demo-input
    # semantics); for the CLI that silently renders the path string
    for path_arg in (args.image, args.mask, args.words):
        if not os.path.exists(path_arg):
            p.error(f"file not found: {path_arg}")

    from textflux_torch.config import PipelineConfig
    from textflux_torch.io.config_io import transformer_class
    from textflux_torch.pipeline.fill import FillPipeline

    t_path = args.transformer or os.path.join(args.model, "transformer")
    kind = transformer_class(t_path)
    if kind in ("QwenImageTransformer2DModel", "WanVACETransformer3DModel"):
        if args.lora or args.quantize or args.quantize_mode or args.staged_text:
            p.error(f"a {kind} checkpoint is served in bf16 alone: no --lora, --quantize, "
                    "--quantize-mode or --staged-text")
        if args.scheduler != "default":
            p.error(f"a {kind} checkpoint samples with Euler only")
    if kind == "WanVACETransformer3DModel":
        from textflux_torch.pipeline.wan_vace import WanVACEPipeline

        if not os.path.isdir(args.image):
            p.error("a Wan2.1-VACE checkpoint edits a clip: --image is a directory of frames")
        pipe = WanVACEPipeline.from_pretrained(args.model, transformer_path=args.transformer,
                                               device=args.device)
        result, cropped, rendered, originals, masks = run(
            pipe, args.image, args.mask, args.words, steps=args.steps,
            guidance_scale=args.guidance_scale, seed=args.seed, font_path=args.font,
            device=args.device)
        seq = save_clip_results(args.output_dir, result, cropped, masks, originals, rendered,
                                args.words)
        print(f"saved result_{seq}/ under {args.output_dir}")
        return
    if kind == "QwenImageTransformer2DModel":
        from textflux_torch.pipeline.qwen_image import QwenImagePipeline

        pipe = QwenImagePipeline.from_pretrained(args.model, transformer_path=args.transformer,
                                                 device=args.device)
    else:
        pipe = FillPipeline.from_pretrained(
            args.model, transformer_path=args.transformer, lora_path=args.lora,
            # an explicit --quantize-mode implies --quantize: serving unquantised
            # because only the mode was passed would be a trap
            quantize=((args.quantize_mode or "weight_only")
                      if (args.quantize or args.quantize_mode) else False),
            quantize_t5=False if args.no_quantize_t5 else None,
            defer_transformer=args.staged_text,
            pipe_cfg=PipelineConfig(max_sequence_length=args.max_sequence_length),
            device=args.device)
    sampler = "overshoot" if args.scheduler == "overshoot" else "euler"
    result, cropped, rendered, original, mask = run(
        pipe, args.image, args.mask, args.words,
        steps=args.steps, guidance_scale=args.guidance_scale,
        seed=args.seed, sampler=sampler, overshoot_c=args.overshoot_c,
        font_path=args.font, device=args.device)
    seq = save_results(args.output_dir, result, cropped, mask, original, rendered, args.words)
    print(f"saved result_{seq}.png under {args.output_dir}")


if __name__ == "__main__":
    main()
