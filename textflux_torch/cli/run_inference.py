"""Single-image inference CLI: render the glyph conditioning, fill, crop, save.

The port of ``textflux_tpu/cli/run_inference.py``:

  python -m textflux_torch.cli.run_inference \
      --model /path/to/FLUX.1-Fill-dev \
      --transformer /path/to/textflux-beta/transformer \
      --image ori.png --mask mask.png --words words.txt \
      [--lora path] [--steps 30] [--guidance-scale 30] [--seed 42]
      [--scheduler default|overshoot] [--staged-text] [--output-dir outputs]
      [--quantize] [--quantize-mode weight_only|w8a8|nf4|mixed] [--no-quantize-t5]
      [--device cuda|cpu]

Loads a diffusers-layout checkpoint onto the device (a LoRA folded in at
load), auto-detects single-line (glyph strip stacked above) vs multi-line
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


def run(pipe, image_path, mask_path, words_path, *, steps=30, guidance_scale=30.0,
        seed=42, sampler="euler", overshoot_c=None, font_path=None, device="cuda"):
    """Fill one image. `device` names where the caller expects `pipe` to run;
    it must match the pipeline's own device (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    if pipe.device.type != dev.type:
        raise ValueError(f"the pipeline runs on {pipe.device}, but device={device!r} was asked")
    original = Image.open(image_path).convert("RGB")
    mask = Image.open(mask_path).convert("RGB")
    words = read_words(words_path)
    font = load_font(font_path, 40 if len(words) > 1 else 60)

    combined, combined_mask, crop_fn, rendered = render_conditioning(original, mask, words, font)

    # snap to //32 like the reference
    w, h = combined.size
    new_w, new_h = snap_to_multiple(w, h)
    combined = combined.resize((new_w, new_h))
    combined_mask = combined_mask.resize((new_w, new_h))

    prompt, prompt_2 = build_prompts(words)
    text_embeds = None
    if pipe.flux is None and hasattr(pipe, "_deferred_flux"):
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
    return result, crop_fn(result), rendered, original, mask


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
    p.add_argument("--guidance-scale", type=float, default=30.0)
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
    from textflux_torch.pipeline.fill import FillPipeline

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
