"""Single-image inference: render the glyph conditioning, fill, crop, save.

The port of ``textflux_tpu/cli/run_inference.py`` (``render_conditioning``,
``run``, ``save_results``). Auto-detects single-line (glyph strip stacked
above) vs multi-line (per-region rotated glyphs) conditioning from the word
list and mirrors the reference's //32 snap. The command-line ``main()`` needs
checkpoint loading, which the port does not have yet.
"""

from __future__ import annotations

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
    result = pipe(
        image=combined, mask_image=combined_mask,
        prompt=prompt, prompt_2=prompt_2,
        height=new_h, width=new_w,
        num_inference_steps=steps, guidance_scale=guidance_scale,
        seed=seed, sampler=sampler, overshoot_c=overshoot_c,
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
