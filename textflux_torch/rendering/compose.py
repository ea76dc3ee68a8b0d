"""Spatial-concatenation conditioning composition and result cropping.

Behavioral ports:
  extract_mask            — run_inference.py:186-207 (sketch dict / image diff)
  choose_concat_direction — run_inference.py:378-384
  concat + crops          — run_inference.py:409-467
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

SINGLE_LINE_STRIP_RATIO = 0.15625  # strip height = ratio * image width


def extract_mask(original: Image.Image, drawn, threshold: int = 30) -> Image.Image:
    """Binary RGB mask from a Gradio-style sketch dict or an edited image."""
    if isinstance(drawn, dict):
        if drawn.get("mask") is not None:
            arr = np.array(drawn["mask"]).astype(np.uint8)
            if arr.ndim == 3:
                # only the COLOR channels: averaging an RGBA sketch's opaque
                # alpha (255) into the mean marks the whole canvas as mask
                arr = arr[..., :3].mean(axis=-1).astype(np.uint8) if cv2 is None \
                    else cv2.cvtColor(arr[..., :3], cv2.COLOR_RGB2GRAY)
            binary = np.where(arr > 50, 255, 0).astype(np.uint8)
            return Image.fromarray(binary).convert("RGB")
        drawn = 255 - np.array(drawn["image"]).astype(np.uint8)
    diff = np.abs(np.array(drawn).astype(np.int16) - np.array(original).astype(np.int16))
    binary = (diff.mean(axis=-1) > threshold).astype(np.uint8) * 255
    return Image.fromarray(binary).convert("RGB")


def choose_concat_direction(height: int, width: int) -> str:
    return "horizontal" if height > width else "vertical"


def concat_multiline(
    original: Image.Image,
    mask: Image.Image,
    rendered: Image.Image,
) -> Tuple[Image.Image, Image.Image, str]:
    """[glyph canvas | scene] (or stacked) with a black mask over the glyph half.
    Returns (combined_image, combined_mask, direction)."""
    w, h = original.size
    direction = choose_concat_direction(h, w)
    black = Image.new("RGB", original.size, (0, 0, 0))
    stack = np.hstack if direction == "horizontal" else np.vstack
    combined = Image.fromarray(stack((np.array(rendered), np.array(original))))
    combined_mask = Image.fromarray(stack((np.array(black), np.array(mask.convert("RGB")))))
    return combined, combined_mask, direction


def concat_singleline(
    original: Image.Image,
    mask: Image.Image,
    strip: Image.Image,
) -> Tuple[Image.Image, Image.Image, int]:
    """[glyph strip / scene] vertical stack. Returns (image, mask, strip_height)."""
    strip_rgb = strip.convert("RGB")
    black = Image.new("RGB", strip_rgb.size, "black")
    combined = Image.fromarray(np.vstack((np.array(strip_rgb), np.array(original))))
    combined_mask = Image.fromarray(np.vstack((np.array(black), np.array(mask.convert("RGB")))))
    return combined, combined_mask, strip_rgb.size[1]


def crop_multiline_result(result: Image.Image, direction: str) -> Image.Image:
    w, h = result.size
    if direction == "horizontal":
        return result.crop((w // 2, 0, w, h))
    return result.crop((0, h // 2, w, h))


def crop_singleline_result(result: Image.Image, orig_height: int, strip_height: int) -> Image.Image:
    """Proportional crop: the generated canvas was resized, so the strip's share
    of the output height scales accordingly (run_inference.py:459-464)."""
    w, h = result.size
    top = int(h * (strip_height / (orig_height + strip_height)))
    return result.crop((0, top, w, h))
