"""Glyph rendering (host side): white-on-black text templates for the
spatial-concatenation conditioning.

Behavioral ports of the reference renderers (same geometry math, our code):
  draw_glyph_flexible  — run_inference.py:118-157 (inference caps) and
                         image_datasets/dataset.py:55-101 (dataset caps/clamp)
  draw_glyph_polygon   — run_inference.py:217-328 (draw_glyph2: min-area rect,
                         vertical-text detection, inter-char spacing search,
                         supersample -> rotate -> LANCZOS downsample)
  render_glyph_multi   — run_inference.py:330-376 (contour regions, top-down
                         left-right order, alpha compositing)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

DEFAULT_FONT_CANDIDATES = (
    os.path.join(os.path.dirname(__file__), "..", "..", "resource", "font",
                 "Arial-Unicode-Regular.ttf"),
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
)


def load_font(path: Optional[str] = None, size: int = 60) -> ImageFont.FreeTypeFont:
    if path is not None and not os.path.exists(path):
        # an explicitly requested font silently falling back to DejaVu would
        # train/serve with wrong glyph metrics and no indication anywhere
        raise FileNotFoundError(f"font not found: {path}")
    candidates = ([path] if path else []) + list(DEFAULT_FONT_CANDIDATES)
    for cand in candidates:
        if cand and os.path.exists(cand):
            return ImageFont.truetype(cand, size)
    return ImageFont.load_default()


def _fit_font_size(font, text: str, width: int, height: int, max_font_size: int) -> int:
    """Scale from a 50pt probe so text fits in 90% of the canvas."""
    probe = 50
    try:
        probe_font = font.font_variant(size=probe)
    except Exception:
        probe_font = font
    left, top, right, bottom = probe_font.getbbox(text)
    tw = max(right - left, 1)
    th = max(bottom - top, 1)
    ratio = min(width * 0.9 / tw, height * 0.9 / th)
    return min(int(probe * ratio), max_font_size)


def _draw_centered(font, text: str, width: int, height: int,
                   max_font_size: int, *, mode: str = "RGB") -> Image.Image:
    """Shared probe-fit-draw core of the three strip renderers below: black
    canvas, fitted font size (min 10), centered anchor-mm draw. mode='1'
    gives the hard-binary (no antialiasing) dataset distribution."""
    fill = 1 if mode == "1" else "white"
    img = Image.new(mode, (width, height), 0 if mode == "1" else "black")
    if not text or not text.strip():
        return img
    size = max(_fit_font_size(font, text, width, height, max_font_size), 10)
    try:
        final_font = font.font_variant(size=size)
    except Exception:
        final_font = font
    ImageDraw.Draw(img).text((width / 2, height / 2), text, font=final_font,
                             fill=fill, anchor="mm")
    return img


def _dataset_caps(width: int, max_font_size: int) -> int:
    """The dataset-family font cap steps: 140 -> 180 (>1280) -> 280 (>2048)."""
    if width > 2048:
        return 280
    if width > 1280:
        return 180
    return max_font_size


def draw_glyph_flexible(
    font, text: str, width: int, height: int, max_font_size: int = 140,
) -> Image.Image:
    """Centered single-line glyph on a black strip (inference variant:
    max size bumps to 200 when width > 1280)."""
    if width > 1280:
        max_font_size = 200
    return _draw_centered(font, text, width, height, max_font_size)


def draw_glyph_strip(
    font, text: str, width: int, height: int, max_font_size: int = 140,
) -> Image.Image:
    """Dataset/beta variant: strip height clamps to min(width//6, height) and
    the caps step 140 -> 180 (>1280px) -> 280 (>2048px).

    Renders on a mode-'1' canvas like the reference DATASET renderer
    (image_datasets/dataset.py:62): hard-binary glyph edges, no antialiasing
    — the conditioning pixel distribution the published models trained on.
    (The inference-side strips — run_inference.py:123, demo_beta.py:186 —
    are RGB with antialiasing: draw_glyph_flexible above.)"""
    width = max(width, 1)
    height = min(width // 6, height)
    return _draw_centered(font, text, width, height,
                          _dataset_caps(width, max_font_size),
                          mode="1").convert("RGB")


def draw_glyph_beta(
    font, text: str, width: int, height: int, max_font_size: int = 140,
) -> Image.Image:
    """Beta-demo variant: dataset font caps (140 -> 180 > 1280px -> 280 > 2048px)
    but no strip-height clamp (the caller fixes the height; the reference's
    demo_beta.py:181-224)."""
    return _draw_centered(font, text, width, height,
                          _dataset_caps(width, max_font_size))


def insert_spaces(text: str, num_spaces: int) -> str:
    if len(text) <= 1:
        return text
    return (" " * num_spaces).join(list(text))


def draw_glyph_polygon(
    font,
    text: str,
    polygon: np.ndarray,
    *,
    vert_angle: float = 10.0,
    scale: float = 1.0,
    width: int = 512,
    height: int = 512,
    add_space: bool = True,
    scale_factor: int = 2,
) -> np.ndarray:
    """Render text inside an arbitrary quad region. Returns RGBA (height, width).

    Pipeline: min-area rect -> angle normalization -> vertical-text check ->
    font sizing (with inter-character space search for wide regions) ->
    rotate on a supersampled canvas -> LANCZOS downsample.
    """
    if cv2 is None:
        raise RuntimeError("draw_glyph_polygon requires cv2")
    big_w, big_h = width * scale_factor, height * scale_factor
    big_polygon = np.asarray(polygon, np.float32) * scale_factor * scale
    rect = cv2.minAreaRect(big_polygon)
    box = np.intp(cv2.boxPoints(rect))

    w, h = rect[1]
    angle = rect[2]
    if angle < -45:
        angle += 90
    angle = -angle
    if w < h:
        angle += 90

    vert = False
    if abs(angle) % 90 < vert_angle or (90 - abs(angle) % 90) % 90 < vert_angle:
        box_w = box[:, 0].max() - box[:, 0].min()
        box_h = box[:, 1].max() - box[:, 1].min()
        if box_h >= box_w:
            vert = True
            angle = 0

    canvas = Image.new("RGBA", (big_w, big_h), (0, 0, 0, 0))
    probe_draw = ImageDraw.Draw(Image.new("RGB", canvas.size, "white"))

    _, _, tw, th = probe_draw.textbbox((0, 0), text, font=font)
    text_w = 0 if th == 0 else min(float(w), float(h)) * (tw / th)

    if text_w <= max(w, h):
        if len(text) > 1 and not vert and add_space:
            spaces = 1
            for spaces in range(1, 100):
                _, _, tw2, th2 = probe_draw.textbbox(
                    (0, 0), insert_spaces(text, spaces), font=font)
                if th2 != 0 and min(w, h) * (tw2 / th2) > max(w, h):
                    break
            text = insert_spaces(text, spaces - 1)
        font_size = min(w, h) * 0.80
    else:
        shrink = 0.75 if vert else 0.85
        font_size = (min(w, h) / (text_w / max(w, h)) * shrink) if text_w else min(w, h) * 0.8

    sized = font.font_variant(size=int(max(font_size, 1)))
    left, top, right, bottom = sized.getbbox(text)
    text_width, text_height = right - left, bottom - top

    layer = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
    layer_draw = ImageDraw.Draw(layer)
    cx, cy = rect[0]
    if not vert:
        layer_draw.text((cx - text_width // 2, cy - text_height // 2 - top),
                        text, font=sized, fill=(255, 255, 255, 255))
    else:
        box_w = box[:, 0].max() - box[:, 0].min()
        x = box[:, 0].min() + box_w // 2 - text_height // 2
        y = box[:, 1].min()
        for ch in text:
            layer_draw.text((x, y), ch, font=sized, fill=(255, 255, 255, 255))
            _, _, _, ch_bottom = sized.getbbox(ch)
            y += ch_bottom

    rotated = layer.rotate(angle, expand=True, center=(cx, cy), resample=Image.BICUBIC)
    xo = (canvas.width - rotated.width) // 2
    yo = (canvas.height - rotated.height) // 2
    canvas.paste(rotated, (xo, yo), rotated)
    return np.array(canvas.resize((width, height), Image.Resampling.LANCZOS))


def mask_regions(mask: Image.Image, min_area: int = 50) -> List[np.ndarray]:
    """Connected regions of a binary mask as polygons, sorted top-down then
    left-right."""
    if cv2 is None:
        raise RuntimeError("mask_regions requires cv2")
    mask_np = np.array(mask.convert("L"))
    contours, _ = cv2.findContours(mask_np, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    regions = []
    for cnt in contours:
        x, y, w, h = cv2.boundingRect(cnt)
        if w * h < min_area:
            continue
        regions.append((y, x, cnt))
    regions.sort(key=lambda r: (r[0], r[1]))
    return [cnt.reshape(-1, 2) for _, _, cnt in regions]


def render_glyph_multi(
    original: Image.Image,
    mask: Image.Image,
    texts: Sequence[str],
    font=None,
) -> Image.Image:
    """One rotated glyph per mask region, alpha-composited on black.

    Regions come from the mask's connected components (top-down/left-right);
    when explicit polygons are available (eval items carry them), use
    ``render_glyph_regions`` directly — it cannot mis-order regions."""
    return render_glyph_regions(original.size, mask_regions(mask), texts, font)


def render_glyph_regions(
    size,
    polygons: Sequence[np.ndarray],
    texts: Sequence[str],
    font=None,
) -> Image.Image:
    """Explicit-polygon variant of ``render_glyph_multi``: polygon i gets
    text i, so annotation order is preserved exactly (the mask-derived path
    re-orders by component position)."""
    font = font or load_font(size=40)
    out = Image.new("RGBA", size, (0, 0, 0, 0))
    for polygon, text in zip(polygons, texts):
        text = text.strip()
        if not text:
            continue
        rendered = draw_glyph_polygon(
            font, text, np.asarray(polygon),
            width=size[0], height=size[1],
            scale_factor=1,
        )
        out = Image.alpha_composite(out, Image.fromarray(rendered, "RGBA"))
    return out.convert("RGB")
