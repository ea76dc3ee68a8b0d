"""The single-line edit request as the published inference script builds it.

From the scene, its mask and its words: the T5 and CLIP prompts, the byte
token ids that stand in for the tokenizers (the repository ships no
tokenizer files), and the conditioning canvas: a white-on-black glyph strip
of height 0.15625 x the scene's width stacked above the scene, the mask
black over the strip, both resized to multiples of 32, then the model's
NHWC float inputs. A frozen copy of what the program derives, so that the
reference never takes it from the program.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw, ImageFont

STRIP_RATIO = 0.15625
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FONT_CANDIDATES = (os.path.join(ROOT, "resource", "font", "Arial-Unicode-Regular.ttf"),
                   "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
CLIP_TEMPLATE = (
    "The pair of images highlights some white words on a black background, "
    "as well as their style on a real-world scene image. "
    "[IMAGE1] is a template image rendering the text, with the words; "
    "[IMAGE2] shows the text content naturally and correspondingly integrated into the image.")
T5_TEMPLATE = (
    "The pair of images highlights some white words on a black background, "
    "as well as their style on a real-world scene image. "
    "[IMAGE1] is a template image rendering the text, with the words {words}; "
    "[IMAGE2] shows the text content {words} naturally and correspondingly integrated "
    "into the image.")


def prompts(words):
    """(CLIP prompt, T5 prompt)."""
    return CLIP_TEMPLATE, T5_TEMPLATE.format(words=", ".join(f"'{w}'" for w in words))


def clip_ids(prompt: str, length: int = 77, vocab: int = 49408) -> np.ndarray:
    """BOS, the prompt's UTF-8 bytes, EOS, then EOS padding: (1, 77) int64."""
    body = list(prompt.encode("utf-8")[: length - 2])
    return np.asarray([vocab - 2] + body + [vocab - 1] * (length - 1 - len(body)),
                      np.int64)[None]


def t5_ids(prompt: str, length: int = 512) -> np.ndarray:
    """The prompt's UTF-8 bytes + 3, EOS (1), padding (0) to 512: (1, 512) int64."""
    body = [x + 3 for x in prompt.encode("utf-8")[: length - 1]]
    return np.asarray(body + [1] + [0] * (length - 1 - len(body)), np.int64)[None]


def load_font(size: int):
    for cand in FONT_CANDIDATES:
        if os.path.exists(cand):
            return ImageFont.truetype(cand, size)
    return ImageFont.load_default()


def glyph_strip(text: str, width: int, height: int) -> Image.Image:
    """The text centred on a black strip, sized from a 50-pt probe to fill
    90% of it, at most 140 pt (200 above 1280 px wide), at least 10."""
    font = load_font(60)
    img = Image.new("RGB", (width, height), "black")
    if not text.strip():
        return img
    cap = 200 if width > 1280 else 140
    left, top, right, bottom = font.font_variant(size=50).getbbox(text)
    ratio = min(width * 0.9 / max(right - left, 1), height * 0.9 / max(bottom - top, 1))
    size = max(min(int(50 * ratio), cap), 10)
    ImageDraw.Draw(img).text((width / 2, height / 2), text, font=font.font_variant(size=size),
                             fill="white", anchor="mm")
    return img


def conditioning(scene_path: str, mask_path: str, words):
    """The canvas and its mask as the model takes them: ((1, H, W, 3) in
    [-1, 1], (1, H, W) in {0, 1}) float32 arrays, and (H, W)."""
    scene = Image.open(scene_path).convert("RGB")
    mask = Image.open(mask_path).convert("RGB")
    w, h = scene.size
    strip = glyph_strip(" ".join(words), w, int(w * STRIP_RATIO))
    canvas = Image.fromarray(np.vstack((np.array(strip), np.array(scene))))
    black = np.zeros((strip.size[1], w, 3), np.uint8)
    canvas_mask = Image.fromarray(np.vstack((black, np.array(mask))))
    size = ((w // 32) * 32, ((h + strip.size[1]) // 32) * 32)
    canvas, canvas_mask = canvas.resize(size), canvas_mask.resize(size)
    width, height = (size[0] // 16) * 16, (size[1] // 16) * 16
    img = np.asarray(canvas.resize((width, height), Image.LANCZOS)
                     if canvas.size != (width, height) else canvas, np.float32) / 255.0
    m = canvas_mask.convert("L")
    m = np.asarray(m.resize((width, height), Image.LANCZOS)
                   if m.size != (width, height) else m, np.float32) / 255.0
    return (img * 2.0 - 1.0)[None], (m >= 0.5).astype(np.float32)[None], (height, width)


def to_uint8(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) floats in [-1, 1] -> uint8, as the pipeline's output."""
    return (np.clip(images / 2.0 + 0.5, 0.0, 1.0) * 255).round().astype(np.uint8)
