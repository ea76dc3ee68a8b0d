"""Training datasets (host side, numpy outputs).

The port of ``textflux_tpu/data/dataset.py``, behavioural ports of the
reference datasets (image_datasets/dataset.py):

  AnyWordSingleLineDataset — AnyText-format json ({data_list: [{img_name,
    annotations: [{text, polygon}]}]}): per item, one random annotation, glyph
    strip rendered above the scene, rasterized polygon mask with random
    dilate/erode augmentation, random resolution from PREFERRED_RESOLUTIONS,
    //32 snap, pixels in [-1, 1] (dataset.py:139-265).
  CombinedFolderDataset    — pre-concatenated images + mask/<name>_mask.<ext> +
    .txt/.json captions, optional word-template prompt expansion (:269-350).
  UnionDataset             — offset-based concatenation (:353-392).

Samples are NHWC numpy arrays with a (height, width) bucket key, as the JAX
package returns them, so the loader batches per resolution bucket. Every
random draw comes from the dataset's ``random.Random(seed)``, in the JAX
package's order, so the same seed and files give the same samples bitwise.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from textflux_torch.data import native
from textflux_torch.pipeline.prompts import GENERIC_TEMPLATE, words_prompt
from textflux_torch.rendering.glyph import draw_glyph_strip, load_font

PREFERRED_RESOLUTIONS = [672, 688, 720, 752, 800, 832, 880, 944, 1024]


def image_resize(img: Image.Image, max_size: int = 512) -> Image.Image:
    w, h = img.size
    if w >= h:
        return img.resize((max_size, int(max_size / w * h)))
    return img.resize((int(max_size / h * w), max_size))


def _snap32(img: Image.Image) -> Image.Image:
    w, h = img.size
    return img.resize(((w // 32) * 32, (h // 32) * 32))


def _snap_bucket(img: Image.Image, quant: int) -> Image.Image:
    """//32 snap (the reference's sizing) with the SHORT side additionally
    rounded to a multiple of `quant`.

    Arbitrary aspect ratios make the raw (H, W) bucket key high-cardinality,
    so B>1 batches, which must be shape-uniform, form slowly and the loader
    drops most samples on small datasets. quant=32 is exact reference sizing
    (one //32 floor); quant=128 bounds the bucket count to ~5 per
    resolution. The extra aspect distortion is at most quant/2 on the short
    side, and short sides below quant are upscaled TO quant (warned once)."""
    if quant <= 32:
        return _snap32(img)
    w, h = img.size
    if w >= h:
        w2 = (w // 32) * 32
        h2 = max(quant, int(round(h / quant)) * quant)
    else:
        h2 = (h // 32) * 32
        w2 = max(quant, int(round(w / quant)) * quant)
    short, short2 = (h, h2) if w >= h else (w, w2)
    if short2 > short and not _snap_bucket._warned:
        # any upscale of the short side means the trained token grid differs
        # from what the same data yields at quant=32 (a silent stretch the
        # model then trains on); warn on the first rounded-up side
        print(f"WARNING: bucket quant {quant} upscales a {w}x{h} canvas to "
              f"{w2}x{h2} (short side below the quant is stretched TO it); "
              "use --bucket-quant 32 if the serving canvas is this small",
              flush=True)
        _snap_bucket._warned = True
    return img.resize((w2, h2))


_snap_bucket._warned = False


def _augment_mask(mask: np.ndarray, rng: random.Random) -> np.ndarray:
    """Random dilate/erode (70% none / 10% dilate1 / 10% erode1 / 5% dilate2 /
    5% erode2) from one draw, through the native morphology kernels."""
    r = rng.random()
    if r < 0.7:
        return mask
    if r < 0.8:
        return native.dilate(mask, 1)
    if r < 0.9:
        return native.erode(mask, 1)
    if r < 0.95:
        return native.dilate(mask, 2)
    return native.erode(mask, 2)


def _retry(dataset, idx: int) -> dict:
    """dataset._get(idx), retried on a random other index up to 16 times in
    all (a bad file or annotation skips to another sample)."""
    for _ in range(16):
        try:
            return dataset._get(idx)
        except Exception:
            idx = dataset.rng.randrange(len(dataset))
    raise RuntimeError("too many consecutive bad samples")


class AnyWordSingleLineDataset:
    """Single-line (beta) training samples from AnyText-format datasets."""

    def __init__(
        self,
        dataset_paths: Sequence[Tuple[str, str]],
        *,
        resolutions: Sequence[int] = tuple(PREFERRED_RESOLUTIONS),
        max_chars: int = 35,
        font_path: Optional[str] = None,
        seed: int = 0,
        bucket_quant: int = 32,   # see _snap_bucket; raise to 128 for B>1
    ):
        self.resolutions = list(resolutions)
        self.bucket_quant = bucket_quant
        self.max_chars = max_chars
        self.font = load_font(font_path, 60)
        self.rng = random.Random(seed)
        self.items: List[dict] = []
        for json_path, img_root in dataset_paths:
            with open(json_path, encoding="utf-8") as f:
                content = json.load(f)
            for gt in content.get("data_list", []):
                anns = [a for a in gt.get("annotations", [])
                        if a.get("polygon") and a.get("text")]
                if anns:
                    self.items.append({
                        "img_name": gt["img_name"],
                        "annotations": anns,
                        "img_root": img_root,
                    })

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        return _retry(self, idx)

    def _get(self, idx: int) -> dict:
        item = self.items[idx]
        img = Image.open(os.path.join(item["img_root"], item["img_name"])).convert("RGB")
        w, h = img.size
        if w > 5000 or h > 5000:
            raise ValueError("oversized image")

        ann = self.rng.choice(item["annotations"])
        text = ann["text"][: self.max_chars]
        polygon = np.asarray(ann["polygon"], np.int32)
        if polygon.shape[0] < 3 or not text:
            raise ValueError("bad annotation")

        strip = draw_glyph_strip(self.font, text, w, h).convert("RGB")
        mask = np.zeros((h, w), np.uint8)
        native.fill_poly(mask, polygon.astype(np.float32))
        mask = _augment_mask(mask, self.rng)

        combined = Image.fromarray(np.vstack((np.array(strip), np.array(img))))
        combined_mask = Image.fromarray(
            np.vstack((np.zeros((strip.height, w), np.uint8), mask)))

        size = self.rng.choice(self.resolutions)
        combined = _snap_bucket(image_resize(combined, size), self.bucket_quant)
        combined_mask = combined_mask.resize(combined.size)

        pixels = np.asarray(combined, np.float32) / 127.5 - 1.0
        mask_np = np.asarray(combined_mask, np.float32) / 255.0
        return {
            "pixel_values": pixels,                      # (H, W, 3) in [-1, 1]
            "mask": mask_np,                             # (H, W) in [0, 1]
            "prompt": words_prompt([text]),              # T5 prompt
            "clip_prompt": GENERIC_TEMPLATE,
            "bucket": (pixels.shape[0], pixels.shape[1]),
        }


class CombinedFolderDataset:
    """Pre-concatenated multi-line samples: <name>.png + mask/<name>_mask.png +
    <name>.txt|.json caption."""

    def __init__(
        self,
        img_dir: str,
        *,
        img_size=768,
        caption_type: str = "txt",
        expand_prompt: bool = True,
        seed: int = 0,
        bucket_quant: int = 32,   # see _snap_bucket; raise to 128 for B>1
    ):
        self.images = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.endswith((".jpg", ".png")))
        self.img_size = img_size
        self.bucket_quant = bucket_quant
        self.caption_type = caption_type
        self.expand_prompt = expand_prompt
        self.mask_dir = os.path.join(img_dir, "mask")
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> dict:
        return _retry(self, idx)

    def _get(self, idx: int) -> dict:
        path = self.images[idx]
        img = Image.open(path).convert("RGB")
        size = self.rng.choice(self.img_size) if isinstance(self.img_size, (list, tuple)) \
            else self.img_size
        img = _snap_bucket(image_resize(img, size), self.bucket_quant)

        stem, ext = os.path.splitext(os.path.basename(path))
        cap_path = os.path.splitext(path)[0] + "." + self.caption_type
        with open(cap_path) as f:
            prompt = json.load(f)["caption"] if self.caption_type == "json" else f.read()
        if self.expand_prompt:
            words = [line.strip() for line in prompt.splitlines() if line.strip()]
            prompt = words_prompt(words)

        mask_path = os.path.join(self.mask_dir, f"{stem}_mask{ext}")
        mask = Image.open(mask_path).convert("L")
        mask = image_resize(mask, size).resize(img.size)

        pixels = np.asarray(img, np.float32) / 127.5 - 1.0
        return {
            "pixel_values": pixels,
            "mask": np.asarray(mask, np.float32) / 255.0,
            "prompt": prompt,
            "clip_prompt": GENERIC_TEMPLATE,
            "bucket": (pixels.shape[0], pixels.shape[1]),
        }


class UnionDataset:
    """Offset-based union of per-subdirectory CombinedFolderDataset."""

    def __init__(self, img_dir: str, **kwargs):
        self.datasets = []
        for sub in sorted(os.listdir(img_dir)):
            sub_path = os.path.join(img_dir, sub)
            if os.path.isdir(sub_path) and sub != "mask":
                self.datasets.append(CombinedFolderDataset(sub_path, **kwargs))
        self.offsets = [0]
        for d in self.datasets:
            self.offsets.append(self.offsets[-1] + len(d))

    def __len__(self) -> int:
        return self.offsets[-1]

    def __getitem__(self, idx: int) -> dict:
        for i in range(len(self.datasets)):
            if self.offsets[i] <= idx < self.offsets[i + 1]:
                return self.datasets[i][idx - self.offsets[i]]
        raise IndexError(idx)
