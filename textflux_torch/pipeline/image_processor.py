"""Host-side image pre/post-processing (VaeImageProcessor equivalent).

Images are NHWC float32 in [-1, 1] on the way in, uint8 PIL on the way out.
The pipelines' canvas (``canvas``) has 16-pixel granularity (vae 8x * patch
2x), mirroring diffusers pipeline_flux_fill.py:1397-1404.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

ImageLike = Union[Image.Image, np.ndarray]
PIXEL_MULTIPLE = 16


def snap_to_multiple(width: int, height: int, multiple: int = 32) -> Tuple[int, int]:
    """The reference snaps inputs to //32 multiples before the pipeline
    (run_inference.py:65-69)."""
    return (width // multiple) * multiple, (height // multiple) * multiple


def to_pil(image: ImageLike) -> Image.Image:
    if isinstance(image, Image.Image):
        return image
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        if arr.min() < -0.05:
            # pipeline outputs (output_type="np") are [-1, 1]; clipping them
            # to [0, 1] would crush the whole negative half to black when an
            # output is fed back in for iterative editing. The -0.05 margin
            # keeps [0, 1]-range images with slight negative ringing (lanczos
            # overshoot from a caller's own resize) on the clip path.
            arr = (arr + 1.0) / 2.0
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    return Image.fromarray(arr)


def preprocess_image(image: ImageLike, height: int, width: int) -> np.ndarray:
    """RGB image -> (1, H, W, 3) float32 in [-1, 1]."""
    pil = to_pil(image).convert("RGB")
    if pil.size != (width, height):
        pil = pil.resize((width, height), Image.LANCZOS)
    arr = np.asarray(pil, dtype=np.float32) / 255.0
    arr = arr * 2.0 - 1.0
    return arr[None]


def preprocess_mask(mask: ImageLike, height: int, width: int, threshold: float = 0.5) -> np.ndarray:
    """Mask image -> (1, H, W) float32 in {0, 1} (grayscale + binarize)."""
    pil = to_pil(mask).convert("L")
    if pil.size != (width, height):
        pil = pil.resize((width, height), Image.LANCZOS)
    arr = np.asarray(pil, dtype=np.float32) / 255.0
    return (arr >= threshold).astype(np.float32)[None]


def canvas(images, masks, height: Optional[int] = None, width: Optional[int] = None, *,
           device, dtype) -> tuple:
    """(image (B, H, W, 3), mask (B, H, W), height, width): `images` and
    `masks` (one each, or sequences of them) at height x width (default:
    the first image's) snapped down to PIXEL_MULTIPLE, on `device` in
    `dtype`."""
    if not isinstance(images, (list, tuple)):
        images, masks = [images], [masks]
    if not (height and width):
        w0, h0 = to_pil(images[0]).size
        width, height = width or w0, height or h0
    width, height = snap_to_multiple(width, height, PIXEL_MULTIPLE)
    img = np.concatenate([preprocess_image(im, height, width) for im in images])
    mask = np.concatenate([preprocess_mask(m, height, width) for m in masks])
    return (torch.as_tensor(img, device=device).to(dtype),
            torch.as_tensor(mask, device=device).to(dtype), height, width)


def postprocess_image(images: np.ndarray) -> list:
    """(B, H, W, 3) float in [-1, 1] -> list of PIL images."""
    arr = np.asarray(images, dtype=np.float32)
    arr = np.clip(arr / 2.0 + 0.5, 0.0, 1.0)
    arr = (arr * 255).round().astype(np.uint8)
    return [Image.fromarray(a) for a in arr]
