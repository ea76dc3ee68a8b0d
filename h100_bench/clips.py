"""The generator of clip edit requests: a mix's parameters and a seed in, the
request's files out.

A clip mix (``mixes/<name>.json`` with ``frames`` and ``sizes``) fixes the
shapes: the frame count, a cycle of frame sizes, how many words a request
renders and how long they are. The seed fixes only the content: a smooth
scene (a coarse random grid blown up, with fine grain on top) larger than
the frame, panned across it by a seeded whole number of pixels a frame in
a seeded direction; a box mask, the same in every frame; the words; the
request's noise seed. Request i has the cycle's size i mod len(cycle). A
request is written as the CLI takes a clip: a directory of numbered PNG
frames, one mask PNG and a words file.
"""

from __future__ import annotations

import os
import string
from typing import List

import numpy as np
from PIL import Image

from h100_bench.requests import Request

LETTERS = string.ascii_letters


def clip_size(mix: dict, index: int):
    """(width, height) of request `index`'s frames."""
    w, h = mix["sizes"][index % len(mix["sizes"])]
    return int(w), int(h)


def make_clip_request(mix: dict, seed: int, index: int, folder: str) -> Request:
    """Request `index` of the clip mix under `seed`, written to `folder`."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), index, 7])
    w, h = clip_size(mix, index)
    frames = mix["frames"]
    step = int(rng.integers(mix["pan_px"][0], mix["pan_px"][1] + 1))
    angle = rng.uniform(0, 2 * np.pi)
    dx, dy = step * np.cos(angle), step * np.sin(angle)
    margin = int(np.ceil(step * (frames - 1))) + 1
    big_w, big_h = w + 2 * margin, h + 2 * margin
    coarse = rng.uniform(0, 255, size=(6, 8, 3)).astype(np.uint8)
    scene = np.asarray(Image.fromarray(coarse).resize((big_w, big_h), Image.BICUBIC), np.float32)
    scene = np.clip(scene + rng.normal(0, 6, size=scene.shape), 0, 255).astype(np.uint8)
    clip_dir = os.path.join(folder, f"clip_{index:04d}")
    os.makedirs(clip_dir, exist_ok=True)
    for t in range(frames):
        x0 = margin + int(round(dx * t))
        y0 = margin + int(round(dy * t))
        Image.fromarray(scene[y0:y0 + h, x0:x0 + w]).save(os.path.join(clip_dir, f"{t:04d}.png"))
    lo, hi = mix["mask_fraction"]
    mw, mh = int(rng.uniform(lo, hi) * w), int(rng.uniform(lo, hi) * h)
    mx, my = int(rng.integers(0, w - mw + 1)), int(rng.integers(0, h - mh + 1))
    mask = np.zeros((h, w, 3), np.uint8)
    mask[my:my + mh, mx:mx + mw] = 255
    mask_path = os.path.join(folder, f"mask_{index:04d}.png")
    Image.fromarray(mask).save(mask_path)
    n_words = int(rng.integers(mix["words"][0], mix["words"][1] + 1))
    words = tuple("".join(rng.choice(list(LETTERS), size=int(rng.integers(
        mix["word_letters"][0], mix["word_letters"][1] + 1)))) for _ in range(n_words))
    words_path = os.path.join(folder, f"words_{index:04d}.txt")
    with open(words_path, "w", encoding="utf-8") as f:
        f.write(" ".join(words) + "\n")
    return Request(clip_dir, mask_path, words_path, words=(" ".join(words),),
                   noise_seed=int(rng.integers(0, 2 ** 31)), size=(w, h))


def make_clip_pool(mix: dict, seed: int, folder: str) -> List[Request]:
    os.makedirs(folder, exist_ok=True)
    return [make_clip_request(mix, seed, i, folder) for i in range(mix["pool"])]


def frame_files(clip_dir: str) -> List[str]:
    """A clip directory's frames in order."""
    return [os.path.join(clip_dir, n) for n in sorted(os.listdir(clip_dir)) if n.endswith(".png")]
