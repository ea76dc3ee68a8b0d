"""The one generator of edit requests: a mix's parameters and a seed in,
the request files out.

A mix (``mixes/<name>.json``) fixes the shapes: a cycle of scene aspects at
one long side, how many words a request renders and how long they are, the
steps, the guidance and the sampler. The seed fixes only the content: the
scene's pixels, the edit region, the words and each request's own noise
seed. So every seed sends the same sequence of shapes and the same amount of
work. Request i has the cycle's aspect i mod len(cycle); a pool of requests
is written once, before the window, and the window sends pool[i mod pool].
"""

from __future__ import annotations

import dataclasses
import os
import string
from typing import List, Tuple

import numpy as np
from PIL import Image

LETTERS = string.ascii_letters


@dataclasses.dataclass(frozen=True)
class Request:
    scene: str            # file paths, as cli.run_inference.run takes them
    mask: str
    words_file: str
    words: Tuple[str, ...]
    noise_seed: int       # the program's seed for this request's draws
    size: Tuple[int, int]  # the scene's (width, height)


def scene_size(mix: dict, index: int) -> Tuple[int, int]:
    """(width, height) of request `index`: the long side, the other side from
    the cycle's aspect (width:height), a multiple of 16."""
    aw, ah = mix["aspects"][index % len(mix["aspects"])]
    long = mix["long_side"]
    if aw >= ah:
        return long, int(round(long * ah / aw / 16)) * 16
    return int(round(long * aw / ah / 16)) * 16, long


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), index])


def make_request(mix: dict, seed: int, index: int, folder: str) -> Request:
    """Request `index` of the mix under `seed`, its files written to `folder`."""
    rng = _rng(seed, index)
    w, h = scene_size(mix, index)
    # a smooth scene: a coarse random grid blown up, with fine grain on top
    coarse = rng.uniform(0, 255, size=(6, 6, 3)).astype(np.uint8)
    scene = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
    scene = np.clip(scene + rng.normal(0, 6, size=scene.shape), 0, 255).astype(np.uint8)
    lo, hi = mix["mask_fraction"]
    mw, mh = (int(rng.uniform(lo, hi) * w), int(rng.uniform(lo, hi) * h))
    x0, y0 = int(rng.integers(0, w - mw + 1)), int(rng.integers(0, h - mh + 1))
    mask = np.zeros((h, w, 3), np.uint8)
    mask[y0:y0 + mh, x0:x0 + mw] = 255
    n_words = int(rng.integers(mix["words"][0], mix["words"][1] + 1))
    words = tuple("".join(rng.choice(list(LETTERS),
                                     size=int(rng.integers(mix["word_letters"][0],
                                                           mix["word_letters"][1] + 1))))
                  for _ in range(n_words))
    paths = [os.path.join(folder, f"{kind}_{index:04d}.{ext}")
             for kind, ext in (("scene", "png"), ("mask", "png"), ("words", "txt"))]
    Image.fromarray(scene).save(paths[0])
    Image.fromarray(mask).save(paths[1])
    with open(paths[2], "w", encoding="utf-8") as f:
        f.write("\n".join([" ".join(words)]) + "\n")
    return Request(*paths, words=(" ".join(words),),
                   noise_seed=int(rng.integers(0, 2 ** 31)), size=(w, h))


def make_pool(mix: dict, seed: int, folder: str) -> List[Request]:
    os.makedirs(folder, exist_ok=True)
    return [make_request(mix, seed, i, folder) for i in range(mix["pool"])]
