"""Seeded weights, made on the device in bf16, one draw per group of leaves.

Both sides take the same values: the program gets them as its modules'
parameters (``state_dict``), the reference draws them again from the seed
after the program is gone and widens them to float32. A group is a block of
a stack (``double_blocks.3``, ``layers.11``) or the rest of a model; each
group is one ``uniform_`` draw from a generator seeded by (seed, model,
group), then each leaf is its slice scaled in one kernel:

* a linear or convolution weight: U(-1, 1) / sqrt(fan_in), PyTorch's
  default bound;
* a bias: U(-1, 1) * 0.05;
* a norm's scale: 1 + 0.1 U(-1, 1);
* the embeddings: T5's U(-1, 1), CLIP's token and position tables and T5's
  relative-position bias U(-1, 1) * 0.035 (about 0.02 standard deviation).
"""

from __future__ import annotations

import math
import zlib
from collections import OrderedDict

import torch

STACKS = ("double_blocks", "single_blocks", "layers")
EMBEDDINGS = {"embedding": 1.0, "token_embedding": 0.035, "position_embedding": 0.035,
              "rel_bias": 0.035}


def leaf_rule(name: str, shape) -> tuple:
    """(mul, add): the leaf is U(-1, 1) * mul + add."""
    last = name.rsplit(".", 1)[-1]
    if last in EMBEDDINGS:
        return EMBEDDINGS[last], 0.0
    if last == "bias":
        return 0.05, 0.0
    if len(shape) == 1:
        return 0.1, 1.0
    return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0


def groups(model: torch.nn.Module) -> "OrderedDict[str, list]":
    """{group: [(leaf name, shape), ...]} of a (meta) module, names sorted."""
    out = OrderedDict()
    for name, p in sorted(model.named_parameters()):
        parts = name.split(".")
        key = ".".join(parts[:2]) if parts[0] in STACKS else "rest"
        out.setdefault(key, []).append((name, tuple(p.shape)))
    return out


def group_seed(seed: int, model: str, group: str) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32(f"{model}/{group}".encode())) % (2 ** 63)


def draw_group(seed: int, model: str, group: str, leaves, device) -> dict:
    """{leaf name: bf16 tensor} of one group, each leaf its own storage."""
    n = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, model, group))
    u = torch.empty(n, dtype=torch.bfloat16, device=device).uniform_(-1.0, 1.0, generator=gen)
    out, at = {}, 0
    for name, shape in leaves:
        k = math.prod(shape)
        mul, add = leaf_rule(name, shape)
        out[name] = (u[at:at + k].view(shape) * mul + add).contiguous()
        at += k
    return out


def state_dict(seed: int, model: str, spec, device, dtype=torch.bfloat16) -> dict:
    """Every leaf of `model` (its ``groups``) in `dtype`, drawn group by group."""
    sd = {}
    for group, leaves in spec.items():
        for name, t in draw_group(seed, model, group, leaves, device).items():
            sd[name] = t if dtype == torch.bfloat16 else t.to(dtype)
    return sd
