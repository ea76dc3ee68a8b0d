"""SHA-256 digests of the self-attention launches' outputs, for holding a
build's attention kernels bitwise to another's on the same card.

    python3 tools/attention_digests.py [--root DIR]

Imports ``textflux_torch`` from DIR (default: this checkout), builds its
kernels, runs each case on numpy-drawn inputs (the same bits wherever torch
runs) and prints one JSON line: the card's name and {case: digest}. The
cases are the launches that go through the forward mainloop with keys of
the queries' own length: the fused norm + RoPE attention at FLUX's joint
length and at Qwen-Image's with device key lengths, and the training
forward's O and L. ``tests/test_wan_vace_cuda.py`` holds the digests.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np


def _t(torch, rng, shape, scale=1.0, dtype="bfloat16"):
    x = (rng.standard_normal(shape, dtype=np.float32) * scale)
    return torch.as_tensor(x).to(getattr(torch, dtype)).cuda()


def digests(torch, FA, rope_tables_half, rope_ids) -> dict:
    """{case: sha256 of the outputs' bytes}."""
    rng = np.random.default_rng(20260)
    out = {}

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    for name, (b, s, h, grid, lens) in {
            "fused_flux_1664": (1, 1664, 24, (32, 44), None),
            "fused_qwen_kv_lens": (2, 4608, 24, (64, 64), (4096 + 300, 4096 + 511))}.items():
        ids = rope_ids(grid, s)
        cos, sin = (torch.as_tensor(t).cuda() for t in rope_tables_half(ids, (16, 56, 56)))
        q, k, v = (_t(torch, rng, (b, s, h, 128)) for _ in range(3))
        qs, ks = (torch.as_tensor(1 + 0.1 * rng.standard_normal((s, 128), dtype=np.float32))
                  .cuda() for _ in range(2))
        kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        o = FA.flash_attention_qk_norm_rope(q, k, v, cos, sin, qs, ks, kv_len=kv)
        out[name] = digest(o)
    q, k, v = (_t(torch, rng, (1, 4224, 24, 128)) for _ in range(3))
    o, lse = FA.flash_attention_fwd(q, k, v, kv_len=4100)
    out["flash_fwd_4224"] = digest(o, lse)
    torch.cuda.synchronize()
    return out


def _ids(grid, s):
    """(s, 3) ids: an image grid, then text rows."""
    r, c = np.meshgrid(np.arange(grid[0]), np.arange(grid[1]), indexing="ij")
    img = np.stack([np.zeros_like(r), r, c], -1).reshape(-1, 3)
    txt = np.zeros((s - img.shape[0], 3))
    return np.concatenate([img, txt]).astype(np.float64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.ops.rope import rope_tables_half

    print(json.dumps({"root": args.root, "device": torch.cuda.get_device_name(0),
                      "digests": digests(torch, FA, rope_tables_half, _ids)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
