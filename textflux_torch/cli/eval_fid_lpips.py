"""FID / LPIPS harness (the reference's eval/eval_fid_lpips.py).

The port of ``textflux_tpu/cli/eval_fid_lpips.py``: filename-matched
pairing between the ground-truth and generated directories, FID over a
pluggable feature extractor, LPIPS over the AlexNet port with a locally
provided weights file, and a tee-style logger. The networks run on CUDA
unless ``--device cpu``, in true float32.

Usage:
  python -m textflux_torch.cli.eval_fid_lpips \
      --gt-dir gt/ --gen-dir out/cropped_images --log-dir eval_log \
      [--inception-weights pt_inception.pth] [--lpips-weights lpips_alex.pt]
      [--fid-extractor pkg.module:callable] [--resize 299] [--device cuda|cpu]

--inception-weights points at a locally provided torch InceptionV3 state dict
(torchvision inception_v3 or pytorch_fid's FIDInceptionV3 file) and enables
strict-parity FID through evaluation/inception.py; --fid-extractor remains
the escape hatch for any custom feature extractor.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image


class TeeLogger:
    """Print to stdout and append to a log file (eval_fid_lpips.py:15-37)."""

    def __init__(self, log_path: Optional[str]):
        self.log_path = log_path
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")


def matched_pairs(gt_dir: str, gen_dir: str) -> List[Tuple[str, str]]:
    """Pairs of (gt, gen) paths whose filenames match in both directories."""
    exts = (".png", ".jpg", ".jpeg")
    gt = {f for f in os.listdir(gt_dir) if f.lower().endswith(exts)}
    gen = {f for f in os.listdir(gen_dir) if f.lower().endswith(exts)}
    names = sorted(gt & gen)
    return [(os.path.join(gt_dir, n), os.path.join(gen_dir, n)) for n in names]


def _load(path: str, size: Optional[int] = None) -> np.ndarray:
    """[-1, 1] float HWC. An optional square resize uses the SAME bilinear
    (half-pixel centers, NO antialias) the inception wrapper applies
    in-network, so pre-resizing for batching is numerically identical to
    feeding native-resolution images to pytorch_fid. (PIL's antialiased
    BILINEAR was not, and silently broke FID comparability.)"""
    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, np.float32) / 127.5 - 1.0
    if size and arr.shape[:2] != (size, size):
        import torch
        import torch.nn.functional as F

        x = torch.from_numpy(arr).permute(2, 0, 1)[None]
        arr = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                            antialias=False)[0].permute(1, 2, 0).numpy()
    return arr


def compute_lpips(pairs, lpips_model, batch: int = 8,
                  size: Optional[int] = None) -> float:
    """LPIPS at NATIVE resolution by default — the reference protocol
    (eval/eval_fid_lpips.py loads images without resizing; AlexNet LPIPS is
    strongly scale-dependent). Pairs are grouped by shape for batching."""
    from collections import defaultdict

    from textflux_torch.evaluation.lpips import lpips_distance

    # group by PIL header size only (lazy): decoding every pair up front
    # would hold the whole eval set in host memory before the first batch
    groups = defaultdict(list)
    for g, f in pairs:
        if size:
            key = (size, size)
        else:
            sa, sb = Image.open(g).size, Image.open(f).size
            if sa != sb:
                raise ValueError(f"pair size mismatch: {g} {sa} vs {f} {sb}")
            key = sa
        groups[key].append((g, f))
    vals = []
    for items in groups.values():
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            a = np.stack([_load(g, size) for g, _ in chunk])
            b = np.stack([_load(f, size) for _, f in chunk])
            vals.extend(lpips_distance(lpips_model, a, b).cpu().tolist())
    return float(np.mean(vals))


def compute_fid(pairs, extractor, size: int = 299) -> float:
    from textflux_torch.evaluation.fid import fid_from_images

    real = (_load(g, size) for g, _ in pairs)
    fake = (_load(f, size) for _, f in pairs)
    return fid_from_images(real, fake, extractor)


def main(argv=None):
    p = argparse.ArgumentParser(description="textflux FID/LPIPS harness (PyTorch)")
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--gen-dir", required=True)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--inception-weights", default=None,
                   help="torch InceptionV3 state dict (.pth) for strict FID")
    p.add_argument("--fid-extractor", default=None,
                   help="module:callable mapping (N,H,W,3) [-1,1] -> (N,D) features")
    p.add_argument("--lpips-weights", default=None,
                   help="torch lpips.LPIPS(net='alex') state dict (.pt)")
    p.add_argument("--resize", type=int, default=299,
                   help="FID pre-resize for batching; uses the network's own "
                        "non-antialiased bilinear, so 299 (default) is "
                        "numerically identical to pytorch_fid's in-network "
                        "resize of native images. LPIPS always runs at "
                        "native resolution (the reference protocol).")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    log = TeeLogger(os.path.join(args.log_dir, f"eval_{int(time.time())}.log")
                    if args.log_dir else None)
    pairs = matched_pairs(args.gt_dir, args.gen_dir)
    log(f"matched pairs: {len(pairs)}")
    if not pairs:
        sys.exit("no filename-matched pairs between the two directories")

    results = {"pairs": len(pairs)}
    extractor = None
    if args.inception_weights:
        from textflux_torch.evaluation.inception import load_inception_extractor

        extractor = load_inception_extractor(args.inception_weights, device=args.device)
    elif args.fid_extractor:
        mod, _, attr = args.fid_extractor.partition(":")
        extractor = getattr(importlib.import_module(mod), attr or "extract")
    if extractor is not None:
        results["fid"] = compute_fid(pairs, extractor, args.resize)
        log(f"FID: {results['fid']:.4f}")
    if args.lpips_weights:
        from textflux_torch.evaluation.lpips import load_lpips

        results["lpips"] = compute_lpips(pairs, load_lpips(args.lpips_weights,
                                                           device=args.device))
        log(f"LPIPS: {results['lpips']:.4f}")
    log(json.dumps(results))


if __name__ == "__main__":
    main()
