"""OCR metric harness (the reference's eval/eval_dgocr.py).

The port of ``textflux_tpu/cli/eval_ocr.py``. For every ground-truth item:
load the generated scene image, crop+rectify the annotated polygon region,
run a recognizer, and score SeqAcc / NED.

The recognizer is pluggable (`--recognizer pkg.module:callable`, mapping a
(H, W, 3) uint8 crop -> str). The reference's modelscope ConvNeXt OCR is a
download; any recognizer with this protocol slots in, including
``textflux_torch.evaluation.ppocr:recognize`` once PP-OCRv3 weights are
provided locally (``PPOCR_CKPT`` / ``PPOCR_DICT``; on CUDA unless
``PPOCR_DEVICE=cpu``).

Usage:
  python -m textflux_torch.cli.eval_ocr \
      --images-dir out/cropped_images --json-path gt.json \
      --recognizer mypkg.ocr:recognize [--charset keys.txt] [--report report.json] \
      [--all-regions]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os

import numpy as np
from PIL import Image

from textflux_torch.evaluation.crop import crop_polygon_region
from textflux_torch.evaluation.metrics import evaluate_texts


def load_recognizer(spec: str):
    module_name, _, attr = spec.partition(":")
    module = importlib.import_module(module_name)
    return getattr(module, attr or "recognize")


def load_charset(path: str) -> dict:
    """ppocr_keys-format dict (one char per line) -> char2id mapping for the
    reference's char-ID NED protocol (eval_dgocr.py:291-293)."""
    with open(path, encoding="utf-8") as f:
        chars = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    return {c: i for i, c in enumerate(chars)}


def evaluate_directory(images_dir: str, json_path: str, recognizer,
                       char2id=None, all_regions: bool = False) -> dict:
    """Score generated images against gt annotations. Default: first
    annotation per item (the reference's single-line editing protocol,
    eval_dgocr.py). all_regions=True scores EVERY annotated region — the
    multi-line protocol (`run_eval --multiline` writes all regions)."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)

    preds, gts, skipped = [], [], 0
    for item in data.get("data_list", []):
        anns = [a for a in (item.get("annotations") or [])
                if a.get("text") and a.get("polygon")]
        if not anns:
            continue
        if not all_regions:
            anns = anns[:1]
        img_path = os.path.join(images_dir, item["img_name"])
        if not os.path.exists(img_path):
            # run_eval flattens subdirectory img_names (run_eval.safe_name)
            from textflux_torch.cli.run_eval import safe_name

            img_path = os.path.join(images_dir, safe_name(item["img_name"]))
        if not os.path.exists(img_path):
            skipped += 1
            continue
        image = np.asarray(Image.open(img_path).convert("RGB"))
        for ann in anns:
            try:
                crop = crop_polygon_region(image, ann["polygon"])
                preds.append(str(recognizer(crop)).strip())
            except Exception:
                preds.append("")
            gts.append(ann["text"].strip())

    metrics = evaluate_texts(preds, gts, char2id)
    metrics["skipped"] = skipped
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser(description="textflux OCR metrics (SeqAcc/NED)")
    p.add_argument("--images-dir", required=True)
    p.add_argument("--json-path", required=True)
    p.add_argument("--recognizer", required=True,
                   help="dotted path module:callable mapping crop->text")
    p.add_argument("--charset", default=None,
                   help="recognizer char-dict txt (ppocr_keys format): NED "
                        "then runs over char IDs with OOV collapsed, the "
                        "reference protocol (eval_dgocr.py:291-293)")
    p.add_argument("--report", default=None)
    p.add_argument("--all-regions", action="store_true",
                   help="score every annotated region per item (multi-line "
                        "protocol); default scores the first only")
    args = p.parse_args(argv)

    recognizer = load_recognizer(args.recognizer)
    char2id = load_charset(args.charset) if args.charset else None
    metrics = evaluate_directory(args.images_dir, args.json_path, recognizer,
                                 char2id, all_regions=args.all_regions)
    print(json.dumps(metrics, ensure_ascii=False))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(metrics, f, ensure_ascii=False, indent=2)


if __name__ == "__main__":
    main()
