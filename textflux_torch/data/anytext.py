"""AnyText-format data utilities: the port of ``textflux_tpu/data/anytext.py``
(parity with the reference's eval/dataset_util.py and the T3DataSet
filtering in eval/t3_dataset.py).

Schema: {"data_list": [{"img_name": str, "annotations": [{"text": str,
"polygon": [[x, y], ...], "valid"?: bool}], ...}]}
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


def load_anytext_json(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def save_anytext_json(data: Dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)


def filter_items(
    data: Dict,
    *,
    require_text: bool = True,
    require_polygon: bool = True,
    exclude_invalid: bool = True,
    max_items: Optional[int] = None,
) -> List[Dict]:
    """Valid items with cleaned annotation lists (drops empty and
    watermark-flagged annotations, as the reference's eval filtering does)."""
    out = []
    for item in data.get("data_list", []):
        anns = []
        for ann in item.get("annotations", []):
            if require_text and not ann.get("text"):
                continue
            if require_polygon and not ann.get("polygon"):
                continue
            if exclude_invalid and ann.get("valid") is False:
                continue
            anns.append(ann)
        if anns:
            out.append({**item, "annotations": anns})
        if max_items and len(out) >= max_items:
            break
    return out
