"""OCR text metrics: SeqAcc (exact match) and NED (the port of
``textflux_tpu/evaluation/metrics.py``, pure Python as there).

Definitions match the reference harness (eval/eval_dgocr.py:194-196,291-295):
  SeqAcc = mean(pred == gt)                      (raw strings)
  NED    = mean(1 - levenshtein(seq(pred), seq(gt)) / (maxlen + 1e-5))
where seq() maps characters to recognizer-dictionary IDs with every
out-of-dictionary character collapsed onto the LAST dict id (the reference's
char2id.get(m, len(chars)-1)). Without a char2id, raw characters compare
directly — identical except on OOV-containing text.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance, O(len(a) * len(b)) single-row DP."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def normalized_edit_distance(pred: str, gt: str,
                             char2id: Optional[Mapping[str, int]] = None) -> float:
    if char2id is not None:
        oov = len(char2id) - 1   # reference: char2id.get(m, len(chars)-1)
        pred = tuple(char2id.get(c, oov) for c in pred)
        gt = tuple(char2id.get(c, oov) for c in gt)
    if not pred and not gt:
        return 1.0
    # the +1e-5 denominator is the reference's get_ld (eval_dgocr.py:194-196)
    return 1.0 - levenshtein(pred, gt) / (max(len(pred), len(gt)) + 1e-5)


def sequence_accuracy(pred: str, gt: str) -> float:
    return float(pred == gt)


def evaluate_texts(preds: Sequence[str], gts: Sequence[str],
                   char2id: Optional[Mapping[str, int]] = None) -> Dict[str, float]:
    """Corpus-level SeqAcc / NED over aligned prediction/ground-truth pairs.
    char2id: recognizer dictionary for the reference's char-ID NED protocol."""
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions vs {len(gts)} ground truths")
    if not preds:
        return {"seq_acc": 0.0, "ned": 0.0, "count": 0}
    seq = sum(sequence_accuracy(p, g) for p, g in zip(preds, gts))
    ned = sum(normalized_edit_distance(p, g, char2id) for p, g in zip(preds, gts))
    n = len(preds)
    return {"seq_acc": seq / n, "ned": ned / n, "count": n}
