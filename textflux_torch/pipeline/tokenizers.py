"""Tokenizer loading (host side).

The port of ``textflux_tpu/pipeline/tokenizers.py``: tokenization is
delegated to Hugging Face ``transformers`` tokenizers read from the local
checkpoint directory (tokenizer/ = CLIP BPE, tokenizer_2/ = T5
SentencePiece), with no network access. ``transformers`` is imported inside
``load_tokenizers`` only, so the rest of the port never needs it.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np


def load_tokenizers(
    base_path: str,
    *,
    max_clip_length: int = 77,
    max_t5_length: int = 512,
) -> Tuple[Callable[[str], np.ndarray], Callable[[str], np.ndarray]]:
    """Returns (clip_tokenize, t5_tokenize): str -> (1, L) int32 id arrays,
    padded to and truncated at the maximum length."""
    from transformers import AutoTokenizer

    clip_tok = AutoTokenizer.from_pretrained(
        os.path.join(base_path, "tokenizer"), local_files_only=True)
    t5_tok = AutoTokenizer.from_pretrained(
        os.path.join(base_path, "tokenizer_2"), local_files_only=True)

    def clip_tokenize(prompt: str) -> np.ndarray:
        out = clip_tok(prompt, padding="max_length", max_length=max_clip_length,
                       truncation=True, return_tensors="np")
        return out["input_ids"].astype(np.int32)

    def t5_tokenize(prompt: str) -> np.ndarray:
        out = t5_tok(prompt, padding="max_length", max_length=max_t5_length,
                     truncation=True, return_length=False, return_tensors="np")
        return out["input_ids"].astype(np.int32)

    return clip_tokenize, t5_tokenize
