"""TextFlux prompt templates.

Two-template scheme (the reference's run_inference.py:27-40,102-103):
the *generic* template (no word list) goes to CLIP (`prompt`), the *word-list*
template goes to T5 (`prompt_2`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

GENERIC_TEMPLATE = (
    "The pair of images highlights some white words on a black background, "
    "as well as their style on a real-world scene image. "
    "[IMAGE1] is a template image rendering the text, with the words; "
    "[IMAGE2] shows the text content naturally and correspondingly integrated into the image."
)

WORDS_TEMPLATE = (
    "The pair of images highlights some white words on a black background, "
    "as well as their style on a real-world scene image. "
    "[IMAGE1] is a template image rendering the text, with the words {words}; "
    "[IMAGE2] shows the text content {words} naturally and correspondingly integrated into the image."
)


def words_prompt(words: Sequence[str]) -> str:
    words_str = ", ".join(f"'{w}'" for w in words)
    return WORDS_TEMPLATE.format(words=words_str)


def build_prompts(words: Sequence[str]) -> Tuple[str, str]:
    """Returns (clip_prompt, t5_prompt)."""
    return GENERIC_TEMPLATE, words_prompt(words)


def find_render_token_windows(tokenize, prompt: str, max_length: int = 512,
                              pad_id: int = 0):
    """Locate the T5 token windows of the quoted render words inside a prompt.

    The port of the reference's get_text_to_render matching (diffusers
    pipeline_flux.py:222-244): the needle is the tokenization of the QUOTED
    span with the first piece (the leading quote) and the last non-pad piece
    (eos) dropped: ids[1:first_pad-1]. Tokenizing the bare word instead
    yields a space-prefixed ("▁word") first piece that never occurs after the
    opening quote in the prompt. Like the reference, an unmatched span
    raises. Falls back to double-quoted spans when no single-quoted ones
    exist, and returns every span's (word, start, end)."""
    import re

    full_ids = [int(t) for t in np.asarray(tokenize(prompt)).ravel()]
    spans = re.findall(r"'[^']*'", prompt) or re.findall(r'"[^"]*"', prompt)
    windows = []
    for span in spans:
        ids = [int(t) for t in np.asarray(tokenize(span)).ravel()]
        end = ids.index(pad_id) if pad_id in ids else len(ids)
        needle = ids[1:end - 1]
        if not needle:
            continue
        n = len(needle)
        for start in range(0, min(len(full_ids), max_length) - n + 1):
            if full_ids[start:start + n] == needle:
                windows.append((span[1:-1], start, start + n))
                break
        else:
            raise ValueError(
                f"no token window found for {span} in the prompt (the "
                "reference raises here too, pipeline_flux.py:243)")
    return windows


def read_words(text_or_path: str) -> List[str]:
    """Read non-empty lines from a file path or a raw newline-separated string."""
    import os

    if isinstance(text_or_path, str) and os.path.exists(text_or_path):
        with open(text_or_path, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]
    return [line.strip() for line in text_or_path.splitlines() if line.strip()]
