"""TextFlux prompt templates.

Two-template scheme (the reference's run_inference.py:27-40,102-103):
the *generic* template (no word list) goes to CLIP (`prompt`), the *word-list*
template goes to T5 (`prompt_2`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def read_words(text_or_path: str) -> List[str]:
    """Read non-empty lines from a file path or a raw newline-separated string."""
    import os

    if isinstance(text_or_path, str) and os.path.exists(text_or_path):
        with open(text_or_path, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]
    return [line.strip() for line in text_or_path.splitlines() if line.strip()]
