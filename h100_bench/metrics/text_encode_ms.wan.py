"""text_encode_ms.wan: the CUDA-event span around
``WanVACEPipeline.encode_prompts`` (UMT5 over the prompt and over the
negative prompt, 512 ids each), per clip, in ms.

The driver keeps these numbers under the keys the Qwen-Image cell's reader
reads, so the reader is that one (``text_encode_ms.qwen.py``), loaded, not copied."""

import os

from h100_bench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "text_encode_ms.qwen.py"),
                   "h100_bench_metric_text_encode_ms_qwen").read
