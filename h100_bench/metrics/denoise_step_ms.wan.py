"""denoise_step_ms.wan: the mean of the CUDA-event spans around each call of
``WanVACEPipeline._denoise_step`` over the window (the prompt's and the
negative's DiT forward, the guidance and the Euler step), in ms.

The driver keeps these numbers under the keys the Qwen-Image cell's reader
reads, so the reader is that one (``denoise_step_ms.qwen.py``), loaded, not copied."""

import os

from h100_bench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "denoise_step_ms.qwen.py"),
                   "h100_bench_metric_denoise_step_ms_qwen").read
