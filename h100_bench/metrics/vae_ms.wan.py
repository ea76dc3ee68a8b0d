"""vae_ms.wan: the CUDA-event spans around ``WanVACEPipeline._prepare_video``
(the two clip encodes, inactive and reactive, and the mask's channels) and
``WanVACEPipeline._decode`` (the clip decode), summed per clip, in ms.

The driver keeps these numbers under the keys the Qwen-Image cell's reader
reads, so the reader is that one (``vae_ms.qwen.py``), loaded, not copied."""

import os

from h100_bench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "vae_ms.qwen.py"),
                   "h100_bench_metric_vae_ms_qwen").read
