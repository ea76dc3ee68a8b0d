"""mfu.wan: the model FLOPs of every clip of the window
(``flops_wan.edit_clip``: UMT5 over both prompts, two clip encodes, 30 steps
of two DiT forwards, the decode) over the clips' wall time on the host's
clock, over the configuration's peak, in %. The profiled clip is left out.

The driver keeps these numbers under the keys the Qwen-Image cell's reader
reads, so the reader is that one (``mfu.qwen.py``), loaded, not copied."""

import os

from h100_bench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "mfu.qwen.py"),
                   "h100_bench_metric_mfu_qwen").read
