"""idle_share.wan: 1 - the device's busy time over the wall time of the
profiled clip, in %.

``drivers/serve_wan_closed_loop.py`` reduces its trace as the FLUX cell does (``busy_s``,
``window_s``), so the reader is that one (``idle_share.serve.py``), loaded,
not copied."""

import os

from h100_bench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "idle_share.serve.py"),
                   "h100_bench_metric_idle_share_serve").read
