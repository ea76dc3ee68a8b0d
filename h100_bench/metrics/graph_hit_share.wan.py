"""graph_hit_share.wan: the DiT's ``ForwardGraphs`` counters over the window,
replays / calls, in %: the share of the window's DiT forwards that replayed
a graph captured before.

The driver keeps these numbers under the keys the Qwen-Image cell's reader
reads, so the reader is that one (``graph_hit_share.qwen.py``), loaded, not copied."""

import os

from h100_bench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_hit_share.qwen.py"),
                   "h100_bench_metric_graph_hit_share_qwen").read
