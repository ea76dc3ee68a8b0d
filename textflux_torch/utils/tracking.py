"""Experiment tracking and profiling: the port of
``textflux_tpu/utils/tracking.py``.

The reference logs {loss, lr} per step to wandb (mirrored to SwanLab,
scripts/train.py:32-33,1089-1091) and has no first-party profiler. Here: a
tracker that always writes JSONL and forwards to wandb when it is installed
and asked for, and ``torch.profiler`` helpers in place of ``jax.profiler``:
``profile_trace`` writes a Chrome trace (open it in chrome://tracing or
Perfetto), ``annotate`` names a region in it. The JAX module's
``enable_compilation_cache`` is a persistent XLA compilation cache, which has
no counterpart here (the port compiles its CUDA kernels once into
``build/``), so it is not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class Tracker:
    """JSONL-first metric tracker with optional wandb forwarding."""

    def __init__(self, log_dir: str, *, use_wandb: bool = False,
                 config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project="textflux-torch", config=config or {})
            except Exception as e:  # wandb is optional: log to JSONL only
                print(f"wandb unavailable ({e}); logging to JSONL only")

    def log(self, metrics: Dict, step: int) -> None:
        entry = {"step": step, "time": time.time(),
                 **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the host and, where there is one, the CUDA device with
    ``torch.profiler`` while the block runs; on exit the trace is written to
    ``<log_dir>/trace_<pid>_<time>.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield
