"""Experiment tracking, profiling and the port's spans: the port of
``textflux_tpu/utils/tracking.py``.

The reference logs {loss, lr} per step to wandb (mirrored to SwanLab,
scripts/train.py:32-33,1089-1091) and has no first-party profiler. Here: a
tracker that always writes JSONL and forwards to wandb when it is installed
and asked for; ``span``, the one way the program marks a region of its host
work; and ``profile_trace`` in place of ``jax.profiler``, which writes a
Chrome trace (open it in chrome://tracing or Perfetto) in which every span
is a named range. The JAX module's ``enable_compilation_cache`` is a
persistent XLA compilation cache, which has no counterpart here (the port
compiles its CUDA kernels once into ``build/``), so it is not ported.

Spans. ``with span(name, **attrs):`` costs one flag test while tracing is
off (the default): it returns one shared object that does nothing. After
``enable(True)`` each span keeps a ``SpanRecord`` in a bounded in-process
buffer, stamped with ``time.time_ns()`` (the clock of the profiler's own
events), with the span open around it as its parent and the id of the
outermost open span as its request. ``drain()`` hands the records over.
Nothing is written to disk. Spans nest per thread: one opened on another
thread (the autograd engine's, which on CUDA runs a remat recompute) is a
root of its own. Only while ``profile_trace`` runs does a span also open
``torch.profiler.record_function``, whose cost is microseconds a span.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

CAPACITY = 200_000   # records kept before the oldest are dropped (~57 edited images)


class SpanRecord(NamedTuple):
    """One closed span. `parent` is the id of the span that was open
    around it (None for a root); `request` is its root's id, shared by
    every span under that root. Times are ``time.time_ns()``."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: int
    attrs: dict


class _Off:
    """What ``span`` returns while tracing is off: one object, no state."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
_on = False             # spans record
_annotate = False       # spans also open record_function (profile_trace)
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()         # the buffer and its count of drops change together
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = [0]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns", "_range", "_stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = self._stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self._range = None
        if _annotate:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._stack.pop()
        record = SpanRecord(self.id, self.name, self.start_ns, end_ns, self.parent,
                            self.request, self.attrs)
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                _dropped[0] += 1
            _buffer.append(record)
        return False


def span(name: str, **attrs):
    """A context manager marking the block as the span `name`, with
    `attrs` kept on its record; ``as s`` gives an object whose
    ``s.set(**attrs)`` adds attributes before it closes. Free while
    tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def enable(on: bool = True, *, capacity: Optional[int] = None) -> bool:
    """Turn span recording on or off; returns whether it was on. A new
    `capacity` empties the buffer."""
    global _on, _buffer
    was, _on = _on, bool(on)
    if capacity is not None:
        with _lock:
            _buffer = collections.deque(maxlen=int(capacity))
            _dropped[0] = 0
    return was


def drain() -> List[SpanRecord]:
    """The records kept so far, in the order the spans closed (a child
    before its parent); the buffer and its count of drops start again."""
    with _lock:
        out = list(_buffer)
        _buffer.clear()
        _dropped[0] = 0
    return out


def dropped() -> int:
    """Records dropped, the oldest first, since the last ``drain``
    because the buffer was full."""
    return _dropped[0]


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
    ``torch.profiler`` while the block runs (``as prof`` gives the
    profiler); on exit the trace is written to
    ``<log_dir>/trace_<pid>_<time>.json`` (Chrome trace format). Spans
    record and show in the trace as named ranges while it runs; both flags
    are restored on exit, and the records stay until drained."""
    global _on, _annotate
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    flags = _on, _annotate
    prof.start()
    _on = _annotate = True
    try:
        yield prof
    finally:
        _on, _annotate = flags
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))
