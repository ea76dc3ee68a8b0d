"""CUDA graphs of a module's forward, one per input shape.

A serving step of the FLUX DiT is ~3,200 device operations, each a host
launch, and at batch 1 the host takes longer to issue them than the H100
takes to run them. ``ForwardGraphs`` records one forward per key (the
input shapes and dtypes, and whatever else changes what the forward
launches) into a ``torch.cuda.CUDAGraph`` and replays it: a replay is one
host call, plus one copy of the inputs into the graph's static buffers.

A key runs eagerly the first time it is seen (cuBLAS picks and warms its
kernels, the hand-written kernels raise their shared-memory limit once),
is captured and replayed the second time, and is replayed from then on.
The output is cloned out of the graph's static output, so no caller ever
holds memory the next replay overwrites. ``GRAPH_KEYS`` graphs are kept;
the least recently used one is dropped first.

Memory. Every graph captures into one private pool. A capture takes the
blocks the earlier captures freed, so the graphs' activations overlap:
safe because the graphs run one at a time on one stream and each replay
writes its activations before it reads them, and because the static
output is cloned before another graph replays. A freed block serves a
later capture only where that capture's tensor fits in it, so the pool
depends on the order in which shapes arrive: captured from the largest
forward down, it stays as large as the largest forward's activations;
captured from the smallest up, each larger forward takes new blocks for
the temporaries that grow with its tokens. Eight keys up to the demo's
2048 x 1024 canvas (joint 8,704) on an H100: bf16 2.2 GiB largest first,
2.4 GiB smallest first; w8a8, whose float32 and int32 temporaries grow
with the tokens, 4.6 and 7.1 GiB. A key also holds its static output and its
static inputs (those of its shapes; the text and the modulation vectors
are shared by keys of one batch size) beside the pool.

Launch counters. A replay runs its kernels without their Python wrappers,
so each ``<wrapper>.launches`` of ``ops.flash_attention`` counts the host's
launches alone (a key's eager call and its capture). What the device ran,
replays included, is read from ``torch.profiler``'s CUDA activity.

A graph reads the weights at the addresses it was captured with.
``signature`` gives those addresses, and ``run`` drops every graph when
they change (a parameter, buffer or submodule replaced, a LoRA attached,
the module moved).

Not thread-safe: one caller at a time, as the pipelines that call it.
"""

from __future__ import annotations

import collections
import itertools
import weakref
from typing import Callable, List, NamedTuple, Sequence

import torch
from torch import nn

from textflux_torch.utils.tracking import span

# graphs a module keeps: the four canvases a client cycles through, and a
# batched run's full and ragged batches of the bucket at hand, with room;
# Qwen-Image's four canvases with two text buckets each fill it
GRAPH_KEYS = 8

# parameters, buffers and submodules any module has registered (an attribute
# set to one included): ``ForwardGraphs.signature`` lists a module's tensors
# anew when this count has changed
_registrations = [0]


def _registered(*_) -> None:
    _registrations[0] += 1


for _hook in (nn.modules.module.register_module_parameter_registration_hook,
              nn.modules.module.register_module_buffer_registration_hook,
              nn.modules.module.register_module_module_registration_hook):
    _hook(_registered)


def key_of(inputs: Sequence[torch.Tensor], static: dict) -> tuple:
    """The key of a forward on tensors `inputs` and other arguments `static`
    (baked into its launches): each input's (shape, dtype, device), then
    each other argument as ``name=value``."""
    return (tuple((t.shape, t.dtype, t.device) for t in inputs)
            + tuple(f"{k}={v!r}" for k, v in static.items()))


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static: List[torch.Tensor]     # the inputs' static buffers
    out: torch.Tensor              # the static output
    label: str                     # the key, for the span


def _copy_in(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """dst[i] <- src[i], in one multi-tensor copy per dtype."""
    groups = {}
    for d, s in zip(dst, src):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class ForwardGraphs:
    """The CUDA graphs of one module's forward (module docstring).
    ``captures``: calls that captured a graph; ``replays``: calls served
    by one already captured; ``calls``: every call, the eager ones too."""

    def __init__(self):
        self.capacity = GRAPH_KEYS
        self.captures = self.replays = self.calls = 0
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._buffers = {}
        self._signature = None
        self._pool = self._stream = None
        self._tensors, self._listed = [], None   # signature's weak list, and when made

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph, static buffer and key seen (the pool goes with
        the last graph)."""
        self._graphs.clear()
        self._seen.clear()
        self._buffers.clear()
        self._pool = self._stream = None

    def run(self, key: tuple, signature, fn: Callable[[List[torch.Tensor]], torch.Tensor],
            inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``fn(inputs)``: eagerly the first time `key` is seen, else from
        its graph (captured now if it has none). `signature` identifies the
        weights `fn` reads. Keys share the static buffer of an input
        position while its shape and dtype agree."""
        self.calls += 1
        if signature != self._signature:
            self.clear()
            self._signature = signature
        entry = self._graphs.get(key)
        if entry is None and key not in self._seen:
            self._remember(self._seen, key, None)
            return fn(list(inputs))
        if entry is None:
            with span("flux.graph", key=_describe(key), captured=True):
                entry = self._capture(key, fn, inputs)
                self._remember(self._graphs, key, entry)
                # the static buffers of an evicted graph go with it
                live = {id(t) for g in self._graphs.values() for t in g.static}
                self._buffers = {k: b for k, b in self._buffers.items() if id(b) in live}
                self.captures += 1
                return entry.out.clone()
        self._graphs.move_to_end(key)
        with span("flux.graph", key=entry.label, captured=False):
            _copy_in(entry.static, inputs)
            entry.graph.replay()   # on the current stream of the graph's device
            self.replays += 1
            return entry.out.clone()

    def signature(self, module: nn.Module) -> tuple:
        """The address of every parameter and buffer of `module`, in module
        order: what its graphs read. The tensors are held weakly, so that a
        replaced weight is freed at once, and listed anew only after a
        module registered a parameter, buffer or submodule (a linear
        replaced or quantised, a LoRA attached) or a listed one was freed;
        a move in place (``.to``) shows in the addresses."""
        tensors = [r() for r in self._tensors]
        if self._listed != _registrations[0] or any(t is None for t in tensors):
            self._listed = _registrations[0]
            tensors = [t for m in module.modules() for d in (m._parameters, m._buffers)
                       for t in d.values() if t is not None]
            self._tensors = [weakref.ref(t) for t in tensors]
        return tuple(t.data_ptr() for t in tensors)

    def _remember(self, cache: collections.OrderedDict, key, value) -> None:
        cache[key] = value
        cache.move_to_end(key)
        while len(cache) > self.capacity:
            cache.popitem(last=False)

    def _static(self, pos: int, like: torch.Tensor) -> torch.Tensor:
        """The static buffer of input `pos` at `like`'s shape and dtype: an
        ordinary tensor even under inference mode, so that a call under
        ``no_grad`` may copy into a buffer made under ``inference_mode``."""
        k = (pos, tuple(like.shape), like.dtype, like.device)
        buf = self._buffers.get(k)
        if buf is None:
            with torch.inference_mode(False):
                buf = self._buffers[k] = torch.empty(like.shape, dtype=like.dtype,
                                                     device=like.device)
        return buf

    def _capture(self, key, fn, inputs) -> _Graph:
        """`fn`'s graph on static copies of `inputs`, run once."""
        static = [self._static(i, x) for i, x in enumerate(inputs)]
        _copy_in(static, inputs)
        graph, out = self._record(fn, static)
        return _Graph(graph, static, out, _describe(key))

    def _record(self, fn, static):
        """(graph, static output): `fn` captured on `static` into the pool,
        on a side stream (a capture may not use the legacy default stream),
        then replayed once, since the capture itself runs nothing. Unlike
        ``torch.cuda.graph`` this neither waits for the device nor empties
        the allocator's cache first: the capture overlaps the work queued
        before it, and the eager calls that follow keep their cached blocks."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(static[0].device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream()
            # cuBLAS keeps a workspace per stream: dropped before the capture,
            # the capture's own is allocated in the pool; dropped after it,
            # no later eager product writes into the graph's
            torch._C._cuda_clearCublasWorkspaces()
            try:
                with torch.cuda.stream(self._stream):
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        out = fn(static)
                    finally:
                        graph.capture_end()
            finally:
                torch._C._cuda_clearCublasWorkspaces()
            graph.replay()
        return graph, out


def _describe(key: tuple) -> str:
    """A key as the ``flux.graph`` span's ``key`` attribute: a string, so
    that a span record stays plain data. An input reads
    ``shape:dtype:device``; a run of n equal words is written once, ``*n``."""
    words = [f"{'x'.join(map(str, x[0]))}:{str(x[1]).removeprefix('torch.')}:{x[2]}"
             if isinstance(x, tuple) else str(x) for x in key]
    runs = [(w, len(list(g))) for w, g in itertools.groupby(words)]
    return " ".join(w if n == 1 else f"{w}*{n}" for w, n in runs)
