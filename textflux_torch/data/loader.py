"""Resolution-bucketed, background-prefetching batch loader.

The port of ``textflux_tpu/data/loader.py``: sample prep runs in
`num_workers` threads (PIL releases the GIL for most of it) or, with
``num_procs > 0`` and a `dataset_factory`, in a persistent pool of spawned
worker processes (``--loader-procs N``: for sample prep that is heavy on the
CPU); a batcher thread groups samples by their (H, W) bucket so a batch never
mixes resolutions, and batches come out in the ``(grad_accum, batch)``
layout the train step takes.

Process mode does not copy the JAX transport, whose shared ``mp.Queue``
carries each pickled sample whole: a worker that dies mid-message leaves a
partial pickle in the pipe, and a reader blocks in it for good. Here
- each worker writes a sample (its arrays out of band, pickle protocol 5)
  into a file of its own in ``/dev/shm`` and sends only the file's name and
  size, a message far under ``PIPE_BUF``, so each write to its pipe is
  atomic: a worker that dies loses a reply but cannot leave half of one.
  The parent reads the file and unlinks it at once; the files of a worker
  killed between its write and its message, and those of an abandoned
  epoch, are unlinked when they are read or by ``close()``. The bytes in
  flight are bounded by half of what ``/dev/shm`` has free;
- every wait in the parent is bounded: it waits on the worker's pipe and on
  every worker's process sentinel at once, so a dead worker raises
  ``RuntimeError`` naming the worker and its exit code at once, and the
  consumer's own wait re-checks the workers every `worker_poll_s`;
- the order does not depend on timing: position ``i`` of an epoch goes to
  worker ``i mod N`` (each worker reseeded with its id, as in the JAX pool)
  and the replies are read in position order, as torch's DataLoader does.
  At ``num_procs = 1`` the batches are the JAX loader's; at N > 1 they are
  one order the JAX pool can produce, the same on every run and every rank;
- workers ignore SIGINT and SIGTERM (a preemption notice to the process
  group reaches the trainer alone, which finishes its step); ``close()``
  ends them.
"""

from __future__ import annotations

import glob
import multiprocessing as mp
import os
import pickle
import queue
import random
import secrets
import signal
import struct
import threading
import time
from collections import defaultdict
from multiprocessing import util as mp_util
from multiprocessing.connection import wait
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

SHM_DIR = "/dev/shm"
_SKIP = "__textflux_skip__"
_ALIGN = 64           # byte alignment of each array in a sample's file
_STOP_POLL_S = 0.2    # how often a waiting reader looks at the epoch's stop flag
_CLOSE_GRACE_S = 1.0  # close(): how long idle workers get to exit before SIGKILL
_JOIN_S = 5.0         # bound on joining a killed worker or an ending batcher thread


def _reseed_dataset(ds, worker_id: int) -> None:
    """Per-worker RNG derivation, as the JAX loader's: every worker rebuilds
    the dataset from the same factory (same seed), so without this all
    workers draw the same augmentation, resolution and annotation sequences
    in lockstep."""
    rng = getattr(ds, "rng", None)
    if rng is not None:
        rng.seed((rng.getrandbits(64) << 8) ^ (worker_id + 1))
    for child in getattr(ds, "datasets", ()):
        _reseed_dataset(child, worker_id)


def _offsets(start: int, sizes) -> tuple:
    """The `_ALIGN`-aligned offsets of buffers of `sizes` laid out from
    byte `start`, and the end of the last one."""
    offsets = []
    for n in sizes:
        start = -(-start // _ALIGN) * _ALIGN
        offsets.append(start)
        start += n
    return offsets, start


def _write_segment(path: str, sample) -> int:
    """Write `sample` to a new file at `path`: little-endian uint64s (the
    pickle's length, the buffer count, each buffer's length), the pickle
    (protocol 5, the arrays' data out of band), then each buffer at an
    aligned offset. Returns the file's size. Plain writes, no mapping: a
    full tmpfs fails the write with ENOSPC rather than raising SIGBUS. The
    file is removed when the write fails."""
    bufs = []
    meta = pickle.dumps(sample, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = struct.pack(f"<{2 + len(raws)}Q", len(meta), len(raws), *(r.nbytes for r in raws))
    offsets, end = _offsets(len(head) + len(meta), [r.nbytes for r in raws])
    try:
        with open(path, "xb") as f:
            f.write(head + meta)
            for off, raw in zip(offsets, raws):
                f.seek(off)
                f.write(raw)
    except BaseException as e:
        if os.path.exists(path):
            os.unlink(path)
        if isinstance(e, OSError):
            raise OSError(e.errno, f"{e.strerror} writing a sample of {end} bytes") from e
        raise
    return end


def _read_segment(path: str):
    """The sample `_write_segment` wrote at `path` (its arrays backed by one
    read of the file); the file is unlinked whatever happens."""
    try:
        with open(path, "rb") as f:
            data = bytearray(os.fstat(f.fileno()).st_size)
            f.readinto(data)
    finally:
        os.unlink(path)
    n_meta, n_buf = struct.unpack_from("<QQ", data)
    sizes = struct.unpack_from(f"<{n_buf}Q", data, 16)
    start = 16 + 8 * n_buf
    offsets, _ = _offsets(start + n_meta, sizes)
    view = memoryview(data)
    return pickle.loads(view[start:start + n_meta],
                        buffers=[view[o:o + n] for o, n in zip(offsets, sizes)])


def _proc_worker(factory, worker_id: int, tasks, replies, prefix: str) -> None:
    """Worker-process loop: build the dataset once (persistent across
    epochs: spawn and the dataset's set-up are paid once), then answer each
    (epoch, position, index) task with exactly one message: the sample's
    file name and size, the skip marker (the dataset raised), or an error
    (the sample did not fit in SHM_DIR). Ends on None, or when the parent's
    end of `tasks` closes. Top-level, so spawn can pickle it."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    ds = factory()
    _reseed_dataset(ds, worker_id)
    while True:
        try:
            task = tasks.recv()
        except EOFError:
            return
        if task is None:
            return
        epoch, pos, i = task
        try:
            sample = ds[i]
        except Exception:
            replies.send((epoch, pos, _SKIP, None))
            continue
        name = f"{prefix}-{worker_id}-{epoch}-{pos}"
        try:
            nbytes = _write_segment(os.path.join(SHM_DIR, name), sample)
        except OSError as e:
            st = os.statvfs(SHM_DIR)
            replies.send((epoch, pos, "error", (
                f"loader worker {worker_id}: sample {i} does not fit in {SHM_DIR} "
                f"({st.f_bavail * st.f_frsize} of {st.f_blocks * st.f_frsize} bytes free): "
                f"{e}; free space there or use thread mode (--loader-procs 0)")))
            continue
        replies.send((epoch, pos, "sample", (name, nbytes)))


def _shutdown(procs, tasks, replies, prefix: str) -> None:
    """Stop the workers (None to each; SIGKILL to any still running after
    _CLOSE_GRACE_S: they ignore SIGTERM, and hold nothing to flush), close
    the pipes and unlink every file the pool left in SHM_DIR."""
    for conn in tasks:
        try:
            conn.send(None)
        except OSError:   # the worker is gone
            pass
    deadline = time.monotonic() + _CLOSE_GRACE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(_JOIN_S)
    for conn in tasks + replies:
        conn.close()
    for path in glob.glob(os.path.join(SHM_DIR, glob.escape(prefix) + "-*")):
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


class _ProcessPool:
    """A loader's persistent worker processes (spawned: the parent may hold
    CUDA) with one task pipe and one reply pipe each, kept across epochs.
    One thread at a time reads it (the epoch's batcher)."""

    def __init__(self, factory: Callable, n: int):
        if not os.path.isdir(SHM_DIR):
            raise RuntimeError(f"the loader's process mode needs {SHM_DIR}; "
                               "use thread mode (--loader-procs 0)")
        ctx = mp.get_context("spawn")
        self.prefix = f"textflux-{os.getpid()}-{secrets.token_hex(4)}"
        self.procs, self.tasks, self.replies = [], [], []
        try:
            for k in range(n):
                task_r, task_w = ctx.Pipe(duplex=False)
                reply_r, reply_w = ctx.Pipe(duplex=False)
                self.tasks.append(task_w)
                self.replies.append(reply_r)
                p = ctx.Process(target=_proc_worker, name=f"textflux-loader-{k}",
                                args=(factory, k, task_r, reply_w, self.prefix), daemon=True)
                p.start()
                self.procs.append(p)
                task_r.close()    # the worker holds these ends alone: EOF when it dies
                reply_w.close()
        except BaseException:
            _shutdown(self.procs, self.tasks, self.replies, self.prefix)
            raise
        # runs at close(), when the pool is collected, or at exit before
        # multiprocessing joins its children (which ignore SIGTERM)
        self._finalize = mp_util.Finalize(
            self, _shutdown, args=(self.procs, self.tasks, self.replies, self.prefix),
            exitpriority=10)
        self.epoch = 0
        self.in_flight = 0      # tasks sent whose reply is not read yet
        self.sample_bytes = 0   # the largest sample file seen
        self.budget = 0         # the bytes this epoch may keep in SHM_DIR

    def close(self) -> None:
        self._finalize()

    def check_alive(self) -> None:
        dead = [(k, p) for k, p in enumerate(self.procs) if not p.is_alive()]
        if dead:
            raise RuntimeError(
                f"{len(dead)} loader worker process(es) died ("
                + ", ".join(f"worker {k}, pid {p.pid}, exit code {p.exitcode}" for k, p in dead)
                + "); their replies are lost: fix the worker's crash or use thread mode "
                "(--loader-procs 0)")

    def _window(self, most: int) -> int:
        if not self.sample_bytes:   # no size known yet: one sample a worker
            return len(self.procs)
        return max(1, min(most, self.budget // self.sample_bytes))

    def _send(self, pos: int, index: int) -> None:
        try:
            self.tasks[pos % len(self.procs)].send((self.epoch, pos, index))
        except OSError:
            self.check_alive()
            raise
        self.in_flight += 1

    def _reply(self, pos: int, stop: threading.Event):
        """Position `pos`'s reply (a sample or _SKIP), read from its worker's
        pipe; replies of an abandoned epoch met on the way are dropped and
        their files unlinked. None once `stop` is set."""
        k = pos % len(self.procs)
        conn, proc = self.replies[k], self.procs[k]
        sentinels = [p.sentinel for p in self.procs]
        while not stop.is_set():
            if conn not in wait([conn] + sentinels, timeout=_STOP_POLL_S):
                self.check_alive()
                continue
            try:
                epoch, got, kind, payload = conn.recv()
            except EOFError:   # the worker closed its pipe: it is ending
                proc.join(_JOIN_S)
                self.check_alive()
                raise RuntimeError(f"loader worker process {k} closed its pipe") from None
            self.in_flight -= 1
            path = os.path.join(SHM_DIR, payload[0]) if kind == "sample" else None
            if (epoch, got) != (self.epoch, pos):
                if path is not None:
                    os.unlink(path)
                continue
            if kind == "error":
                raise RuntimeError(payload)
            if path is None:
                return _SKIP
            self.sample_bytes = max(self.sample_bytes, payload[1])
            return _read_segment(path)
        return None

    def samples(self, order: List[int], stop: threading.Event, most: int) -> Iterator[dict]:
        """One epoch over `order`: tasks sent ahead while the samples in
        flight stay under `most` and the byte budget, the samples yielded
        in position order (skipped ones left out)."""
        self.epoch += 1
        st = os.statvfs(SHM_DIR)
        self.budget = st.f_bavail * st.f_frsize // 2
        sent = 0
        for pos in range(len(order)):
            while sent < len(order) and (sent <= pos or self.in_flight < self._window(most)):
                self._send(sent, order[sent])
                sent += 1
            s = self._reply(pos, stop)
            if s is None:
                return
            if s is not _SKIP:
                yield s


class BucketedLoader:
    """Iterate dict batches with leading (grad_accum, batch) axes, one
    resolution bucket per batch.

    dataset[i] must return {"pixel_values": (H,W,3), "mask": (H,W),
    "prompt": str, "clip_prompt": str, "bucket": (H, W)}. Per-bucket
    partial batches are dropped at the end of an epoch. With more than one
    worker thread the order in which samples arrive depends on thread
    timing (and the workers share the dataset's RNG); with one it is
    deterministic.

    With num_procs > 0, `dataset_factory` (a picklable zero-argument
    callable returning the dataset) must be given: sample prep then runs in
    that many spawned worker processes, each with its own dataset, in an
    order that does not depend on timing (see the module's docstring).
    Call ``close()`` to end them.
    """

    def __init__(
        self,
        dataset,
        *,
        batch_size: int = 1,
        grad_accum: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        num_procs: int = 0,
        dataset_factory: Optional[Callable] = None,
        prefetch: int = 4,
        worker_poll_s: float = 30.0,
    ):
        if num_procs > 0 and dataset_factory is None:
            raise ValueError("num_procs > 0 requires dataset_factory "
                             "(workers rebuild the dataset in-process)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.grad_accum = grad_accum
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.num_procs = num_procs
        self.dataset_factory = dataset_factory
        self.prefetch = prefetch
        self.worker_poll_s = worker_poll_s   # the consumer's liveness interval
        self.samples_per_batch = batch_size * grad_accum
        self._pool: Optional[_ProcessPool] = None   # process mode's workers (lazy)
        self._epoch = 0    # folded into the shuffle seed; advanced per epoch

    def set_epoch(self, epoch: int) -> None:
        """Position the shuffle stream (resume: pass the completed-epoch
        count so a resumed run does not replay epoch 0's order)."""
        self._epoch = int(epoch)

    def close(self) -> None:
        """End the worker processes and unlink what they left in /dev/shm
        (process mode; nothing to do in thread mode). The next epoch starts
        a new pool."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def _collate(self, samples: List[dict]) -> dict:
        a, b = self.grad_accum, self.batch_size
        pixels = np.stack([s["pixel_values"] for s in samples])
        masks = np.stack([s["mask"] for s in samples])
        return {
            "pixel_values": pixels.reshape(a, b, *pixels.shape[1:]),
            "mask": masks.reshape(a, b, *masks.shape[1:]),
            "prompts": [s["prompt"] for s in samples],
            "clip_prompts": [s["clip_prompt"] for s in samples],
            "bucket": samples[0]["bucket"],
        }

    def _thread_samples(self, order: List[int], stop: threading.Event,
                        put_or_stop) -> Iterator[dict]:
        """Thread mode: `num_workers` threads over one index queue; samples
        in the order they finish (a sample that fails is skipped)."""
        idx_q: "queue.Queue" = queue.Queue()
        for i in order:
            idx_q.put(i)
        sample_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.samples_per_batch * 2)

        def worker():
            while not stop.is_set():
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    put_or_stop(sample_q, None)
                    return
                try:
                    s = self.dataset[i]
                except Exception:
                    continue   # a sample that fails 16 retries is skipped
                if not put_or_stop(sample_q, s):
                    return

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()
        finished = 0
        while finished < self.num_workers and not stop.is_set():
            try:
                s = sample_q.get(timeout=_STOP_POLL_S)
            except queue.Empty:
                continue
            if s is None:
                finished += 1
                continue
            yield s

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.dataset)))
        # the epoch folded into the seed: successive epochs see different
        # orders, and set_epoch() lets a resumed run continue the stream
        rng = random.Random(self.seed * 1_000_003 + self._epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(q, item) -> bool:
            """Bounded put that observes `stop`: a consumer that abandons the
            iterator mid-epoch must not leave the batcher or worker threads
            blocked forever in put() on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=_STOP_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        if self.num_procs > 0:
            if self._pool is None:
                self._pool = _ProcessPool(self.dataset_factory, self.num_procs)
            samples = self._pool.samples(order, stop, self.prefetch * self.samples_per_batch * 2)
        else:
            samples = self._thread_samples(order, stop, put_or_stop)

        def batcher():
            try:
                buckets: Dict[tuple, List[dict]] = defaultdict(list)
                for s in samples:
                    bucket = buckets[tuple(s["bucket"])]
                    bucket.append(s)
                    if len(bucket) == self.samples_per_batch:
                        if not put_or_stop(out_q, self._collate(bucket)):
                            return
                        buckets[tuple(s["bucket"])] = []
                # per-bucket partials are dropped: batches are shape-uniform
            except BaseException as e:  # forwarded to the consuming thread
                put_or_stop(out_q, e)
                return
            put_or_stop(out_q, None)

        bt = threading.Thread(target=batcher, daemon=True)
        bt.start()
        try:
            while True:
                try:
                    batch = out_q.get(timeout=self.worker_poll_s)
                except queue.Empty:
                    if self._pool is not None:
                        self._pool.check_alive()
                    if not bt.is_alive() and out_q.empty():
                        raise RuntimeError("the loader's batcher thread ended without "
                                           "a batch, an error or the epoch's end") from None
                    continue
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            bt.join(_JOIN_S)
            # a pool whose reader is still running, or with a dead worker,
            # is not reused; otherwise it survives an abandoned epoch (the
            # next epoch drops the stale replies)
            if self._pool is not None and (bt.is_alive() or not all(
                    p.is_alive() for p in self._pool.procs)):
                self.close()
