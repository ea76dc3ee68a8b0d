"""Resolution-bucketed, background-prefetching batch loader.

The port of ``textflux_tpu/data/loader.py``'s thread mode: sample prep runs
in `num_workers` threads (PIL releases the GIL for most of it), a batcher
thread groups samples by their (H, W) bucket so a batch never mixes
resolutions, and batches come out in the ``(grad_accum, batch)`` layout the
train step takes. The JAX loader's process mode (``num_procs > 0``, a
persistent spawn pool) is not ported yet: ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import queue
import random
import threading
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np

PROCESS_MODE_ITEM = ("the loader's process mode (--loader-procs > 0) is not ported yet: "
                     "ROADMAP Queue 1 item 7; use thread mode (--loader-procs 0)")


class BucketedLoader:
    """Iterate dict batches with leading (grad_accum, batch) axes, one
    resolution bucket per batch.

    dataset[i] must return {"pixel_values": (H,W,3), "mask": (H,W),
    "prompt": str, "clip_prompt": str, "bucket": (H, W)}. Per-bucket
    partial batches are dropped at the end of an epoch. With more than one
    worker the order in which samples arrive depends on thread timing (and
    the workers share the dataset's RNG); with one it is deterministic.
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
        prefetch: int = 4,
    ):
        if num_procs > 0:
            raise NotImplementedError(PROCESS_MODE_ITEM)
        self.dataset = dataset
        self.batch_size = batch_size
        self.grad_accum = grad_accum
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.samples_per_batch = batch_size * grad_accum
        self._epoch = 0    # folded into the shuffle seed; advanced per epoch

    def set_epoch(self, epoch: int) -> None:
        """Position the shuffle stream (resume: pass the completed-epoch
        count so a resumed run does not replay epoch 0's order)."""
        self._epoch = int(epoch)

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
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

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

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def drained():
            finished = 0
            while finished < self.num_workers and not stop.is_set():
                try:
                    s = sample_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if s is None:
                    finished += 1
                    continue
                yield s

        def batcher():
            try:
                buckets: Dict[tuple, List[dict]] = defaultdict(list)
                for s in drained():
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
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
