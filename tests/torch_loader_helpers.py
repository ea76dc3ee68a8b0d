"""Datasets and factories for the process-mode loader tests
(tests/test_torch_data.py). They live in a module of their own, light to
import, because each spawned worker process imports its factory's module."""

import os
import random
import signal
import time

import numpy as np


class IndexedDataset:
    """`n` samples in two buckets (8x8 for even indices, 8x16 for odd), each
    naming its index in its prompt; the pixels are drawn from the dataset's
    seeded RNG (so they depend on the worker's reseeding and on which
    samples it drew before), after a sleep of up to `jitter_s` drawn from
    the OS (so arrival times vary from run to run). The indices in `fail`
    raise."""

    def __init__(self, n=12, seed=0, jitter_s=0.0, fail=()):
        self.n, self.jitter_s, self.fail = n, jitter_s, fail
        self.rng = random.Random(seed)
        self._timing = random.Random(os.urandom(8))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.jitter_s:
            time.sleep(self._timing.uniform(0, self.jitter_s))
        if i in self.fail:
            raise ValueError(f"sample {i} is bad")
        h, w = (8, 8) if i % 2 == 0 else (8, 16)
        pixels = np.array([self.rng.random() for _ in range(h * w * 3)], np.float32)
        return {"pixel_values": pixels.reshape(h, w, 3),
                "mask": np.full((h, w), i, np.float32),
                "prompt": f"item {i}", "clip_prompt": f"clip {i}", "bucket": (h, w)}


def index_of(prompt: str) -> int:
    return int(prompt.split()[1])


def dying_after_write(writes, **kw):
    """An IndexedDataset for a worker process that kills itself (SIGKILL)
    right after its `writes`-th sample is written to shared memory and
    before the message naming it is sent."""
    from textflux_torch.data import loader

    write, done = loader._write_segment, [0]

    def write_then_die(path, sample):
        n = write(path, sample)
        done[0] += 1
        if done[0] == writes:
            os.kill(os.getpid(), signal.SIGKILL)
        return n

    loader._write_segment = write_then_die
    return IndexedDataset(**kw)
