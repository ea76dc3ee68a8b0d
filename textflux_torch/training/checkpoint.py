"""Training-state checkpointing for resume: the port of
``textflux_tpu/training/checkpoint.py`` with torch's own serialisation
(orbax is the JAX side's).

A checkpoint is a nested dict of tensors and numbers (the LoRA factors, the
optimizer's state dict, the step), written with ``torch.save`` to
``<directory>/<step>/state.pt``. Saving copies every tensor to the host at
once (so training can go on changing the originals), then writes in a
background thread into a temporary directory that is renamed to the step
when the file is complete: a crash mid-write leaves no directory that looks
like a checkpoint. The oldest checkpoints beyond ``max_to_keep`` are removed
after each write.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    """A copy of `tree` with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _like(tree: Any, template: Any, path: str = "") -> Any:
    """`tree` with each tensor moved to the device and dtype of the tensor
    at the same place in `template`; raises where the two differ in
    structure or shape."""
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape:
            got = tree.shape if isinstance(tree, torch.Tensor) else type(tree).__name__
            raise ValueError(f"checkpoint entry {path or '<root>'} is {got}, "
                             f"expected {tuple(template.shape)}")
        return tree.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"checkpoint entry {path or '<root>'} has keys "
                             f"{sorted(tree) if isinstance(tree, dict) else tree!r}, "
                             f"expected {sorted(template)}")
        return {k: _like(tree[k], template[k], f"{path}.{k}" if path else str(k))
                for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"checkpoint entry {path} has another length than expected")
        return type(template)(_like(x, y, f"{path}[{i}]")
                              for i, (x, y) in enumerate(zip(tree, template)))
    return tree


class CheckpointManager:
    """Rotating step checkpoints of a nested dict of tensors (factors +
    optimizer state + step)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> List[int]:
        """The steps that have a complete checkpoint, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d,
                                                                     STATE_FILE)))

    def _write(self, step: int, host_state: Any) -> None:
        try:
            final = os.path.join(self.directory, str(step))
            tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
            torch.save(host_state, os.path.join(tmp, STATE_FILE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except BaseException as e:  # raised in the training thread by wait()
            self._error = e

    def save(self, step: int, state: Any, *, wait: bool = False) -> None:
        """Copy `state` to the host now and write it in the background; the
        previous save is waited for first. wait=True blocks until this one
        is on disk (final and preemption checkpoints)."""
        self.wait()
        host_state = _to_host(state)
        self._thread = threading.Thread(target=self._write, args=(step, host_state),
                                        daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def wait(self) -> None:
        """Block until the last save is on disk; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("writing a checkpoint failed") from err

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The state saved at `step` (default: the latest; None when there is
        none). With a `template`, each tensor lands on the device and dtype
        of the template's tensor at the same place, and a difference in
        structure or shape raises."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        # our own files: the state holds only tensors, dicts, lists and numbers
        state = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        return state if template is None else _like(state, template)
