"""Step checkpoints of a training run: async save, atomic directories,
keep-last-N, resume.

The port's stand-in for `codon_tpu.checkpoint.orbax_io.CheckpointManager`
(the card's machine has no orbax), with the same surface: save(step, tree),
restore(step=None), latest_step(), all_steps(), wait(), close(). The file
format is the port's own: `<directory>/step_<n>/tree.npz`, the tree's
leaves under '/'-joined paths as in `checkpoint.native`. The two packages
do not read each other's step directories.

  * save copies the tree to the host at once (the caller may go on
    changing its tensors), then writes on one background thread, in order;
    the write goes to a temporary directory that `os.replace` renames to
    `step_<n>`, so a crash or a failed write never leaves a partial step;
  * after each write the oldest steps beyond `max_to_keep` are deleted;
  * a write's error is raised from the next save, wait or close;
  * restore of a missing step raises FileNotFoundError.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from codon_tpu_torch.checkpoint.native import load_npz, save_npz

_STEP_DIR = re.compile(r"^step_(\d+)$")
TREE_FILE = "tree.npz"


def _to_host(tree):
    """A copy of the tree with every leaf a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)


class CheckpointManager:
    """Keep-last-N step checkpoints of a tree of tensors or arrays.

        mgr = CheckpointManager("ckpts/", max_to_keep=3)
        mgr.save(step, {"params": params, "opt_state": state, "step": step})
        mgr.close()                       # waits for the write in flight
        tree = CheckpointManager("ckpts/").restore()      # the latest step
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- writing ----------------------------------------------------------

    def save(self, step: int, tree: Any) -> None:
        """Copy `tree` to the host now; write it as step `step` in the
        background (after the previous write)."""
        host = _to_host(tree)
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(int(step), host), daemon=True)
        self._thread.start()

    def _write(self, step: int, host) -> None:
        try:
            tmp = tempfile.mkdtemp(prefix=f".step_{step}.",
                                   dir=self.directory)
            try:
                save_npz(os.path.join(tmp, TREE_FILE), host)
                final = self._path(step)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._collect()
        except Exception as e:   # raised again by wait()
            self._error = e

    def _collect(self) -> None:
        if not self.max_to_keep:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def wait(self) -> None:
        """Wait for the write in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- reading ----------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        """The complete steps on disk, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 TREE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> dict:
        """The tree of step `step` (default: the latest) as numpy arrays."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint steps in {self.directory}")
        path = os.path.join(self._path(step), TREE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint step {step} in "
                                    f"{self.directory}")
        return load_npz(path)
