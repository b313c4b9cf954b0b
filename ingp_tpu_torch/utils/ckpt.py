"""Checkpoint save/load on torch.save (counterpart of
ingp_tpu/utils/ckpt.py).

A checkpoint is one file holding the system's state tree: full
checkpoints carry {params, opt_state, grid, step} (NeRFSystem.state:
the JAX package's layouts, Adam as {mu, nu, count}); `slim_state` keeps
the weights and the step only (the grid re-warms on load, as the JAX
package's slim checkpoints do). Leaves are stored as CPU tensors, so
`torch.load(weights_only=True)` reads them back; every write goes to a
temporary name first and is committed with `os.replace`, so a crash
never leaves a half-written checkpoint under the final name.

`AsyncCkptManager` keeps periodic checkpoints, one directory per step:
`save` snapshots the state to host memory and returns, a background
thread writes and commits it, old steps are deleted beyond
`max_to_keep`, and `latest_step` / `restore` resume a run after a kill.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_STATE_FILE = "state.pt"


def to_host(tree):
    """A copy of tree with every array leaf (numpy or tensor) as a
    contiguous CPU tensor; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True).contiguous()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, order="C"))
    return tree


def _write(path, state):
    """torch.save to a temporary file beside path, then os.replace."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_ckpt(path, state):
    _write(os.path.abspath(path), to_host(state))


def load_ckpt(path):
    """The state tree of a checkpoint file, leaves as CPU tensors."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def slim_state(state, keep_embedding=True, keep_msk=True, keep_ext=False):
    """The weights and step of a state, without optimiser and grid."""
    params = dict(state["params"])
    if not keep_embedding:
        params.pop("embedding_a", None)
    if not keep_msk:
        params.pop("msk", None)
    if not keep_ext:
        params.pop("ext", None)
    return {"params": params, "step": state.get("step", 0)}


def extract_model_state(state):
    """Model weights only."""
    return state["params"]["model"]


class AsyncCkptManager:
    """Step-directory checkpoints written on a background thread.

    root/<step>/state.pt appears only once its write has finished: the
    step is written into a temporary directory, which `os.replace`
    renames. A second `save` first waits for the one before it, and
    re-raises its error, if any."""

    def __init__(self, root, max_to_keep: int = 2):
        self.root = os.path.abspath(root)
        self.max_to_keep = max_to_keep
        os.makedirs(self.root, exist_ok=True)
        for name in os.listdir(self.root):
            if name.startswith(".tmp-"):     # a write a kill cut short
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending = None

    def steps(self) -> list[int]:
        """The committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.root)
                      if re.fullmatch(r"\d+", n))

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        self.wait()
        snapshot = to_host(state)
        self._pending = self._pool.submit(self._commit, int(step), snapshot)

    def _commit(self, step, state):
        tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp-")
        try:
            torch.save(state, os.path.join(tmp, _STATE_FILE))
            final = os.path.join(self.root, str(step))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, str(old)))

    def restore(self, step: int | None = None):
        """The state of `step` (default the latest), or None when no step
        is committed."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return load_ckpt(os.path.join(self.root, str(step), _STATE_FILE))

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
