"""Checkpointing: save and restore trees of tensors, the counterpart of
``repro.train.checkpoint``.

- **portable**: leaves are written as one ``.npz`` keyed by the leaf's path
  (the reference's keys: ``params/layers/#0/mlp/#0/w``,
  ``opt_state/mu/...``) plus a JSON manifest (step, time, the caller's
  meta) — no pickle. The reference writes its manifest with msgpack; the
  port writes JSON and needs no package beyond numpy and torch.
- **restart-safe**: writes go to a temp dir + atomic rename; the manager
  keeps the last K checkpoints and a ``latest`` pointer.
- **restore onto a device**: ``restore(..., device=)`` puts the leaves on
  that device (the reference's ``shardings=`` re-shards onto a mesh);
  without it the leaves come back as numpy arrays, as the reference's do.
- **async**: ``save_async`` copies the leaves to host memory at once and
  writes them to disk on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..tree import tree_map, tree_paths, tree_unflatten

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_tree"]


def _host(leaf) -> np.ndarray:
    """A host copy of the leaf, never a view: a tensor changed in place
    after a snapshot must not change the snapshot."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return leaf.cpu().numpy() if leaf.is_cuda else leaf.numpy().copy()
    return np.array(leaf)


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """path -> host copy of the leaf (a numpy array)."""
    return {path: _host(leaf) for path, leaf in tree_paths(tree)}


def unflatten_tree(template, flat: Dict[str, np.ndarray]):
    """A tree of ``template``'s structure holding ``flat``'s arrays."""
    leaves = []
    for path, _ in tree_paths(template):
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        leaves.append(flat[path])
    return tree_unflatten(template, leaves)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()

    # ------------- write -------------
    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{time.time_ns()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        final = os.path.join(self.dir, f"step_{step:010d}")
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "latest"), "w") as f:
                f.write(os.path.basename(final))
            self._gc()
        return final

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.dir) if d.startswith("step_")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def save(self, step: int, tree, *, meta: Optional[dict] = None) -> str:
        flat = flatten_tree(tree)
        m = dict(meta or {})
        m.update(step=step, time=time.time())
        return self._write(step, flat, m)

    def save_async(self, step: int, tree, *,
                   meta: Optional[dict] = None) -> Future:
        flat = flatten_tree(tree)  # host copies NOW; the write comes later
        m = dict(meta or {})
        m.update(step=step, time=time.time())
        return self._pool.submit(self._write, step, flat, m)

    # ------------- read -------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        return int(name.split("_")[1])

    def restore(self, template, *, step: Optional[int] = None, device=None):
        """Load into the structure of ``template``: numpy leaves, or
        tensors on ``device`` when it is given. Returns (tree, manifest)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = unflatten_tree(template, flat)
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        if device is not None:
            tree = tree_map(lambda a: torch.from_numpy(a).to(device), tree)
        return tree, meta
