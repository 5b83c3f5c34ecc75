"""Sharded checkpointing with two-phase commit, in the JAX package's format
(``io/checkpoint.py``): a checkpoint written by either package restores in
the other.

Fault-tolerance contract:

* **Atomicity** — a checkpoint directory is first written under a ``.tmp``
  name per shard, then sealed by a tiny ``MANIFEST.json`` written last (the
  commit point), and renamed into place with ``os.replace``.  A crash
  mid-write leaves no manifest; restore scans for the *newest complete*
  manifest and ignores partial directories.
* **Sharded** — each host writes only its local shards (``shard_<host>.npz``
  of the addressable leaves).  On one host that is one file; the layout and
  manifest schema are the multi-host ones.
* **Resharding restore** — the manifest records the mesh shape the state was
  saved under; :func:`restore` loads the full logical arrays and lets the
  caller re-place them.
* **Data-iterator replay** — the manifest carries the TokenStream state so
  restart resumes the exact stream position.

The npz keys are the reference's, letter for letter: ``<name>/`` and then
``jax.tree_util.keystr`` of the leaf's path, built here without JAX — a
dict key as ``['key']`` (keys in sorted order), a NamedTuple field as
``.field``, a list or tuple index as ``[i]``.  So the trainer's state
``{"params": <the reference's stacked parameter tree>, "opt": OptState}``
gives ``params/['layers']['wq']``, ``opt/.step`` and
``opt/.mu['layers']['wq']``.  Leaves are numpy arrays or tensors (written
from the host; bfloat16, which numpy lacks, as its raw 2-byte words, the
bytes the reference writes for its bfloat16 arrays).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy

MANIFEST = "MANIFEST.json"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[Iterator[Tuple[str, Any]]]:
    """(key string, child) of a container node, in the reference's
    flattening order; None for a leaf."""
    if isinstance(node, dict):
        return ((f"[{k!r}]", node[k]) for k in sorted(node))
    if _is_namedtuple(node):
        return ((f".{f}", getattr(node, f)) for f in node._fields)
    if isinstance(node, (list, tuple)):
        return ((f"[{i}]", c) for i, c in enumerate(node))
    return None


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf)
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    kids = _children(tree)
    if kids is None:
        return {prefix: _as_numpy(tree)}
    out: Dict[str, np.ndarray] = {}
    for key, child in kids:
        out.update(_flatten(child, prefix + key))
    return out


def _unflatten(tree_like, flat: Dict[str, np.ndarray], prefix: str = ""):
    kids = _children(tree_like)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint has no {prefix}")
        arr = flat[prefix]
        if arr.shape != tuple(tree_like.shape):
            raise ValueError(f"checkpoint shape mismatch at {prefix}: "
                             f"{arr.shape} vs {tuple(tree_like.shape)}")
        return arr
    vals = [_unflatten(c, flat, prefix + k) for k, c in kids]
    if isinstance(tree_like, dict):
        return dict(zip(sorted(tree_like), vals))
    if _is_namedtuple(tree_like):
        return type(tree_like)(*vals)
    return type(tree_like)(vals)


def save(ckpt_dir: str, step: int, state: Dict[str, Any], *,
         host_id: int = 0, n_hosts: int = 1,
         mesh_shape: Optional[tuple] = None,
         extra: Optional[dict] = None) -> str:
    """Two-phase-commit checkpoint.  ``state`` is a dict of trees (e.g.
    {"params": ..., "opt": ...}).  Returns the sealed directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    # Phase 1: shard payloads (crash here leaves only .tmp, never restored).
    flat = {}
    for name, tree in state.items():
        for k, v in _flatten(tree).items():
            flat[f"{name}/{k}"] = v
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **flat)

    # Phase 2: the commit point — manifest written last, rename is atomic.
    manifest = {
        "step": step,
        "n_hosts": n_hosts,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "wall_time": time.time(),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _sealed(ckpt_dir: str) -> list:
    return sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)))


def latest_complete(ckpt_dir: str) -> Optional[str]:
    """Newest directory with a sealed manifest; partial writes are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = _sealed(ckpt_dir)
    return os.path.join(ckpt_dir, candidates[-1]) if candidates else None


def restore(path: str, state_like: Dict[str, Any], *,
            host_id: int = 0) -> Tuple[Dict[str, Any], dict]:
    """Load a sealed checkpoint into the structure of ``state_like`` (trees
    whose leaves have a ``shape``: arrays, tensors or ``TensorSpec``s), as
    numpy arrays.  Returns (state, manifest); raises on a missing key or a
    shape that differs."""
    del host_id   # every shard file is read: a resharding restore
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    flat: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                flat.update({k: z[k] for k in z.files})
    out = {}
    for name, tree in state_like.items():
        sub = {k[len(name) + 1:]: v for k, v in flat.items()
               if k.startswith(name + "/")}
        out[name] = _unflatten(tree, sub)
    return out, manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` sealed checkpoints (bounded slow-tier use)."""
    if not os.path.isdir(ckpt_dir):
        return
    for d in _sealed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    # Garbage-collect orphaned tmp dirs from crashes.
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
