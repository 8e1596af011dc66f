"""Checkpoint / resume for optimization state.

The reference has *no* persistence whatsoever (SURVEY.md §5: no session
state, datasets re-imported every run; NrrdIO's write path is never
called).  This framework adds it because the long-running workloads —
TF-fit and grid inversion (BASELINE configs 3-4) — need
restart-from-checkpoint semantics on failure (JAX has no elastic
recovery; fail-fast + resume is the supported model).

Format: a single ``.npz`` per step holding the flattened pytree plus a
treedef fingerprint, written atomically (tmp + rename) so a killed run
never leaves a torn checkpoint.  Orbax is deliberately avoided for this
small state (a grid + TF + Adam moments); the npz round-trip is exact for
f32/i32 leaves.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import jax
import numpy as np


def save_checkpoint(path: str, state: Any, step: int | None = None) -> str:
    """Atomically write ``state`` (any pytree) to ``path`` (.npz)."""
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        str(treedef).encode(), dtype=np.uint8)
    if step is not None:
        arrays["__step__"] = np.int64(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Optional[int]]:
    """Load a checkpoint written by :func:`save_checkpoint`.

    ``like`` supplies the pytree structure (e.g. a freshly-initialized
    state); saved leaves are restored into it positionally.  Raises
    ``ValueError`` when the stored structure does not match.
    """
    with np.load(path) as z:
        leaves, treedef = jax.tree.flatten(like)
        stored = str(treedef).encode()
        have = z["__treedef__"].tobytes()
        if have != stored:
            raise ValueError(
                f"checkpoint treedef mismatch: {path} was written for a "
                "different state structure")
        n = len(leaves)
        new_leaves = [z[f"leaf_{i}"] for i in range(n)]
        step = int(z["__step__"]) if "__step__" in z else None
    return jax.tree.unflatten(treedef, new_leaves), step


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Most recent ``{prefix}{step}.npz`` in ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                s = int(name[len(prefix):-4])
            except ValueError:
                continue
            if s > best_step:
                best, best_step = os.path.join(directory, name), s
    return best
