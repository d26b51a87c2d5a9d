"""Checkpointing: atomic, keep-K, async, elastic (port of
``repro.checkpoint``).

Layout, as the reference's::

    <dir>/step_000000123/       # one directory per step
        arrays.npz              # the leaves, leaf_0 .. leaf_{n-1}
        treedef.json            # step, and each leaf's name, dtype, shape
    <dir>/step_000000123.tmp/   # staging; atomic rename commits

A tree is nested dicts with string keys and tensor (or numpy) leaves,
named by their key path (``"params/blocks.0.mixer.wq"``) in place of the
reference's pytree definition.  numpy has no bfloat16: such a leaf is
stored as its ``uint16`` bit pattern and ``treedef.json`` records the
dtype.  The port's files are its own; it does not read the reference's.

* **Atomic**: writes go to ``.tmp`` and commit via ``os.replace`` — a
  killed job never leaves a half-written "latest" checkpoint.
* **Elastic**: leaves are saved on the host; :func:`restore` places each
  on the device of its counterpart in ``like`` (or on ``device``), so a
  state saved on the card restores on the CPU, and back.
* **Async**: :meth:`AsyncCheckpointer.save_async` copies to the host on
  the caller's thread, then writes on a worker thread — the train loop
  blocks only for the device->host copy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["flatten", "save", "AsyncCheckpointer", "latest_step", "restore"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def flatten(tree: Any, prefix: str = "") -> list:
    """``[(name, leaf)]`` of a tree of nested dicts, in key order: the
    names a checkpoint stores its leaves under."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if not isinstance(k, str) or "/" in k:
                raise ValueError(f"checkpoint keys are strings without '/', "
                                 f"got {k!r}")
            out += flatten(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(like: Any, leaves: dict, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _host(leaf, copy: bool = False) -> torch.Tensor:
    """``leaf`` on the host; with ``copy``, a copy that later in-place
    updates of the leaf cannot reach."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=copy)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:  # numpy has no bf16: store the bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save; returns the committed path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [(name, _host(leaf)) for name, leaf in flatten(tree)]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": _to_numpy(t) for i, (_, t) in enumerate(leaves)})
    meta = {"step": step, "n_leaves": len(leaves),
            "leaves": [{"name": name, "dtype": str(t.dtype)[len("torch."):],
                        "shape": list(t.shape)} for name, t in leaves]}
    with open(os.path.join(tmp, "treedef.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Snapshot on the caller thread, write on a worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any):
        self.wait()
        # device->host snapshot
        host = _unflatten(tree, {name: _host(leaf, copy=True)
                                 for name, leaf in flatten(tree)})

        def _write():
            try:
                save(self.ckpt_dir, step, host, keep=self.keep)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like``: each leaf a new tensor on
    ``device``, or where ``like``'s leaf of the same name lives.  Raises
    when the saved names, shapes or dtypes differ from ``like``'s."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    want = flatten(like)
    saved = [m["name"] for m in meta["leaves"]]
    if sorted(saved) != sorted(name for name, _ in want):
        raise ValueError(f"{path}: leaves {saved} differ from the target "
                         f"tree's {[name for name, _ in want]}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = {m["name"]: _from_numpy(z[f"leaf_{i}"], m["dtype"])
                  for i, m in enumerate(meta["leaves"])}
    placed = {}
    for name, ref in want:
        t, ref = leaves[name], torch.as_tensor(ref)
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{path}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, the target's {ref.dtype} "
                             f"{tuple(ref.shape)}")
        placed[name] = t.to(ref.device if device is None else device)
    return _unflatten(like, placed)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
