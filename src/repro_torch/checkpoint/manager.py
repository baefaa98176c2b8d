"""Fault-tolerant checkpointing: the torch counterpart of
``repro.checkpoint.manager``, with its on-disk contract.

Layout:  <dir>/step_00000420/
            meta.json            — step, leaf keys, shapes/dtypes, extra (data state)
            arr_<flatkey>.npy    — one file per leaf

Guarantees:
  * atomic commit — writes land in ``.tmp-step_N`` and are os.rename()'d into
    place, so a crash mid-save can never yield a half checkpoint that
    ``latest_step`` would pick up;
  * keep-N retention (oldest complete checkpoints pruned after commit);
  * async mode — leaves are copied to the host synchronously at ``save``
    (the train step updates the state in place right after) and written by
    a background thread, overlapping serialization with the next steps;
  * restore places each leaf on the target leaf's device (or the one the
    caller names) in the target leaf's dtype: the files are device-free
    numpy;
  * elastic restore — given ``shardings`` (``runtime.elastic.
    state_shardings`` of the caller's current mesh), each leaf is placed
    with its target placements, so a checkpoint written on one mesh
    restores onto any other; a DTensor target leaf with no sharding given
    keeps its own placements.

On a mesh every leaf that is a DTensor is saved as its full tensor (a
collective: every rank calls ``save`` at the same steps), so the layout
stays topology-free, and only rank 0 writes; ``wait`` then holds every
rank at a barrier until the write has landed.

A state is a tree of dicts, lists and tuples, :class:`~repro_torch.models.
model.ParamTree` modules (flattened through ``tree()``) and tensors; its
flat keys join the path with ``.``. bf16 leaves are stored as their 16-bit
patterns (numpy has no bf16) with the dtype in ``meta.json``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.model import ParamTree
from ..runtime.elastic import place
from ..sharding.rules import Sharding

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, ParamTree):
        node = node.tree()
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return []


def _flatten(tree, prefix: str = "", leaf: type = torch.Tensor) -> List[Tuple[str, Any]]:
    """(flat key, leaf) for every leaf (a ``leaf`` instance: a tensor, or a
    ``Sharding`` in a shardings tree), in a fixed order (dict keys sorted,
    as the reference's tree flattening)."""
    if isinstance(tree, leaf):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += _flatten(child, f"{prefix}.{key}" if prefix else key, leaf)
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of the full value (never a view of the live tensor)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _unflatten(target, load, prefix: str = ""):
    """``target``'s structure with every tensor leaf replaced by
    ``load(key, leaf)``; a ParamTree is rebuilt as its own type, each
    parameter keeping the target's ``requires_grad``."""
    if isinstance(target, torch.Tensor):
        return load(prefix, target)
    if isinstance(target, ParamTree):
        return target.map(lambda name, p: load(f"{prefix}.{name}" if prefix else name, p))
    key = (lambda k: f"{prefix}.{k}") if prefix else str
    if isinstance(target, dict):
        return {k: _unflatten(v, load, key(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, load, key(i)) for i, v in enumerate(target))
    return target


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False  # a sharded save: every rank waits for rank 0's write
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot ``state`` at ``step``. The copy to the host happens here,
        synchronously (the arrays are consistent); file IO may be async."""
        self.wait()  # one outstanding async save at a time
        leaves = _flatten(state)
        host_leaves = [(k, _to_host(v)) for k, v in leaves]
        if any(isinstance(v, DTensor) for _, v in leaves):
            self._barrier = True
            if dist.get_rank() != 0:
                return
        meta = {
            "step": step,
            "extra": extra or {},
            "leaves": [{"key": k, "shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
                       for k, v in leaves],
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp-step_{step:08d}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, v in host_leaves:
                np.save(os.path.join(tmp, f"arr_{k}.npy"), v)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic commit
            self._prune()

        if self.async_save:
            def run():
                try:
                    write()
                except Exception as e:  # handed to the caller by wait()
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the outstanding async save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            dist.barrier()
            self._barrier = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None, device=None,
                shardings: Any = None) -> tuple:
        """Restore into the structure of ``target`` (the state, or one of the
        same structure): each leaf in the target leaf's dtype, on ``device``
        or else the target leaf's device; with ``shardings`` (the tree of
        ``sharding.rules.Sharding`` that ``runtime.elastic.state_shardings``
        gives) each leaf placed with its own. Returns (state, meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        stored = {leaf["key"]: leaf["dtype"] for leaf in meta["leaves"]}
        placed = dict(_flatten(shardings, leaf=Sharding)) if shardings is not None else {}

        def load(key: str, tgt: torch.Tensor) -> torch.Tensor:
            arr = np.load(os.path.join(d, f"arr_{key}.npy"))
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, target {tuple(tgt.shape)}")
            t = torch.from_numpy(arr)
            if stored[key] == "bfloat16":
                t = t.view(torch.bfloat16)
            sharding = placed.get(key)
            if sharding is None and isinstance(tgt, DTensor):
                sharding = Sharding(tgt.device_mesh, (), tuple(tgt.placements))
            if sharding is not None:
                return place(t.to(tgt.dtype), sharding)
            return t.to(device=device if device is not None else tgt.device, dtype=tgt.dtype)

        return _unflatten(target, load), meta
