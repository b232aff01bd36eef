"""Fault-tolerant checkpointing: atomic writes, retention, preemption path.

Port of ``repro/checkpoint/manager.py``, with the reference's files: a
checkpoint written by either package restores in the other.

* **atomicity** — every process writes into ``step_<n>.tmp/``; process 0
  then ``os.replace``s it to ``step_<n>/`` (removing a stale ``step_<n>/``
  from an earlier save of the same step first).  A crash mid-write never
  corrupts the latest checkpoint: ``latest_step`` ignores ``.tmp``
  leftovers.
* **per-process files** — each process saves its host copy of every leaf
  of the tree (nested dicts, lists, tuples and NamedTuples of numpy
  arrays, tensors on any device and scalars) as ``host_<p>.npz``, each
  under the reference's leaf key (``"['slots']"``, ``"['a']/[0]"``, an
  ``OptState``'s ``".m/['w']/.q"``; ``/`` written as ``__``); restore
  reads the process's own file and casts each array back to the target
  leaf's dtype, a tensor leaf coming back as a CPU tensor, and rebuilds
  each node as the target's type (a NamedTuple from its fields).  The
  process index is the ``torch.distributed`` rank when a process group is
  initialized, else 0; with more than one process, process 0 renames the
  directory after a barrier (the reference leaves that sync to the
  caller).
* **preemption** — ``save_on_signal`` installs a SIGTERM handler that
  requests an immediate save at the next step boundary (the driving loop
  polls ``should_save_now``).  Each process's handler sets only its own
  request, so processes that save together first agree on it
  (``agree_to_save``): all save at that boundary or none does.  The
  reference saves per process, so ranks that see the signal at different
  steps write different steps, and process 0 may rename a directory
  before the others' files are in it.
* **retention** — keep the newest ``keep`` checkpoints (``keep >= 1``),
  delete older.
"""
from __future__ import annotations

import json
import os
import shutil
import signal

import numpy as np
import torch


def _process_index() -> int:
    """This process's index among the savers: the ``torch.distributed``
    rank once a process group is initialized, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(key, subtree) pairs of a node in the reference's order and key
    spelling, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{leaf key: leaf}`` in the reference's order and key spelling:
    dict keys sorted and written ``['key']``, NamedTuple fields ``.field``,
    sequence positions ``[i]``, joined by ``/``; None holds no leaf."""
    if tree is None:
        return {}
    items = _children(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for name, sub in items:
        out.update(_flatten_with_paths(
            sub, f"{prefix}/{name}" if prefix else name))
    return out


def _unflatten(tree, arrays: dict, prefix: str = ""):
    """``tree``'s structure with every leaf replaced by ``arrays[key]``,
    cast to the leaf's dtype (a tensor leaf as a CPU tensor)."""
    if tree is None:
        return None
    items = _children(tree)
    if items is not None:
        values = [_unflatten(sub, arrays, f"{prefix}/{name}" if prefix
                             else name) for name, sub in items]
        if isinstance(tree, dict):
            by_key = dict(zip(sorted(tree), values))
            return {k: by_key[k] for k in tree}
        if _is_namedtuple(tree):
            return type(tree)(*values)
        return type(tree)(values)
    arr = arrays[prefix]
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(tree.dtype)
    tgt_dtype = tree.dtype if hasattr(tree, "dtype") else arr.dtype
    return np.asarray(arr, dtype=tgt_dtype)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(
                f"keep must be >= 1 (the newest checkpoint is always "
                f"retained), got {keep}")
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._save_requested = False

    # ---- preemption handling ----
    def save_on_signal(self, signum=signal.SIGTERM):
        def handler(_sig, _frm):
            self._save_requested = True
        signal.signal(signum, handler)

    @property
    def should_save_now(self) -> bool:
        return self._save_requested

    def agree_to_save(self, device="cpu", group=None) -> bool:
        """Whether any process of ``group`` (the world by default) has a
        save request: one all-reduce MAX of this process's flag, a tensor
        on ``device`` (the card under NCCL, the CPU under gloo).  A
        collective: every process of the group calls it at every step
        boundary, whether or not it is a ``save_every`` step."""
        flag = torch.tensor([int(self._save_requested)], dtype=torch.int32,
                            device=device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        return bool(flag.item())

    # ---- save/restore ----
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, tree, extra: dict | None = None):
        proc = _process_index()
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        # every process writes its own host_<p>.npz into tmp, so every
        # process must be able to create it (first writer wins)
        os.makedirs(tmp, exist_ok=True)
        leaves = _flatten_with_paths(tree)
        arrays, meta = {}, {}
        for key, leaf in leaves.items():
            arr = _host_array(leaf)
            arrays[key.replace("/", "__")] = arr
            meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        np.savez(os.path.join(tmp, f"host_{proc}.npz"), **arrays)
        if _world_size() > 1:
            # every process's file is in tmp before process 0 renames it
            torch.distributed.barrier()
        if proc == 0:
            # shared metadata is written once, by process 0 only
            if extra is not None:
                with open(os.path.join(tmp, "extra.json"), "w") as f:
                    json.dump(extra, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # barrier-equivalent on multi-host would sync here; then one
            # atomic rename.  Re-saving a step (resume, then checkpoint
            # the same boundary again) must not trip over the old dir:
            # os.replace raises OSError for non-empty directory targets.
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        self._save_requested = False

    def restore(self, tree_like, step: int | None = None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self._step_dir(step)
        proc = _process_index()
        path = os.path.join(d, f"host_{proc}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint for step {step}: {path!r} does not exist "
                f"(expected checkpoint directory {d!r})")
        data = np.load(path)
        arrays = {key: data[key.replace("/", "__")]
                  for key in _flatten_with_paths(tree_like)}
        tree = _unflatten(tree_like, arrays)
        extra = None
        ep = os.path.join(d, "extra.json")
        if os.path.exists(ep):
            with open(ep) as f:
                extra = json.load(f)
        return tree, extra

    def latest_step(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
