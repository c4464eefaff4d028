"""Atomic checkpoints with async save and retention, ported from
``repro/checkpoint/sharded.py`` for one process.

A checkpoint is a nested dict of tensors, numpy arrays and numbers (the
trainer's: parameters and optimizer state keyed by their names, the step
and the data position); a leaf is stored under its path of keys joined by
"/".  Commit protocol:
  1. write ``<dir>/.tmp-<step>-<pid>-<ns>/shard-00000.npz`` and ``meta.json``
     (paths, shapes, dtypes, step, user metadata);
  2. ``rename`` the tmp dir to ``step-<step>``: a checkpoint directory is
     valid iff the rename happened, so a reader never sees a torn one;
  3. retention: keep the newest ``keep`` steps and every multiple of
     ``keep_every``, delete the rest.
A bf16 tensor is stored as float32 (numpy has no bf16; the cast is exact)
and its dtype recorded; `restore_checkpoint` casts each leaf to the dtype
of the ``like`` tree's leaf.

Under a mesh (SPMD, one process a device) a DTensor leaf is saved as its
full tensor, in the same one-shard format: the gather is a collective, so
every rank of its mesh calls ``save``, and only the writer
(``AsyncCheckpointer(write=True)``, the mesh's first rank) writes.
`restore_checkpoint` with ``shardings`` places each full leaf by its
`launch.sharding.NamedSharding` (every rank reads the file and keeps its
shard), so a checkpoint taken on one mesh restores on another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

_STEP_PREFIX = "step-"
_SHARD = "shard-00000.npz"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):                # a DTensor: a collective
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} for a nested dict of leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def list_steps(ckpt_dir: str | os.PathLike) -> list[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    out = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith(_STEP_PREFIX):
            try:
                out.append(int(p.name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _apply_retention(ckpt_dir: Path, keep: int, keep_every: int | None):
    steps = list_steps(ckpt_dir)
    if keep <= 0 or len(steps) <= keep:
        return
    protected = set(steps[-keep:])
    if keep_every:
        protected |= {s for s in steps if s % keep_every == 0}
    for s in steps:
        if s not in protected:
            shutil.rmtree(ckpt_dir / f"{_STEP_PREFIX}{s}", ignore_errors=True)


def _write(ckpt_dir: Path, step: int, flat: dict, metadata: dict | None, keep: int,
           keep_every: int | None) -> Path:
    """Commits host arrays ``flat`` as checkpoint ``step``."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp-{step}-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir()
    try:
        np.savez(tmp / _SHARD, **flat)
        meta = {"step": int(step), "n_processes": 1,
                "paths": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                          for k, v in flat.items()},
                "metadata": metadata or {}, "time": time.time()}
        (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
        final = ckpt_dir / f"{_STEP_PREFIX}{step}"
        if final.exists():            # a re-save of the same step replaces it
            shutil.rmtree(final)
        os.rename(tmp, final)         # the atomic commit point
        _apply_retention(ckpt_dir, keep, keep_every)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, tree, *,
                    metadata: dict | None = None, keep: int = 3,
                    keep_every: int | None = None) -> Path:
    """Writes one atomic checkpoint; returns the committed directory."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    return _write(Path(ckpt_dir), step, flat, metadata, keep, keep_every)


def _dtype_of(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return np.asarray(leaf).dtype


def restore_checkpoint(ckpt_dir: str | os.PathLike, like, *, step: int | None = None,
                       shardings=None):
    """Restores into the structure of ``like`` (a nested dict whose leaves
    are tensors, DTensors, arrays or numbers): each leaf a numpy array of
    the like leaf's (global) shape, or a CPU tensor where the like leaf is
    a tensor, in its dtype.  ``shardings``: a tree matching ``like`` whose
    leaves are `launch.sharding.NamedSharding` (or None): those leaves come
    back as DTensors placed by them, on their mesh's device (the elastic
    reshard path).  Raises on a missing leaf or another shape.  Returns
    (tree, meta)."""
    d = Path(ckpt_dir)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
    cdir = d / f"{_STEP_PREFIX}{step}"
    meta = json.loads((cdir / "meta.json").read_text())
    with np.load(cdir / _SHARD) as z:
        stored = {k: z[k] for k in z.files}
    want = _flatten(like)
    missing = [k for k in want if k not in stored]
    if missing:
        raise ValueError(f"checkpoint {cdir} missing leaves: {missing[:5]}...")
    out = {}
    for k, leaf in want.items():
        arr = stored[k]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{k}: checkpoint shape {arr.shape} != {shape}")
        dt = _dtype_of(leaf)
        out[k] = (torch.from_numpy(np.array(arr)).to(dt) if isinstance(dt, torch.dtype)
                  else arr.astype(dt))
    if shardings is not None:
        from ..launch.sharding import place
        for k, sh in _flatten(shardings).items():
            if sh is not None:
                x = out[k]
                x = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
                out[k] = place(x.to(sh.mesh.device_type), sh)
    return _unflatten(out), meta


class AsyncCheckpointer:
    """At-most-one-in-flight background checkpoint writer.

    ``save()`` copies the tree to host numpy arrays before it returns (a
    device-to-host copy, so a later in-place update of a parameter or the
    optimizer state cannot reach the write), then queues the disk write;
    the loop blocks on I/O only while a previous save is still running.
    ``close()`` drains; the trainer calls it on every exit.  ``write=False``
    (a rank of a mesh other than its first) gathers DTensor leaves, which
    is a collective, and writes nothing.
    """

    def __init__(self, ckpt_dir: str | os.PathLike, *, keep: int = 3,
                 keep_every: int | None = None, write: bool = True):
        self.ckpt_dir = Path(ckpt_dir)
        self.write = write
        self.keep = keep
        self.keep_every = keep_every
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._inflight: Future | None = None
        self._lock = threading.Lock()
        self.saved_steps: list[int] = []

    def save(self, step: int, tree, *, metadata: dict | None = None) -> None:
        flat = {k: np.array(_to_numpy(v), copy=True) for k, v in _flatten(tree).items()}
        if not self.write:
            return
        with self._lock:
            if self._inflight is not None:
                self._inflight.result()              # back-pressure
            self._inflight = self._pool.submit(_write, self.ckpt_dir, step, flat, metadata,
                                               self.keep, self.keep_every)
            self.saved_steps.append(int(step))

    def wait(self) -> None:
        with self._lock:
            if self._inflight is not None:
                self._inflight.result()
                self._inflight = None

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
