"""Checkpointing: async save, integrity-checked restore, elastic reshard.

The port of ``repro/checkpoint/checkpointer.py``, with the same layout on
disk, so a checkpoint of either package restores in the other.  One
directory per step, ``step_%09d/``, holding
  * ``shard_0.npz``  flat {path: array}, the path the JAX package's
                     ``keystr`` of the leaf (``"['params']['w0']"``)
  * ``meta.json``    step, time, a sha256[:16] checksum, shape and dtype
                     per leaf
  * ``_COMMITTED``   written last: a restore ignores a directory without
                     it, so a save cut off half way never corrupts one;
                     the directory is written as ``.tmp`` and renamed.

A state is a tree of dicts (keys sorted, as JAX flattens them), lists and
tuples whose leaves are tensors, numpy arrays or Python numbers; None is
no leaf.  ``restore`` fills ``like_state``'s tree: a tensor leaf comes
back as a tensor on ``device`` (by default the leaf's own), a Python
number as one of its type, anything else as a numpy array.

Across ranks: a DTensor leaf is saved as its full array, in the same
``shard_0.npz`` layout.  Every rank gathers (``save`` is a collective on
a process group of several ranks), rank 0 alone writes, synchronously,
and a barrier commits the save for all.  ``restore(shardings=)`` lays
each array out onto the given ``NamedSharding`` (``launch/mesh.py``):
the elastic reshard onto any mesh whose sharded dims divide the global
shapes, as the JAX package's ``device_put`` onto new shardings.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import NamedSharding
from repro_torch.runtime.elastic import place

_KEY = re.compile(r"\['([^'\]]*)'\]")


def _leaves_with_path(tree, path="", leaf=lambda x: False):
    if leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}['{k}']", leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]", leaf)
    elif tree is not None:
        yield path, tree


def flatten(tree) -> Dict[str, Any]:
    """{keystr path: leaf}, the JAX package's ``keystr`` paths."""
    return dict(_leaves_with_path(tree))


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The nested dicts of a flat {keystr: leaf} mapping whose paths are
    dict keys only (``flatten``'s inverse for such trees)."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        path = _KEY.findall(key)
        if not path or "".join(f"['{p}']" for p in path) != key:
            raise KeyError(f"not a keystr of dict keys: {key!r}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf``, taken now: the caller may update the
    tensor in place while a background thread writes the copy.  A
    DTensor is gathered whole first."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _ranks() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _from_host(arr: np.ndarray, like, device):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device or like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = True) -> str:
        """Copy the state to host memory now, then write it to disk, on a
        background thread unless ``blocking`` (training goes on while the
        file is written).  On several ranks every rank must call it:
        DTensors are gathered, rank 0 writes before it returns, and a
        barrier commits the checkpoint for every rank (a collective no
        background thread may issue beside the step's)."""
        host = {k: _to_host(v) for k, v in flatten(state).items()}
        path = os.path.join(self.dir, f"step_{step:09d}")

        def write():
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"), **host)
            meta = {
                "step": step,
                "time": time.time(),
                "checksums": {k: _checksum(v) for k, v in host.items()},
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": {k: str(v.dtype) for k, v in host.items()},
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if _ranks() > 1:
            self.wait()
            if dist.get_rank() == 0:
                write()
            dist.barrier()
        elif blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.available_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def available_steps(self):
        out = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, "_COMMITTED"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, like_state, *, step: Optional[int] = None,
                device=None, shardings=None,
                verify: bool = True) -> Tuple[Any, int]:
        """Restore into the tree of ``like_state`` (its leaves say only
        what type each comes back as); returns (state, step).

        ``shardings``: a tree like ``like_state``'s of ``NamedSharding``
        (or None) leaves: each tensor leaf is laid out onto its mesh and
        placements, the elastic reshard onto the current mesh.

        Raises ValueError on a checksum mismatch (a corrupt shard) and
        KeyError on a leaf the checkpoint lacks, so the caller can fall
        back to an earlier step (``restore_latest_good``)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoints")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            if verify:
                for k in data.files:
                    if _checksum(data[k]) != meta["checksums"][k]:
                        raise ValueError(
                            f"checksum mismatch at {k} (step {step})")
            restored = {k: _from_host(data[k], like, device)
                        for k, like in flatten(like_state).items()}
        if shardings is not None:
            where = dict(_leaves_with_path(
                shardings, leaf=lambda x: isinstance(x, NamedSharding)))
            restored = {k: place(v, where.get(k))
                        for k, v in restored.items()}
        return _fill(like_state, restored), step

    def restore_latest_good(self, like_state, *, device=None,
                            shardings=None):
        """Walk back through checkpoints until one passes verification."""
        for step in reversed(self.available_steps()):
            try:
                return self.restore(like_state, step=step, device=device,
                                    shardings=shardings, verify=True)
            except (ValueError, KeyError, OSError):
                continue
        raise FileNotFoundError("no restorable checkpoint")


def _fill(tree, flat: Mapping[str, Any], path=""):
    """``tree`` with each leaf replaced by ``flat[its keystr]``."""
    if isinstance(tree, dict):
        return {k: _fill(v, flat, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, flat, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else flat[path]
