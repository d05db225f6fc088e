"""Checkpointing: async save and integrity-checked restore.

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
number as one of its type, anything else as a numpy array.  The JAX
package's elastic reshard onto another mesh waits for scale-out (ROADMAP
slice 5, item 19).
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

_KEY = re.compile(r"\['([^'\]]*)'\]")


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
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
    tensor in place while a background thread writes the copy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


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
        file is written)."""
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

        if blocking:
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
                device=None, verify: bool = True) -> Tuple[Any, int]:
        """Restore into the tree of ``like_state`` (its leaves say only
        what type each comes back as); returns (state, step).

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
        return _fill(like_state, restored), step

    def restore_latest_good(self, like_state, *, device=None):
        """Walk back through checkpoints until one passes verification."""
        for step in reversed(self.available_steps()):
            try:
                return self.restore(like_state, step=step, device=device,
                                    verify=True)
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
