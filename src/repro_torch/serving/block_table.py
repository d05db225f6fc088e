"""Host->device block-table mirror with incremental row sync.

The engine keeps the device block table its step reads in sync with a host
mirror, re-uploading only the ROWS whose page sets changed since the last
device call (pages appended or adopted, COW swaps, slot re-assigned, slot
vacated).  Steady decode within a page uploads nothing and reuses the same
device tensor.  What counts as "changed" is the caller's ``state_key``
(the engine folds in ``admit_seq``, so a preempt/re-admit cycle that lands
the same request back in its old slot still re-syncs).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.kv_cache import NULL_PAGE


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (chunk-width bucketing)."""
    return 1 << max(0, int(n - 1).bit_length())


def marshal_i32(device, *arrays) -> tuple:
    """Copy host arrays to ``device`` as int32 tensors, all in ONE host to
    device copy (a flat buffer, returned as views of it shaped like the
    arrays): the one place where the step's integer operands cross to the
    device."""
    host = [np.asarray(a, np.int32) for a in arrays]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in host]))
    dev = flat.to(device)
    out, at = [], 0
    for a in host:
        out.append(dev[at:at + a.size].view(a.shape))
        at += a.size
    return tuple(out)


class BlockTableMirror:
    """[num_slots, max_pages] int32 device table + host mirror + per-slot
    dirtiness state.  ``rows_synced`` counts lifetime row uploads."""

    def __init__(self, num_slots: int, max_pages_per_seq: int, device):
        self.host = np.zeros((num_slots, max_pages_per_seq), np.int32)
        self.dev = torch.from_numpy(self.host.copy()).to(device)
        self._state: List[Optional[tuple]] = [None] * num_slots
        self.rows_synced = 0

    def sync(self, pool, active: Dict[int, object],
             state_key: Callable[[object], tuple]) -> int:
        """Re-upload the rows whose ``state_key`` changed.  ``active``
        maps slot -> request (a vacated slot's row resets to the null
        page); ``state_key(req)`` must include the pool's table version
        so any table mutation dirties the row.  Returns rows uploaded."""
        dirty: List[int] = []
        for slot in range(len(self._state)):
            req = active.get(slot)
            if req is None:
                if self._state[slot] is not None:
                    self.host[slot] = NULL_PAGE   # vacated row
                    self._state[slot] = None
                    dirty.append(slot)
                continue
            state = state_key(req)
            if self._state[slot] == state:
                continue
            table = pool.table(req.id)
            row = self.host[slot]
            row[:] = NULL_PAGE
            row[:len(table)] = table
            self._state[slot] = state
            dirty.append(slot)
        if dirty:
            idx = torch.as_tensor(dirty, dtype=torch.long)
            self.dev[idx.to(self.dev.device)] = \
                torch.from_numpy(self.host[dirty]).to(self.dev.device)
            self.rows_synced += len(dirty)
        return len(dirty)
