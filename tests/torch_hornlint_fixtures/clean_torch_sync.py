"""Compliant twin of ``violation_torch_sync.py`` — hornlint MUST stay
quiet: metadata reads, uploads, dtype casts and host arrays never sync."""
import numpy as np
import torch


class Engine:
    def step(self, device):  # hornlint: hot-path
        logits = self._step(self.params, self.cache)
        best = torch.argmax(logits, dim=-1).to(torch.int32)
        width = best.shape[0] + best.size(0) + best.numel()
        ptr = best.data_ptr()
        if best is None or best.is_cuda:          # identity, metadata
            width += 1
        table = torch.from_numpy(np.zeros((8, 4), np.int32))
        d_table = table.to(device)                # an upload, not a pull
        host = np.zeros((8,), np.int32)
        host[0] = width                           # host into host
        both = torch.stack([best, d_table[:, 0]]).cpu()  # hornlint: sync-ok
        return both, ptr, host
