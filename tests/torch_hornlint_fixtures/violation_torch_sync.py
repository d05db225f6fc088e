"""Seeded HL2xx violations of the port's own sinks — one a line."""
import numpy as np
import torch


class Engine:
    def step(self, device):  # hornlint: hot-path
        logits = self._step(self.params, self.cache)
        best = torch.argmax(logits, dim=-1)
        n = best.sum().item()                     # HL201: .item()
        rows = best.tolist()                      # HL201: .tolist()
        host = best.to("cpu")                     # HL201: .to("cpu")
        arr = np.asarray(best)                    # HL201: np.asarray
        torch.cuda.synchronize()                  # HL201: a device sync
        if best.max() > 0:                        # HL201: implicit bool
            n += 1
        out = np.zeros((8,), np.int32)
        out[0] = best[0]                          # HL201: store to host
        flag = bool(best.any())                   # HL201: bool()
        mask = torch.ones(8, device=device)
        while mask.any():                         # HL202: implicit bool
            mask = mask * 0
        return n, rows, host, arr, out, flag
