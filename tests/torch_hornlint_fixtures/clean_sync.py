"""Compliant twin of ``violation_sync.py`` — hornlint MUST stay quiet.

One deliberate annotated pull commits the tick; everything downstream of
it is host data and loops freely.
"""
import numpy as np
import torch


class Engine:
    def step(self, now):  # hornlint: hot-path
        sampled, accepted = self._step(self.params, self.cache)
        sampled, accepted = \
            torch.stack([sampled, accepted]).cpu().numpy()  # hornlint: sync-ok
        for slot in range(8):
            tok = int(accepted[slot])             # host array: free
            self.out[slot] = tok
        return sampled

    def commit(self, outs):  # hornlint: hot-path
        host = np.asarray(outs)                   # host input: not device
        return float(host.sum())
