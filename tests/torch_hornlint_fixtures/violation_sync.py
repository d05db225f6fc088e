"""Seeded HL2xx violations — hornlint MUST exit nonzero on this file."""
import numpy as np


class Engine:
    def step(self, now):  # hornlint: hot-path
        sampled, accepted = self._step(self.params, self.cache)
        sampled = sampled.cpu().numpy()           # HL201: unannotated pull
        for slot in range(8):
            tok = int(accepted[slot])             # HL202: pull per iteration
            self.out[slot] = tok
        return sampled

    def commit(self, outs):  # hornlint: hot-path
        probs = self._step(self.params, outs)
        return probs.item()                       # HL201: .item() pull
