"""Seeded HL101 violations: torch tensors built when the module is
imported."""
import torch

NEG = torch.full((4,), -1e30)                      # HL101
STEPS = [torch.arange(8) for _ in range(2)]        # HL101


class Table:
    ROWS = torch.zeros(16, 4)                      # HL101

    def lookup(self, i):
        return self.ROWS[i]


def scaled(x, scale=torch.tensor(0.5)):            # HL101
    return x * scale
