"""HL101's clean twin: the same tensors, built when called."""
import torch

F32 = torch.float32
EPS = torch.finfo(F32).eps


def neg(device):
    return torch.full((4,), -1e30, device=device)


class Table:
    def __init__(self, device):
        self.rows = torch.zeros(16, 4, device=device)

    @torch.no_grad()
    def lookup(self, i):
        return self.rows[i]


def scaled(x, scale=0.5):
    return x * torch.tensor(scale, device=x.device)
