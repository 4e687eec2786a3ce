"""Clean twin of DET004: a held, seeded generator."""
import torch


def noisy(x, seed):
    g = torch.Generator().manual_seed(seed)
    return x + 0.01 * torch.randn(x.shape, generator=g)
