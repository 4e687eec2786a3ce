"""Seeded DET004: a draw from torch's process-global generator."""
import torch


def noisy(x):
    return x + 0.01 * torch.randn(x.shape)
