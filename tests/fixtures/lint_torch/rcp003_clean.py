"""Clean twin of RCP003: the cache keyed by ints and a device."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def plan(n, device):
    return n + 1, device


def run(n):
    return plan(n, torch.device("cpu"))
