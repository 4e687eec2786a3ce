"""Seeded ATM001: a scatter-add, float atomics on CUDA."""
import torch


def node_sums(messages, dst, n_nodes):
    out = torch.zeros((n_nodes, messages.shape[1]), device=messages.device)
    return out.index_add_(0, dst, messages)
