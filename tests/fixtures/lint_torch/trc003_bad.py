"""Seeded TRC003: a device->host read every iteration."""
import torch


def losses(step, state, batches):
    out = []
    for batch in batches:
        state, loss = step(state, batch)
        out.append(loss.item())
    return torch.tensor(out)
