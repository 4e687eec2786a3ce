"""Clean twin of TRC003: the values stay on the device and are read back
once, after the loop."""
import torch


def losses(step, state, batches):
    out = []
    for batch in batches:
        state, loss = step(state, batch)
        out.append(loss)
    return torch.stack(out).tolist()
