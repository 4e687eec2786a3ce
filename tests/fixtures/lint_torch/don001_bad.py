"""Seeded DON001: reading params after the donated AdamW update."""
from repro_torch.optim import adamw


def step(grads, params):
    opt = adamw(1e-3, donate=True)
    state = opt.init(params)
    new_params, state = opt.update(grads, state, params)
    drift = params["w"] - new_params["w"]
    return new_params, drift
