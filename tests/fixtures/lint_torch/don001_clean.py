"""Clean twin of DON001: the update's results rebound, the old values
copied before it."""
from repro_torch.optim import adamw


def step(grads, params):
    opt = adamw(1e-3, donate=True)
    state = opt.init(params)
    old = params["w"].clone()
    params, state = opt.update(grads, state, params)
    return params, old - params["w"]
