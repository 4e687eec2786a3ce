"""The port's LM loss and every gradient leaf against ``repro``'s, at the
smoke widths of every LM architecture, in f32 and bf16, with and without
remat (``make_lm_loss`` through ``single_grad_fn``). Inputs and
tolerances: ``torch_lm_common``. A file of its own because it is the
suite's slowest test: ``pytest-xdist --dist loadfile`` runs a file on one
worker.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import transformer as jt
from repro.train.loop import make_lm_loss as j_make_lm_loss

from repro_torch import interop
from repro_torch.engine import SingleTaskModel, single_grad_fn
from repro_torch.train.loop import make_lm_loss
from torch_lm_common import (ARCHS, DTYPES, RECURRENT_ARCHS, _batch, _cfgs,
                             _close, _close_grads, _close_grads_to_noise,
                             _live_lora)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_repro(arch, dtype, remat):
    """``make_lm_loss`` through ``single_grad_fn``: the loss and every
    gradient leaf, with and without per-block rematerialisation."""
    jcfg, tcfg = _cfgs(arch, dtype, remat=remat)
    params = _live_lora(jt.lm_init(jax.random.PRNGKey(0), jcfg))
    batch = _batch(tcfg, 2, 24)
    jl, jg = jax.jit(jax.value_and_grad(j_make_lm_loss(jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = SingleTaskModel(init=None, loss_fn=make_lm_loss(tcfg))
    tl, metrics, tg = single_grad_fn(model)(
        interop.to_torch(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = DTYPES[dtype][2]
    assert metrics == {}
    _close(tl.numpy(), jl, tol, "loss")
    if dtype == "bf16" and arch in RECURRENT_ARCHS:
        _, jg32 = jax.jit(jax.value_and_grad(j_make_lm_loss(
            jcfg.replace(compute_dtype=jnp.float32))))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        return _close_grads_to_noise(tg, jg, jg32)
    _close_grads(tg, jg, dtype)
