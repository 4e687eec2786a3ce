"""``make_lm_multitask`` against ``repro``'s, at the smoke widths of every
LM architecture in f32 and bf16 (the MoE archs in f32 only:
``torch_lm_common`` says why): per-task losses, the weighted total and
every gradient leaf, trunk and heads. A file apart from
``test_torch_lm_train.py`` because ``pytest-xdist --dist loadfile`` runs
a file on one worker.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.mtl import make_lm_multitask as j_make_lm_multitask
from repro.engine import multitask_grad_fn as j_multitask_grad_fn

from repro_torch import interop
from repro_torch.core.mtl import make_lm_multitask
from repro_torch.engine import multitask_grad_fn
from torch_lm_common import (ARCHS, DTYPES, MOE_ARCHS, RECURRENT_ARCHS,
                             _batch, _cfgs, _close, _close_grads,
                             _close_grads_to_noise, _live_lora)


@pytest.mark.parametrize("arch,dtype", [
    (a, d) for a in ARCHS for d in DTYPES
    if not (a in MOE_ARCHS and d == "bf16")])
def test_lm_multitask_matches_repro(arch, dtype):
    """``make_lm_multitask``: per-task losses (one trunk pass over the
    T·B rows in the port, ``repro`` vmaps per task), the weighted total and
    every gradient leaf, trunk and heads."""
    jcfg, tcfg = _cfgs(arch, dtype, n_tasks=3)
    jmodel = j_make_lm_multitask(jcfg)
    tmodel = make_lm_multitask(tcfg)
    params = _live_lora(jmodel.init(jax.random.PRNGKey(1)))
    batch = _batch(tcfg, 2, 16, T=3)
    tw = (1.0, 0.5, 2.0)
    jl, jm, jg = jax.jit(j_multitask_grad_fn(jmodel, 3, tw))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = multitask_grad_fn(tmodel, 3, tw)(
        interop.to_torch(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = DTYPES[dtype][2]
    _close(tl.numpy(), jl, tol, "loss")
    _close(tm["per_task_loss"].numpy(), jm["per_task_loss"], tol,
           "per_task_loss")
    if dtype == "bf16" and arch in RECURRENT_ARCHS:
        _, _, jg32 = jax.jit(j_multitask_grad_fn(j_make_lm_multitask(
            jcfg.replace(compute_dtype=jnp.float32)), 3, tw))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        return _close_grads_to_noise(tg, jg, jg32)
    _close_grads(tg, jg, dtype)
