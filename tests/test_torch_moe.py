"""The port's MoE layer against ``repro``'s, at small widths.

Inputs are numpy draws from a seed; parameters are ``repro``'s
``moe_init`` tree carried by ``interop``. Routing is compared exactly: each
test asserts that its tokens' k-th and (k+1)-th router logits stand at
least ``MARGIN`` apart, far above the f32 rounding of the router product
(~1e-6 at these widths), so both packages must pick the same experts, and
with capacity 0.5 drop the same tokens. Outputs, aux and gradients: 1e-5 x max(1,
max|ref|) in f32 compute (the same sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JCfg
from repro.models import moe as jmoe

from repro_torch import interop
from repro_torch.configs.base import ArchConfig as TCfg
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

TOL = 1e-5
MARGIN = 1e-3
BASE = dict(name="m", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
            d_ff=32, vocab=64, n_experts=6, top_k=2, d_ff_expert=24)


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    return (JCfg(**kw, compute_dtype=jnp.float32, remat=False),
            TCfg(**kw, compute_dtype=torch.float32, remat=False))


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (name, err)


def _params(jcfg, seed=0):
    """repro's tree, its router redrawn at unit scale: at the init's 0.02
    the router's logits lie within ~0.1 of each other and the k-th margin
    of some token falls to ~1e-5."""
    p = jax.tree_util.tree_map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(seed), jcfg))
    p["router"] = np.random.default_rng(seed).standard_normal(
        p["router"].shape).astype(np.float32)
    return p


def _inputs(cfg, shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _choices(p, x, cfg, gs):
    """The experts every token picks, asserted to have a clear k-th
    margin, from a float64 router (softmax keeps the logits' order)."""
    xf = x.reshape(-1, gs, cfg.d_model).astype(np.float64)
    logits = xf @ p["router"].astype(np.float64)
    srt = -np.sort(-logits, -1)
    gap = srt[..., cfg.top_k - 1] - srt[..., cfg.top_k]
    assert gap.min() > MARGIN, gap.min()
    return np.argsort(-logits, -1, kind="stable")[..., :cfg.top_k]


def _kept(choice, cfg, gs):
    """repro's queue rule in numpy: choice (G, gs, k) -> kept (G, gs, k)."""
    G = choice.shape[0]
    C = jmoe._capacity(gs, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    cf = choice.reshape(G, -1)
    seen = np.zeros((G, cfg.n_experts), int)
    keep = np.zeros(cf.shape, bool)
    for g in range(G):
        for i, e in enumerate(cf[g]):
            keep[g, i] = seen[g, e] < C
            seen[g, e] += 1
    return keep.reshape(choice.shape)


@pytest.mark.parametrize("gs,k,E,f", [(512, 8, 40, 1.25), (512, 6, 160, 1.25),
                                      (8, 6, 160, 1.25), (16, 2, 4, 0.5),
                                      (32, 2, 6, 8.0), (1, 1, 2, 1.0)])
def test_capacity_matches_repro(gs, k, E, f):
    assert tmoe._capacity(gs, k, E, f) == jmoe._capacity(gs, k, E, f)


@pytest.mark.parametrize("cf,shared,shape,gs", [
    (8.0, 0, (2, 32), 16),         # ample capacity: no drops
    (0.5, 0, (2, 32), 16),         # capacity 0.5: tokens drop
    (1.25, 1, (3, 16), 16),        # shared experts, the default capacity
    (1.25, 2, (4, 1), 512),        # decode-sized: T = B tokens, one group
    (0.5, 1, (2, 40), 512),        # one group of all 80 tokens, drops
])
def test_moe_apply_matches_repro(cf, shared, shape, gs):
    jcfg, tcfg = _cfgs(capacity_factor=cf, n_shared_experts=shared)
    p = _params(jcfg, seed=int(cf * 4) + shared)
    x = _inputs(jcfg, shape, seed=shared)
    T = int(np.prod(shape))
    g = min(gs, T)
    choice = _choices(p, x, jcfg, g)
    kept = _kept(choice, jcfg, g)
    if cf < 1:
        assert not kept.all()        # the case does drop tokens
    elif cf > 4:
        assert kept.all()
    jy, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), cfg=jcfg, group_size=gs)
    ty, taux = tmoe.moe_apply(interop.to_torch(p), torch.from_numpy(x),
                              cfg=tcfg, group_size=gs)
    # the port's routing picks the float64 router's experts
    _, _, tchoice = tmoe.route(interop.to_torch(p), torch.from_numpy(
        x.reshape(-1, g, jcfg.d_model)), tcfg)
    np.testing.assert_array_equal(tchoice.numpy(), choice)
    assert ("shared" in p) == bool(shared)
    _close(ty, jy, name="y")
    _close(taux, jaux, name="aux")
    # a dropped choice adds nothing: the output is the kept choices' gated
    # sum (and the shared experts'), computed per token here
    xt = torch.from_numpy(x.reshape(-1, jcfg.d_model))
    tp = interop.to_torch(p)
    _, gate, _ = tmoe.route(tp, xt.reshape(-1, g, jcfg.d_model), tcfg)
    gate = gate.reshape(-1, jcfg.top_k)
    want = torch.zeros_like(xt)
    for t, (row, es) in enumerate(zip(xt, choice.reshape(-1, jcfg.top_k))):
        for j, e in enumerate(es):
            if kept.reshape(-1, jcfg.top_k)[t, j]:
                h = torch.nn.functional.silu(row @ tp["w_gate"][e]) * (
                    row @ tp["w_up"][e])
                want[t] += gate[t, j] * (h @ tp["w_down"][e])
    if shared:
        from repro_torch.models.mlp import swiglu_apply
        want = want + swiglu_apply(tp["shared"], xt, "silu", torch.float32)
    _close(ty.reshape(-1, jcfg.d_model), want.numpy(), name="per token")


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_grads_match_jax_grad(cf):
    """Gradients of sum(y·w) + aux with respect to x and every parameter
    (router included, through the gates and the aux term)."""
    jcfg, tcfg = _cfgs(capacity_factor=cf, n_shared_experts=1)
    p = _params(jcfg, seed=3)
    x = _inputs(jcfg, (2, 32), seed=3)
    _choices(p, x, jcfg, 16)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, cfg=jcfg, group_size=16)
        return jnp.sum(y * w) + aux
    jg = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    leaves = {k: v.requires_grad_(True)
              for k, v in interop.leaves(interop.to_torch(p)).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(interop.unflatten(p, leaves), xt, cfg=tcfg,
                            group_size=16)
    (y * torch.from_numpy(w)).sum().add(aux).backward()
    _close(xt.grad, jg[1], name="dx")
    want = interop.leaves(jax.tree_util.tree_map(np.asarray, jg[0]))
    assert set(want) == set(leaves)
    for k, v in leaves.items():
        _close(v.grad, want[k], name=k)


def test_moe_block_remat_gives_equal_grads():
    """A MoE block under per-block rematerialisation recomputes the
    routing in the backward: the same output, aux and every gradient as
    without it, bitwise."""
    _, tcfg = _cfgs(capacity_factor=0.5, n_shared_experts=1)
    bp = tt.block_init(np.random.default_rng(5), tcfg, "attn")
    x = torch.from_numpy(_inputs(tcfg, (2, 32), seed=5))
    pos = torch.arange(32)
    outs = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in interop.leaves(bp).items()}
        xr = x.clone().requires_grad_(True)
        y, _, aux = tt._block(interop.unflatten(bp, leaves), xr,
                              remat=remat, btype="attn", cfg=tcfg,
                              positions=pos, mode="train")
        assert torch.is_tensor(aux) and aux.dim() == 0
        ((y * y).sum() + aux).backward()
        outs.append((y.detach(), aux.detach(), xr.grad,
                     {k: v.grad for k, v in leaves.items()}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])
    for k in outs[0][3]:
        assert torch.equal(outs[0][3][k], outs[1][3][k]), k


@pytest.mark.parametrize("rows", [1, 4])
def test_moe_segments_route_each_slice_alone(rows):
    """``segments``: each slice of the batch gets the output and aux it
    gets alone (the multi-task loss's per-task routing)."""
    _, tcfg = _cfgs(capacity_factor=0.5)
    p = interop.to_torch(_params(_cfgs()[0], seed=6))
    x = torch.from_numpy(_inputs(tcfg, (3 * rows, 8), seed=6))
    y, aux = tmoe.moe_apply(p, x, cfg=tcfg, group_size=16, segments=3)
    assert aux.shape == (3,)
    for s in range(3):
        ys, auxs = tmoe.moe_apply(p, x[s * rows:(s + 1) * rows], cfg=tcfg,
                                  group_size=16)
        assert torch.equal(y[s * rows:(s + 1) * rows], ys)
        assert torch.equal(aux[s], auxs)
    with pytest.raises(ValueError, match="segments"):
        tmoe.moe_apply(p, x, cfg=tcfg, segments=2 * rows + 5)
    with pytest.raises(ValueError, match="group"):     # repro asserts it
        tmoe.moe_apply(p, x[:, :7], cfg=tcfg, group_size=16)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_moe_lm_logits_and_aux_match_repro(arch, impl):
    """``lm_apply`` of the smoke configs in f32 compute: logits and the
    trunk's summed aux, against ``repro`` at its default impl."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import transformer as jt

    from repro_torch import configs as tconfigs
    jcfg = j_get_smoke(arch).replace(compute_dtype=jnp.float32)
    tcfg = tconfigs.get_smoke(arch).replace(compute_dtype=torch.float32)
    p = jt.lm_init(jax.random.PRNGKey(7), jcfg)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 24))
    jl, _, jaux = jt.lm_apply(p, jnp.asarray(toks), cfg=jcfg)
    tl, _, taux = tt.lm_apply(interop.to_torch(
        jax.tree_util.tree_map(np.asarray, p)), torch.from_numpy(toks),
        cfg=tcfg, impl=impl)
    assert float(jaux) > 0
    _close(tl, jl, name="logits")
    _close(taux, jaux, name="aux")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_moe_archs_through_the_launchers(arch, capsys):
    """``launch.serve_lm`` and ``launch.train --mode lm`` take the MoE
    archs by name (smoke width, the CPU): tokens, finite losses."""
    from repro_torch.launch import serve_lm
    from repro_torch.launch import train as t_launch
    toks = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                          "--prompt-len", "12", "--new", "3"])
    assert toks.shape == (2, 3)
    assert f'"arch": "{arch}"' in capsys.readouterr().out
    loss = t_launch.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                          "--steps", "2", "--batch", "2", "--seq", "16"])
    assert np.isfinite(loss)
