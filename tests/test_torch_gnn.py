"""The port's EGNN trunk and MTL heads against ``repro`` on the same
parameters and the same batch (converted through numpy).

Tolerances: 2e-5 at ``smoke()`` — what tests/test_hotpath.py holds the JAX
impls to against each other; 1e-4 at full width (H=866), where the
1733-term φ_e contractions are summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hydragnn_gfm as j_gfm
from repro.core.mtl import make_gfm_mtl
from repro.data.synthetic_atoms import generate_all, to_batch_dict
from repro.models import gnn as j_gnn
from repro.models import heads as j_heads

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.models import gnn, heads

BATCH_KEYS = ("species", "pos", "edge_src", "edge_dst", "node_mask",
              "edge_mask")


def _batch(max_atoms, max_edges, n=4, seed=0, source="ani1x"):
    data = generate_all(n, max_atoms=max_atoms, max_edges=max_edges,
                        seed=seed, sources=[source])
    jb = to_batch_dict(data[source], np.arange(n))
    return ({k: jb[k] for k in BATCH_KEYS},
            {k: torch.from_numpy(np.array(jb[k])) for k in BATCH_KEYS})


@pytest.fixture(scope="module")
def smoke_model():
    jcfg = j_gfm.smoke()
    params = make_gfm_mtl(jcfg, 3).init(jax.random.PRNGKey(0))
    jb, tb = _batch(jcfg.max_atoms, jcfg.max_edges)
    fused = np.asarray(j_gnn.egnn_apply(params["shared"], jb, cfg=jcfg,
                                        impl="fused"))
    return jcfg, params, interop.to_torch(params), jb, tb, fused


@pytest.mark.parametrize("impl", gnn.SEGMENT_SUM_IMPLS)
def test_egnn_apply_matches_repro_fused(smoke_model, impl):
    _, _, tp, _, tb, want = smoke_model
    got = gnn.egnn_apply(tp["shared"], tb, cfg=t_gfm.smoke(), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5,
                               err_msg=impl)


@pytest.mark.parametrize("impl", gnn.SEGMENT_SUM_IMPLS)
def test_species_embedding_backward_takes_kernel_1_but_on_jnp(smoke_model,
                                                              impl,
                                                              monkeypatch):
    """The trunk's species embedding sums its cotangent through the
    segment-sum wrapper (kernel #1 on the card) on every path but the
    parity oracle ``"jnp"``, which keeps every kernel out."""
    from repro_torch.kernels import segment_sum as ss_pkg
    calls, real = [], ss_pkg.segment_sum

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(ss_pkg, "segment_sum", spy)
    _, _, tp, _, tb, _ = smoke_model
    table = tp["shared"]["embed"]["table"].clone().requires_grad_(True)
    shared = dict(tp["shared"], embed={"table": table})
    gnn.egnn_apply(shared, tb, cfg=t_gfm.smoke(), impl=impl).sum().backward()
    B, A = tb["species"].shape
    assert calls == ([] if impl == "jnp"
                     else [(B * A, t_gfm.smoke().gnn_hidden)])
    assert bool(torch.isfinite(table.grad).all())


def test_egnn_apply_follows_cfg_impl_and_rejects_unknown(smoke_model):
    _, _, tp, _, tb, _ = smoke_model
    cfg = t_gfm.smoke()
    a = gnn.egnn_apply(tp["shared"], tb, cfg=cfg.replace(
        segment_sum_impl="pallas"))
    b = gnn.egnn_apply(tp["shared"], tb, cfg=cfg, impl="pallas")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="impl"):
        gnn.egnn_apply(tp["shared"], tb, cfg=cfg, impl="nope")
    with pytest.raises(ValueError, match="impl"):
        gnn.segment_sum_nodes(torch.zeros(1, 2, 3), torch.zeros(1, 2), 2,
                              edge_mask=torch.ones(1, 2, dtype=torch.bool),
                              impl="fused")


@pytest.mark.parametrize("head", [0, 1, 2])
def test_branch_apply_matches_repro(smoke_model, head):
    jcfg, jp, tp, jb, tb, feats = smoke_model
    jh = jax.tree_util.tree_map(lambda v: v[head], jp["heads"])
    e_want, f_want = j_heads.branch_apply(jh, feats, jb["node_mask"],
                                          cfg=jcfg)
    th = jax.tree_util.tree_map(lambda v: v[head], tp["heads"])
    e, f = heads.branch_apply(th, torch.from_numpy(feats.copy()),
                              tb["node_mask"], cfg=t_gfm.smoke())
    np.testing.assert_allclose(e.numpy(), np.asarray(e_want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_want), atol=1e-5,
                               rtol=1e-5)


def test_port_init_has_repro_layout(smoke_model):
    """Leaf paths and shapes of the port's init equal repro's init."""
    from repro_torch.core.mtl import gfm_mtl_init
    want = smoke_model[1]
    got = gfm_mtl_init(t_gfm.smoke(), 3, device="meta")
    want_l = interop.leaves(want)
    got_l = interop.leaves(got)
    assert set(want_l) == set(got_l)
    for k, v in want_l.items():
        assert tuple(got_l[k].shape) == tuple(v.shape), k


@pytest.fixture(scope="module")
def full_width():
    """hydragnn-gfm at its published width (4 layers, H=866), one graph of
    A=16 atoms and E=64 edges."""
    jcfg = j_gfm.CONFIG.replace(max_atoms=16, max_edges=64)
    jp = j_gnn.egnn_init(jax.random.PRNGKey(3), jcfg)
    jb, tb = _batch(16, 64, n=1, seed=2)
    want = np.asarray(j_gnn.egnn_apply(jp, jb, cfg=jcfg, impl="scatter"))
    return interop.to_torch(jp), tb, want


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_egnn_apply_full_width_matches_repro(full_width, impl):
    tp, tb, want = full_width
    cfg = t_gfm.CONFIG.replace(max_atoms=16, max_edges=64)
    assert (cfg.gnn_hidden, cfg.gnn_layers) == (866, 4)
    got = gnn.egnn_apply(tp, tb, cfg=cfg, impl=impl).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
