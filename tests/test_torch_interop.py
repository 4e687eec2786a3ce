"""Parameter trees and checkpoints move between ``repro`` and the port
exactly: same leaves, same bits, same ``/``-joined checkpoint keys."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import hydragnn_gfm as j_gfm
from repro.core.mtl import make_gfm_mtl
from repro.train import checkpoint as j_ckpt

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.core.mtl import gfm_mtl_init
from repro_torch.train import checkpoint as t_ckpt


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "uncertainty"])
def jax_params(request):
    model = make_gfm_mtl(j_gfm.smoke(), 3, uncertainty=request.param)
    return model.init(jax.random.PRNGKey(0))


def _assert_same_tree(a, b):
    la, lb = interop.leaves(a), interop.leaves(b)
    assert set(la) == set(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_jax_tree_round_trips_exactly(jax_params):
    tp = interop.to_torch(jax_params)
    # heads stay stacked (T, ...) and dense weights keep (d_in, d_out)
    H = j_gfm.smoke().gnn_hidden
    assert tuple(tp["heads"]["energy"]["fc0"]["w"].shape)[:2] == (3, H)
    assert tuple(tp["shared"]["layer0"]["phi_e"]["fc0"]["w"].shape) == \
        (2 * H + 1, H)
    _assert_same_tree(interop.to_numpy(tp), jax_params)
    # leaves are copies: writing the port's tree leaves the source alone
    tp["shared"]["embed"]["table"].add_(1.0)
    assert not np.array_equal(tp["shared"]["embed"]["table"].numpy(),
                              np.asarray(jax_params["shared"]["embed"]["table"]))


def test_repro_checkpoint_restores_into_port(jax_params, tmp_path):
    path = str(tmp_path / "ck")
    j_ckpt.save(path, {"params": jax_params}, metadata={"step": 7})
    uncertainty = "log_sigma2" in jax_params["heads"]
    template = gfm_mtl_init(t_gfm.smoke(), 3, device="meta",
                            uncertainty=uncertainty)
    got = t_ckpt.restore(path, {"params": template})["params"]
    _assert_same_tree(got, jax_params)
    assert t_ckpt.load_metadata(path) == {"step": 7}


def test_port_checkpoint_restores_into_repro(jax_params, tmp_path):
    path = str(tmp_path / "ck_port.npz")
    t_ckpt.save(path, {"params": interop.to_torch(jax_params)})
    template = jax.eval_shape(lambda: jax_params)
    got = j_ckpt.restore(path, {"params": template})["params"]
    _assert_same_tree(got, jax_params)


def test_restore_rejects_a_mismatched_template(jax_params, tmp_path):
    path = str(tmp_path / "ck")
    j_ckpt.save(path, {"params": jax_params})
    wide = gfm_mtl_init(t_gfm.smoke().replace(gnn_hidden=32), 3,
                        device="meta")
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore(path, {"params": wide})
    with pytest.raises(KeyError):
        t_ckpt.restore(path, {"params": {"missing": torch.empty(1)}})
