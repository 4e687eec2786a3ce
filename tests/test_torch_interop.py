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


# ---------------------------------------------------------------------------
# bf16 leaves cross bit for bit
# ---------------------------------------------------------------------------

def _bf16_bits(x):
    """The 16-bit patterns of a bf16 leaf (JAX, ml_dtypes, |V2 or torch)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _bf16_tree():
    """A JAX bf16 tree with signed zeros, infinities, NaN, subnormals and a
    0-d leaf, beside an f32 leaf."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1.0, -2.5, np.inf, -np.inf, np.nan,
                        1e-40, 3.0e38], np.float32)
    return {"w": jnp.asarray(rng.standard_normal((4, 5)), jnp.bfloat16),
            "special": jnp.asarray(special, jnp.bfloat16),
            "scalar": jnp.asarray(1.5, jnp.bfloat16),
            "f32": jnp.asarray(rng.standard_normal(3), jnp.float32)}


def test_jax_bf16_tree_round_trips_bitwise():
    tree = _bf16_tree()
    tp = interop.to_torch(tree)
    assert tp["w"].dtype == torch.bfloat16 and tp["scalar"].shape == ()
    assert tp["f32"].dtype == torch.float32
    back = interop.to_numpy(tp)
    for k in ("w", "special", "scalar"):
        assert back[k].dtype == np.asarray(tree[k]).dtype, k
        np.testing.assert_array_equal(_bf16_bits(tp[k]), _bf16_bits(tree[k]))
        np.testing.assert_array_equal(_bf16_bits(back[k]),
                                      _bf16_bits(tree[k]))
    np.testing.assert_array_equal(back["f32"], np.asarray(tree["f32"]))


def test_torch_bf16_tree_to_numpy_bitwise():
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((3, 7), generator=g).bfloat16(),
            "strided": torch.randn((6, 4), generator=g).bfloat16()[:, ::2],
            "nested": ({"s": torch.tensor(-0.0).bfloat16()},)}
    got = interop.to_numpy(tree)
    assert got["a"].dtype.name == "bfloat16"
    for x, y in ((tree["a"], got["a"]), (tree["strided"], got["strided"]),
                 (tree["nested"][0]["s"], got["nested"][0]["s"])):
        assert y.shape == tuple(x.shape)
        np.testing.assert_array_equal(_bf16_bits(y),
                                      _bf16_bits(x.contiguous()))
    # and back: the same tensors, bit for bit
    again = interop.to_torch(got)
    assert torch.equal(again["a"].view(torch.int16),
                       tree["a"].view(torch.int16))


def test_repro_bf16_checkpoint_restores_into_port(tmp_path):
    tree = _bf16_tree()
    path = str(tmp_path / "ck_bf16")
    j_ckpt.save(path, {"params": tree})
    template = {"params": {k: torch.empty(np.shape(v), device="meta",
                                          dtype=interop.to_torch(v).dtype)
                           for k, v in tree.items()}}
    got = t_ckpt.restore(path, template)["params"]
    for k in ("w", "special", "scalar"):
        np.testing.assert_array_equal(_bf16_bits(got[k]), _bf16_bits(tree[k]))
        assert interop.to_torch(got[k]).dtype == torch.bfloat16
    np.testing.assert_array_equal(got["f32"], np.asarray(tree["f32"]))


def test_port_bf16_leaf_saves_as_repro_does(tmp_path):
    tree = _bf16_tree()
    j_ckpt.save(str(tmp_path / "repro"), tree)
    t_ckpt.save(str(tmp_path / "port"), interop.to_torch(tree))
    with np.load(tmp_path / "repro.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
    assert np.load(tmp_path / "port.npz")["w"].dtype.str == "|V2"
    # and the port reads its own bf16 checkpoint back, bit for bit
    template = {k: torch.empty(np.shape(v), device="meta",
                               dtype=interop.to_torch(v).dtype)
                for k, v in tree.items()}
    back = t_ckpt.restore(str(tmp_path / "port"), template)
    np.testing.assert_array_equal(_bf16_bits(back["special"]),
                                  _bf16_bits(tree["special"]))


def test_import_pins_bf16_gemm_reduction_to_f32():
    import repro_torch
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_bf16_without_ml_dtypes_crosses_as_uint16_bits(tmp_path,
                                                       monkeypatch):
    """Where ``ml_dtypes`` is not installed, a bf16 tensor comes out as its
    ``uint16`` patterns, still saves in ``repro``'s ``|V2`` layout, and
    ``bf16_from_numpy`` turns the patterns back into the same tensor."""
    import sys
    tree = _bf16_tree()
    j_ckpt.save(str(tmp_path / "repro"), tree)
    tp = interop.to_torch(tree)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    bits = interop.to_numpy(tp["special"])
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, _bf16_bits(tree["special"]))
    assert torch.equal(interop.bf16_from_numpy(bits).view(torch.int16),
                       tp["special"].view(torch.int16))
    t_ckpt.save(str(tmp_path / "port"), tp)
    with np.load(tmp_path / "repro.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
    template = {k: torch.empty(v.shape, device="meta", dtype=v.dtype)
                for k, v in tp.items()}
    back = t_ckpt.restore(str(tmp_path / "repro"), template)
    assert back["w"].dtype == np.uint16
    np.testing.assert_array_equal(back["w"], _bf16_bits(tree["w"]))
