"""The port's head-placement vocabulary and balancing helpers against
``repro``'s (``repro_torch.core.taskpar`` / ``core.balancing`` vs
``repro.core``), case for case with tests/test_placement.py:

  * ``solve_placement`` over the seeded sweep of (devices, heads, mix
    weights), the pinned paper mix and the edge cases: EQUAL placements
    (groups, device counts and the recorded loads, exactly);
  * ``round_robin_placement``, ``group_loads``, ``max_group_load``,
    ``group_of`` and ``memory_per_device``: equal values;
  * ``HeadPlacement``'s validation: the port raises ``ValueError`` (and
    ``KeyError`` from ``group_of``) exactly where ``repro`` asserts;
  * ``fit_reference_energies`` / ``align_sources``: within 1e-12 (the same
    numpy operations); ``uncertainty_weighted_loss``: within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HeadPlacement as JHeadPlacement
from repro.core import balancing as jbal
from repro.core import memory_per_device as j_memory_per_device
from repro.core import round_robin_placement as j_round_robin
from repro.core import solve_placement as j_solve
from repro.data.synthetic_atoms import PAPER_REL_SIZES

from repro_torch.core import (HeadPlacement, balancing, hier_batch_spec,
                              memory_per_device, round_robin_placement,
                              solve_placement)


def _sweep_cases():
    """tests/test_placement.py's sweep, drawn the same way."""
    rng = np.random.default_rng(1234)
    cases = []
    for n_dev in (1, 2, 3, 5, 8, 13, 16):
        for n_heads in (1, 2, 3, 5, 8, 11):
            w = rng.gamma(shape=1.0, scale=1.0, size=n_heads) + 1e-3
            cases.append(pytest.param(n_dev, n_heads, tuple(w),
                                      id=f"d{n_dev}h{n_heads}"))
    return cases


SWEEP = _sweep_cases()

EXTRA = [  # test_placement.py's pinned and edge cases
    pytest.param(8, list(PAPER_REL_SIZES.values()), id="paper-mix-d8"),
    pytest.param(3, [5, 1, 1, 1, 1, 1, 5, 5], id="more-heads-than-devices"),
    pytest.param(3, [1.0, 0.0, 0.0, 0.0], id="zero-load-heads"),
    pytest.param(1, [1, 2, 3], id="single-device"),
    pytest.param(4, [1, 1, 2], id="recorded-loads"),
]


def _same(port, ref):
    assert port.groups == ref.groups
    assert port.device_counts == ref.device_counts
    assert port.loads == ref.loads


@pytest.mark.parametrize("n_dev,n_heads,w", SWEEP)
@pytest.mark.parametrize("seed", [0, 7])
def test_solve_placement_equals_repro(n_dev, n_heads, w, seed):
    _same(solve_placement(n_dev, w, seed=seed), j_solve(n_dev, w, seed=seed))


@pytest.mark.parametrize("n_dev,w", EXTRA)
def test_solve_placement_equals_repro_pinned(n_dev, w):
    p, j = solve_placement(n_dev, w), j_solve(n_dev, w)
    _same(p, j)
    assert p.max_group_load() == j.max_group_load()
    assert p.group_loads() == j.group_loads()


def test_paper_mix_on_8_devices():
    """The configuration the task-parallel path runs on 8 ranks."""
    p = solve_placement(8, list(PAPER_REL_SIZES.values()))
    assert p.groups == ((0,), (1,), (2,), (3,), (4,))
    assert p.device_counts == (2, 1, 3, 1, 1)


@pytest.mark.parametrize("n_dev,n_heads,w", SWEEP)
def test_round_robin_and_loads_equal_repro(n_dev, n_heads, w):
    rr, jrr = round_robin_placement(n_heads, n_dev), j_round_robin(n_heads,
                                                                  n_dev)
    _same(rr, jrr)
    wn = tuple(float(x) / sum(w) for x in w)
    assert rr.group_loads(wn) == jrr.group_loads(wn)
    assert rr.max_group_load(wn) == jrr.max_group_load(wn)
    assert rr.group_loads() == jrr.group_loads()
    assert rr.n_heads == jrr.n_heads and rr.n_groups == jrr.n_groups
    assert rr.n_devices == jrr.n_devices
    for h in range(n_heads):
        assert rr.group_of(h) == jrr.group_of(h)


BAD = [  # test_placement.py's invalid layouts
    pytest.param(dict(groups=((0,), (2,)), device_counts=(1, 1)),
                 id="missing-head"),
    pytest.param(dict(groups=((0, 1), (1,)), device_counts=(1, 1)),
                 id="duplicate-head"),
    pytest.param(dict(groups=((0,), (1,)), device_counts=(2, 0)),
                 id="zero-device-group"),
    pytest.param(dict(groups=((0, 1), ()), device_counts=(1, 1)),
                 id="headless-group"),
    pytest.param(dict(groups=((0, 1),), device_counts=(2,), loads=(1.0,)),
                 id="loads-length"),
    pytest.param(dict(groups=((0,), (1,)), device_counts=(1,)),
                 id="counts-length"),
]


@pytest.mark.parametrize("kw", BAD)
def test_head_placement_validation_matches_repro(kw):
    with pytest.raises(AssertionError):
        JHeadPlacement(**kw)
    with pytest.raises(ValueError):
        HeadPlacement(**kw)


def test_group_of_matches_repro():
    kw = dict(groups=((0, 2), (1,)), device_counts=(1, 3))
    p, j = HeadPlacement(**kw), JHeadPlacement(**kw)
    assert [p.group_of(h) for h in range(3)] == \
        [j.group_of(h) for h in range(3)]
    for place in (p, j):
        with pytest.raises(KeyError):
            place.group_of(3)


@pytest.mark.parametrize("loads", [[], [0.0, 0.0], [1.0, -0.5]])
def test_bad_loads_rejected_like_repro(loads):
    with pytest.raises(AssertionError):
        j_solve(4, loads)
    with pytest.raises(ValueError):
        solve_placement(4, loads)


def test_zero_devices_rejected_like_repro():
    with pytest.raises(AssertionError):
        j_solve(0, [1.0])
    with pytest.raises(ValueError):
        solve_placement(0, [1.0])


@pytest.mark.parametrize("p_s,p_h,n,mode", [
    (100, 10, 4, "par"), (100, 10, 4, "base"),
    (18_070_000, 4_710_000, 5, "par"), (18_070_000, 4_710_000, 5, "base")])
def test_memory_per_device_equals_repro(p_s, p_h, n, mode):
    assert memory_per_device(p_s, p_h, n, mode) == \
        j_memory_per_device(p_s, p_h, n, mode)


@pytest.mark.parametrize("B,n", [(8, 1), (8, 2), (8, 3), (8, 8), (5, 2),
                                 (40, 8)])
def test_hier_batch_spec_matches_repro_rule(B, n):
    """Rows split evenly over a group's ranks, replicated when ragged
    (``repro.configs.sharding.hier_batch_spec``): the rows of all ranks
    cover B once, or each rank holds all of B."""
    from jax.sharding import PartitionSpec as P

    from repro.configs.sharding import hier_batch_spec as j_spec
    spec = j_spec(np.zeros((1, B, 3)), n)
    rows = [np.arange(B)[hier_batch_spec(B, n, i)] for i in range(n)]
    if spec == P(None, None, None):
        assert all(np.array_equal(r, np.arange(B)) for r in rows)
    else:
        assert np.array_equal(np.concatenate(rows), np.arange(B))
        assert len({len(r) for r in rows}) == 1


def _sources(seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        species = rng.integers(0, 9, size=(40, 12))
        species[:, 0] = np.maximum(species[:, 0], 1)
        counts = np.stack([(species == z).sum(1) for z in range(9)], 1)
        e_ref = rng.normal(size=9) * (s + 1)
        energy = counts @ e_ref + rng.normal(size=40) * 0.01
        out.append({"species": species, "energy": energy})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alignment_equals_repro(seed):
    srcs = _sources(seed)
    for s in srcs:
        np.testing.assert_allclose(
            balancing.fit_reference_energies(s["species"], s["energy"], 9),
            jbal.fit_reference_energies(s["species"], s["energy"], 9),
            rtol=0, atol=1e-12)
        np.testing.assert_array_equal(
            balancing.composition_matrix(s["species"], 9),
            jbal.composition_matrix(s["species"], 9))
    got, want = balancing.align_sources(srcs, 9), jbal.align_sources(srcs, 9)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("energy", "e_ref"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_terms", [2, 5])
def test_uncertainty_weighted_loss_equals_repro(n_terms):
    rng = np.random.default_rng(n_terms)
    s = rng.normal(size=n_terms).astype(np.float32)
    losses = rng.uniform(0.1, 5.0, size=n_terms).astype(np.float32)
    want = float(jbal.uncertainty_weighted_loss(
        {"log_sigma2": jnp.asarray(s)}, jnp.asarray(losses)))
    got = balancing.uncertainty_weighted_loss(
        {"log_sigma2": torch.from_numpy(s)}, torch.from_numpy(losses))
    np.testing.assert_allclose(float(got), want, rtol=0,
                               atol=1e-6 * max(1.0, abs(want)))
    init = balancing.uncertainty_weights_init(n_terms)["log_sigma2"]
    assert init.shape == (n_terms,) and float(init.abs().sum()) == 0.0
