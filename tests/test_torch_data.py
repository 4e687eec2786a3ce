"""The port's data pipeline and optimizer against ``repro``'s.

  * synthetic labels: the same structures (identical draws) and labels —
    energies within 1e-5 relative (float32 potential summed in another
    order), forces within 1e-5 x max(1, max|F|) (torch autograd against
    jax.grad, fp32);
  * ``GroupBatcher``: byte-identical batch streams, through
    ``state()``/``restore()`` (JSON round trip, across packages), with and
    without the ``Prefetcher``;
  * AdamW and ``warmup_cosine``: one update against ``repro``'s on the
    same tree within 1e-6 (fp32 elementwise, the global norm summed in
    another leaf order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_atoms as j_atoms
from repro.data.loader import GroupBatcher as JGroupBatcher
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine

from repro_torch import interop
from repro_torch.data import synthetic_atoms as t_atoms
from repro_torch.data.loader import GroupBatcher
from repro_torch.data.prefetch import DevicePlacer, Prefetcher
from repro_torch.optim import adamw, global_norm, warmup_cosine


@pytest.fixture(scope="module")
def both_sources():
    kw = dict(max_atoms=16, max_edges=64, seed=3)
    return j_atoms.generate_all(10, **kw), t_atoms.generate_all(10, **kw)


@pytest.mark.parametrize("name", list(t_atoms.SOURCES))
def test_labels_match_repro(both_sources, name):
    j, t = both_sources[0][name], both_sources[1][name]
    for k in ("species", "pos", "edge_src", "edge_dst", "node_mask",
              "edge_mask"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), k)
    for k in ("energy", "e_true"):
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(t.forces, j.forces, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(j.forces).max()))
    assert t.forces.dtype == np.float32 and t.energy.dtype == np.float32


def test_source_dicts_carry_labels(both_sources):
    got = t_atoms.source_dicts(both_sources[1])
    want = j_atoms.source_dicts(both_sources[0])
    assert [sorted(d) for d in got] == [sorted(d) for d in want]


def _stream(batcher, n):
    return [batcher.next_batch() for _ in range(n)]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        np.testing.assert_array_equal(x, np.asarray(b[k]), err_msg=k)


def test_group_batcher_streams_match_repro_through_restore(both_sources):
    # sources of different sizes wrap independently (epochs mid-stream)
    srcs = [dict(d, **{k: v[:n] for k, v in d.items()}) for d, n in
            zip(t_atoms.source_dicts(both_sources[1]), (10, 7, 5, 9, 3))]
    tb, jb = GroupBatcher(srcs, 4, seed=5), JGroupBatcher(srcs, 4, seed=5)
    for a, b in zip(_stream(tb, 6), _stream(jb, 6)):
        _equal(a, b)
    snap = json.loads(json.dumps(tb.state()))
    want = _stream(tb, 5)
    # restore the snapshot into a fresh batcher of each package
    for fresh in (GroupBatcher(srcs, 4, seed=0), JGroupBatcher(srcs, 4,
                                                              seed=0)):
        fresh.restore(snap)
        for a, b in zip(_stream(fresh, 5), want):
            _equal(a, b)


def test_prefetcher_keeps_the_stream_and_its_position(both_sources):
    srcs = t_atoms.source_dicts(both_sources[1])
    want = _stream(GroupBatcher(srcs, 3, seed=1), 8)
    placer = DevicePlacer("cpu")
    with Prefetcher(GroupBatcher(srcs, 3, seed=1), transform=placer,
                    depth=2) as pf:
        got = [placer.ready(pf.next_batch()) for _ in range(3)]
        snap = pf.state()           # consumed position, not read-ahead
        got.append(placer.ready(pf.next_batch()))
        pf.restore(snap)
        got += [placer.ready(pf.next_batch()) for _ in range(4)]
    assert all(isinstance(v, torch.Tensor) for v in got[0].values())
    for a, b in zip(got[:4] + got[5:], want[:4] + want[4:]):
        _equal(a, b)
    _equal(got[4], want[3])         # replayed after the restore


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"shared": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)},
            "heads": {"w": rng.standard_normal((3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("clip,warmup", [(0.0, 0), (0.5, 3)])
def test_adamw_matches_repro(clip, warmup):
    params, grads = _tree(0), _tree(1)
    lr_j = j_warmup_cosine(1e-2, warmup, 10) if warmup else 1e-2
    lr_t = warmup_cosine(1e-2, warmup, 10) if warmup else 1e-2
    jo = j_adamw(lr_j, weight_decay=0.05, grad_clip=clip)
    to = adamw(lr_t, weight_decay=0.05, grad_clip=clip)
    jp, js = jax.tree_util.tree_map(jnp.asarray, params), None
    tp = interop.to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):               # moments and bias corrections move
        g = _tree(10 + step)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = to.update(interop.to_torch(g), ts, tp)
    assert ts.step == int(js.step) == 3
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for k, v in interop.leaves(want).items():
            np.testing.assert_allclose(interop.leaves(got)[k].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_schedule_and_global_norm_match_repro():
    j = j_warmup_cosine(3e-3, 4, 20, floor=1e-4)
    t = warmup_cosine(3e-3, 4, 20, floor=1e-4)
    for step in range(0, 25):
        assert float(t(step)) == pytest.approx(float(j(jnp.asarray(step))),
                                               rel=1e-6)
    tree = _tree(4)
    from repro.optim.adamw import global_norm as j_global_norm
    assert float(global_norm(interop.to_torch(tree))) == pytest.approx(
        float(j_global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        rel=1e-6)
