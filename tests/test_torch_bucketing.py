"""The port's size-bucketed batching (``repro_torch.data.bucketing``)
against ``repro``'s, on the same seeded inputs.

  * ``BucketSpec.ceil`` / ``bucket_for``, ``from_sources`` (in-memory and
    gather-style) and ``pad_fraction``: equal to ``repro``'s;
  * ``BucketingBatcher`` over a task-major ``GroupBatcher`` and a flat
    ``MixingBatcher``: byte-identical batch streams (the sentinel
    re-pointing included) and equal ``shapes_seen``, through a JSON round
    trip of ``state()`` restored in either package, and from a bare inner
    state; the same trim on batches already placed as tensors;
  * ``Session(bucketing=...)``: the loss trajectory within 1e-4 relative of
    ``repro``'s over 4 steps (fp32 drift), and the trimmed batch's loss
    within 1e-6 relative of the untrimmed batch's (only padding goes; the
    sums run over other tile shapes).
"""
import json

import numpy as np
import pytest
import torch

from repro.configs import hydragnn_gfm as j_gfm
from repro.data.bucketing import BucketingBatcher as JBucketingBatcher
from repro.data.bucketing import BucketSpec as JBucketSpec
from repro.data.bucketing import pad_fraction as j_pad_fraction
from repro.data.loader import GroupBatcher as JGroupBatcher
from repro.data.mixing import MixingBatcher as JMixingBatcher
from repro.data.synthetic_atoms import generate_mixture, source_dicts
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.core.mtl import make_gfm_mtl
from repro_torch.data.bucketing import (ATOM_KEYS, EDGE_KEYS,
                                        BucketingBatcher, BucketOverflowError,
                                        BucketSpec, pad_fraction)
from repro_torch.data.loader import GroupBatcher
from repro_torch.data.mixing import MixingBatcher
from repro_torch.data.store import ShardedSource, write_store
from repro_torch.engine import Session, SessionConfig, multitask_grad_fn


@pytest.fixture(scope="module")
def sources():
    """Stored pad shape (48, 512) well above the content (5-32 atoms)."""
    return source_dicts(generate_mixture(60, max_atoms=48, max_edges=512,
                                         seed=0))


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        np.testing.assert_array_equal(x, np.asarray(b[k]), err_msg=k)
        assert x.dtype == np.asarray(b[k]).dtype, k


def test_keys_and_ceil_match_repro():
    from repro.data import bucketing as jb
    assert (ATOM_KEYS, EDGE_KEYS) == (jb.ATOM_KEYS, jb.EDGE_KEYS)
    t, j = BucketSpec((8, 16, 32), (64, 256)), JBucketSpec((8, 16, 32),
                                                           (64, 256))
    for a in range(0, 33, 3):
        for e in (0, 1, 63, 64, 65, 200, 256):
            assert t.ceil(a, e) == j.ceil(a, e) == t.bucket_for(a, e)
    with pytest.raises(BucketOverflowError):
        t.ceil(33, 1)
    with pytest.raises(BucketOverflowError):
        t.ceil(1, 257)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_from_sources_matches_repro_in_memory_and_gather(sources, tmp_path,
                                                         n):
    want = JBucketSpec.from_sources(sources, n_atom_buckets=n,
                                    n_edge_buckets=n)
    assert BucketSpec.from_sources(sources, n_atom_buckets=n,
                                   n_edge_buckets=n) == BucketSpec(
        want.atom_buckets, want.edge_buckets)
    readers = []
    for i, s in enumerate(sources):
        write_store(str(tmp_path / f"s{i}"), s, shard_size=7)
        readers.append(ShardedSource(str(tmp_path / f"s{i}")))
    got = BucketSpec.from_sources(readers, n_atom_buckets=n,
                                  n_edge_buckets=n)
    assert (got.atom_buckets, got.edge_buckets) == (want.atom_buckets,
                                                    want.edge_buckets)


def _pair(sources, kind):
    """(port, repro) BucketingBatchers; task-major over the two sources of
    the smallest graphs, so batches meet several buckets."""
    if kind == "task-major":
        sources = sources[:2]
    spec = JBucketSpec.from_sources(sources, n_atom_buckets=3,
                                    n_edge_buckets=3)
    tspec = BucketSpec(spec.atom_buckets, spec.edge_buckets)
    if kind == "task-major":
        inner = (GroupBatcher(sources, 2, seed=4),
                 JGroupBatcher(sources, 2, seed=4))
    else:
        inner = (MixingBatcher(sources, 5, seed=4),
                 JMixingBatcher(sources, 5, seed=4))
    return (BucketingBatcher(inner[0], tspec),
            JBucketingBatcher(inner[1], spec))


@pytest.mark.parametrize("kind", ["task-major", "flat-mixing"])
def test_bucketed_stream_matches_repro_through_restore(sources, kind):
    tb, jb = _pair(sources, kind)
    for _ in range(8):
        a, b = tb.next_batch(), jb.next_batch()
        _equal(a, b)
        assert pad_fraction(a) == j_pad_fraction(b)
    assert tb.shapes_seen == jb.shapes_seen and len(tb.shapes_seen) > 1
    snap = json.loads(json.dumps(tb.state()))
    assert snap == json.loads(json.dumps(jb.state()))
    want = [jb.next_batch() for _ in range(5)]
    for fresh in _pair(sources, kind):
        fresh.restore(snap)
        assert fresh.shapes_seen == tb.shapes_seen
        for w in want:
            _equal(fresh.next_batch(), w)
    # a bare inner state restores the stream and keeps no shapes
    fresh = _pair(sources, kind)[0]
    fresh.restore(snap["inner"])
    assert fresh.shapes_seen == set()
    _equal(fresh.next_batch(), want[0])


@pytest.mark.parametrize("kind", ["task-major", "flat-mixing"])
def test_bucketing_placed_tensors_equals_numpy(sources, kind):
    """The trim of a batch already placed as tensors (here on the CPU)
    gives the numpy trim's values, contiguous."""
    ref, _ = _pair(sources, kind)

    class Placed:
        def __init__(self, b):
            self.b = b

        def next_batch(self):
            return {k: torch.from_numpy(v) for k, v in
                    self.b.next_batch().items()}

    placed = BucketingBatcher(Placed(_pair(sources, kind)[0].batcher),
                              ref.spec)
    for _ in range(6):
        a, b = placed.next_batch(), ref.next_batch()
        _equal(a, b)
        assert all(v.is_contiguous() for v in a.values())
        assert pad_fraction(a) == pad_fraction(b)
    assert placed.shapes_seen == ref.shapes_seen


def test_strict_trim_refuses_masks_that_are_not_front_packed(sources):
    class Shuffled:
        sources = None

        def __init__(self, b):
            self.b = b

        def next_batch(self):
            out = dict(self.b.next_batch())
            out["node_mask"] = out["node_mask"][..., ::-1].copy()
            return out

    tb, _ = _pair(sources, "task-major")
    with pytest.raises(ValueError, match="front-packed"):
        BucketingBatcher(Shuffled(tb.batcher), tb.spec).next_batch()


def test_session_bucketed_trajectory_matches_repro(sources):
    common = dict(model="gfm-mtl", steps=4, batch_per_task=3, lr=1e-3,
                  warmup=2, log_every=1, verbose=False, seed=0, bucketing=3,
                  mixing=1.0)
    srcs = sources[:3]
    js = JSession.from_config(JSessionConfig(arch=j_gfm.smoke(), **common),
                              sources=srcs)
    ts = Session.from_config(SessionConfig(
        arch=t_gfm.smoke().replace(segment_sum_impl="fused"), **common),
        sources=srcs, device="cpu")
    p0 = interop.to_torch(js.state.params)
    ts.state = ts.state._replace(params=p0, opt_state=ts.optimizer.init(p0))
    with js, ts:
        jr, tr = js.run(), ts.run()
    np.testing.assert_allclose([r["loss"] for r in tr.logger.history],
                               [r["loss"] for r in jr.logger.history],
                               rtol=1e-4)
    assert ts.batcher.shapes_seen == js.batcher.shapes_seen
    assert ts.datapipe_state() == json.loads(json.dumps(js.datapipe_state()))


@pytest.mark.parametrize("impl", ["fused", "jnp"])
def test_trimmed_batch_loss_equals_untrimmed(sources, impl):
    tb, _ = _pair(sources, "task-major")
    full = GroupBatcher(sources[:2], 2, seed=4).next_batch()
    cut = tb.next_batch()
    assert cut["node_mask"].shape[-1] < full["node_mask"].shape[-1]
    assert cut["edge_mask"].shape[-1] < full["edge_mask"].shape[-1]
    model = make_gfm_mtl(t_gfm.smoke().replace(segment_sum_impl=impl), 2)
    params = model.init(0)
    fn = multitask_grad_fn(model, 2)
    (lf, _, _), (lc, _, _) = (
        fn(params, {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()}) for b in (full, cut))
    np.testing.assert_allclose(float(lc), float(lf), rtol=1e-6)
