"""The port's sharded store and the loaders around it against ``repro``'s,
on the same seeded inputs.

  * ``write_store`` / ``ShardedSource``: a store written by either package
    is read by the other, sample for sample; the shard cache plateaus;
  * ``GroupBatcher`` over gather-style sources with ``drop_keys`` and
    ``SingleBatcher``: byte-identical streams through ``state()`` /
    ``restore()`` (JSON round trip, either package);
  * ``PrefetchingBatcher`` over a store written by either package: the
    placed tensors equal ``repro``'s numpy batches byte for byte, through
    ``state()``/``restore()``;
  * the ``Prefetcher``'s injected producer fault: it surfaces at the
    consumer, and ``restore(state())`` continues the stream unchanged;
  * a ``Session`` fed by a ``PrefetchingBatcher`` ends bitwise equal to the
    in-memory session (3 steps, on the CPU).
"""
import json

import numpy as np
import pytest
import torch

from repro.data.loader import GroupBatcher as JGroupBatcher
from repro.data.loader import SingleBatcher as JSingleBatcher
from repro.data.store import PrefetchingBatcher as JPrefetchingBatcher
from repro.data.store import ShardedSource as JShardedSource
from repro.data.store import write_store as j_write_store

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.data.loader import GroupBatcher, SingleBatcher
from repro_torch.data.prefetch import DevicePlacer, Prefetcher
from repro_torch.data.store import (PrefetchingBatcher, ShardedSource,
                                    write_store)
from repro_torch.data.synthetic_atoms import generate_all, source_dicts
from repro_torch.engine import Session, SessionConfig
from repro_torch.resilience import ProducerKilled

WRITERS = {"port": write_store, "repro": j_write_store}


@pytest.fixture(scope="module")
def sources():
    return source_dicts(generate_all(13, max_atoms=16, max_edges=64,
                                     seed=2))[:3]


def _store(tmp_path, sources, writer):
    paths = []
    for i, s in enumerate(sources):
        p = str(tmp_path / f"{writer}{i}")
        WRITERS[writer](p, s, shard_size=5)
        paths.append(p)
    return paths


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        np.testing.assert_array_equal(x, np.asarray(b[k]), err_msg=k)
        assert x.dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("writer", list(WRITERS))
def test_store_reads_across_packages(tmp_path, sources, writer):
    paths = _store(tmp_path, sources, writer)
    idx = np.array([3, 12, 0, 7, 5, 4, 11])
    for p, s in zip(paths, sources):
        t, j = ShardedSource(p), JShardedSource(p)
        assert len(t) == len(j) == len(s["energy"])
        assert t.keys == j.keys == sorted(s)
        _equal(t.gather(idx), j.gather(idx))
        _equal(t.gather(idx), {k: v[idx] for k, v in s.items()})
    assert json.load(open(f"{paths[0]}/manifest.json"))["shard_size"] == 5


def test_shard_cache_plateaus(tmp_path, sources):
    src = ShardedSource(_store(tmp_path, sources, "port")[0])
    rng = np.random.default_rng(0)
    for _ in range(20):
        src.gather(rng.integers(0, len(src), 6))
    assert src.fetches == 3 and src.hits > 0      # 13 samples, 3 shards
    with pytest.raises(ValueError, match="length"):
        write_store(str(tmp_path / "bad"), {"a": np.zeros(3),
                                            "b": np.zeros(4)})


@pytest.mark.parametrize("writer", list(WRITERS))
def test_group_batcher_over_gather_sources_with_drop_keys(tmp_path, sources,
                                                          writer):
    readers = [ShardedSource(p) for p in _store(tmp_path, sources, writer)]
    tb = GroupBatcher(readers, 4, seed=6, drop_keys=("forces",))
    jb = JGroupBatcher(sources, 4, seed=6, drop_keys=("forces",))
    for _ in range(5):
        a, b = tb.next_batch(), jb.next_batch()
        assert "forces" not in a
        _equal(a, b)
    snap = json.loads(json.dumps(tb.state()))
    want = [jb.next_batch() for _ in range(4)]
    for fresh in (GroupBatcher(readers, 4, drop_keys=("forces",)),
                  JGroupBatcher(sources, 4, drop_keys=("forces",))):
        fresh.restore(snap)
        for w in want:
            _equal(fresh.next_batch(), w)


def test_single_batcher_matches_repro_through_restore(sources):
    tb, jb = SingleBatcher(sources[0], 5, seed=3), JSingleBatcher(
        sources[0], 5, seed=3)
    for _ in range(4):
        _equal(tb.next_batch(), jb.next_batch())
    snap = json.loads(json.dumps(tb.state()))
    assert snap == json.loads(json.dumps(jb.state()))
    want = [jb.next_batch() for _ in range(3)]
    for fresh in (SingleBatcher(sources[0], 5), JSingleBatcher(sources[0],
                                                                5)):
        fresh.restore(snap)
        for w in want:
            _equal(fresh.next_batch(), w)
    with pytest.raises(ValueError, match="SingleBatcher"):
        tb.restore({"kind": "GroupBatcher"})


@pytest.mark.parametrize("writer", list(WRITERS))
def test_prefetching_batcher_places_repro_stream(tmp_path, sources, writer):
    paths = _store(tmp_path, sources, writer)
    want = JPrefetchingBatcher([JShardedSource(p) for p in paths], 3, seed=1)
    with want, PrefetchingBatcher([ShardedSource(p) for p in paths], 3,
                                  seed=1, depth=2, device="cpu") as pb:
        for _ in range(4):
            got = pb.next_batch()
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            _equal(got, want.next_batch())
        snap = json.loads(json.dumps(pb.state()))
        assert snap == json.loads(json.dumps(want.state()))
        tail = [want.next_batch() for _ in range(3)]
        pb.next_batch()                 # one past the snapshot, replayed
        pb.restore(snap)
        for w in tail:
            _equal(pb.next_batch(), w)


def test_producer_fault_surfaces_and_restore_continues_the_stream(sources):
    want = GroupBatcher(sources, 2, seed=8)
    want = [want.next_batch() for _ in range(8)]
    placer = DevicePlacer("cpu")
    with Prefetcher(GroupBatcher(sources, 2, seed=8), transform=placer,
                    depth=2) as pf:
        got = [placer.ready(pf.next_batch()) for _ in range(2)]
        pf.inject_producer_fault(ProducerKilled("test"))
        with pytest.raises(ProducerKilled):
            for _ in range(6):          # the queued batches, then the fault
                got.append(placer.ready(pf.next_batch()))
        pf.restore(pf.state())
        while len(got) < 8:
            got.append(placer.ready(pf.next_batch()))
        assert iter(pf) is pf
    for a, b in zip(got, want):
        _equal(a, b)


def test_session_over_prefetching_batcher_equals_in_memory(tmp_path,
                                                           sources):
    paths = _store(tmp_path, sources, "port")
    cfg = SessionConfig(model="gfm-mtl", arch=t_gfm.smoke().replace(
        segment_sum_impl="fused"), steps=3, batch_per_task=4, lr=1e-3,
        warmup=2, log_every=1, verbose=False, seed=0, bucketing=2)
    with Session(cfg, sources=sources, device="cpu") as mem:
        want = mem.run()
    with PrefetchingBatcher([ShardedSource(p) for p in paths], 4, seed=0,
                            device="cpu") as pb, \
            Session(cfg, batcher=pb, device="cpu") as st:
        assert st.task_names == ["task0", "task1", "task2"]
        got = st.run()
        assert st.datapipe_state()["inner"] == mem.datapipe_state()["inner"]
    for k, v in interop.leaves(want.params).items():
        assert torch.equal(interop.leaves(got.params)[k], v), k
    assert [r["loss"] for r in got.logger.history] == \
        [r["loss"] for r in want.logger.history]
