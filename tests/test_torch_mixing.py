"""The port's multi-source mixing (``repro_torch.data.mixing``) and its
``Session`` wiring against ``repro``'s, on the same seeded inputs.

  * ``mix_weights`` / ``MixingConfig.resolve``: equal to ``repro``'s (same
    float64 arithmetic, compared exactly);
  * ``MixingBatcher``, flat and task-major, with and without
    ``emit_source``: byte-identical batch streams, across ``set_weights``
    (a quarantine and the source's return, whose stale credit is reset),
    through a JSON round trip of ``state()`` restored in either package,
    over in-memory and gather-style sources;
  * ``Session``: GFM-Baseline-All (one branch over the mixture) and
    MTL-All with mixing turned into loss weights — loss trajectories
    within 1e-4 relative of ``repro``'s over 4 steps (fp32 drift); the
    sampling quarantine of a mixture source as ``repro`` applies it.
"""
import json

import jax
import numpy as np
import pytest

from repro.configs import hydragnn_gfm as j_gfm
from repro.data.mixing import MixingBatcher as JMixingBatcher
from repro.data.mixing import MixingConfig as JMixingConfig
from repro.data.mixing import mix_weights as j_mix_weights
from repro.data.synthetic_atoms import generate_mixture, source_dicts
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.data.mixing import MixingBatcher, MixingConfig, mix_weights
from repro_torch.data.store import ShardedSource, write_store
from repro_torch.engine import Session, SessionConfig
from repro_torch.engine.session import _as_bucket_spec, _as_mixing


def _toy(sizes, offset=1000):
    """Source s holds samples whose values encode (s, sample index)."""
    return [{"x": (offset * s + np.arange(n)).astype(np.int64),
             "y": np.full((n, 2), s, np.float32),
             "extra": np.zeros(n, np.int8)}
            for s, n in enumerate(sizes)]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("sizes,temperature,weights", [
    ([100, 400], 1.0, None), ([97, 31, 9, 250], 2.0, None),
    ([10, 10, 7], 1e12, None), ([5, 6], 1.0, (3, 1)),
    ([4, 8, 16, 32, 64], 0.5, None)])
def test_mix_weights_match_repro(sizes, temperature, weights):
    got = mix_weights(sizes, temperature=temperature, weights=weights)
    want = j_mix_weights(sizes, temperature=temperature, weights=weights)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        MixingConfig(temperature, weights).resolve(sizes),
        JMixingConfig(temperature, weights).resolve(sizes))


def test_mix_weights_validation():
    with pytest.raises(ValueError, match="temperature"):
        mix_weights([100, 400], temperature=0.0)
    with pytest.raises(ValueError, match="positive"):
        mix_weights([10, 10], weights=(1, -1))
    with pytest.raises(ValueError, match="at least one"):
        MixingBatcher([], 4)


CASES = {"flat": dict(task_major=False, emit=False),
         "flat-emit-source": dict(task_major=False, emit=True),
         "task-major": dict(task_major=True, emit=False)}


@pytest.mark.parametrize("case", list(CASES))
def test_mixing_stream_matches_repro_through_set_weights_and_restore(case):
    c = CASES[case]
    srcs = _toy([37, 11, 5, 23])
    kw = dict(seed=3, drop_keys=("extra",), task_major=c["task_major"])
    tb = MixingBatcher(srcs, 7, mixing=MixingConfig(
        temperature=1.5, emit_source=c["emit"]), **kw)
    jb = JMixingBatcher(srcs, 7, mixing=JMixingConfig(
        temperature=1.5, emit_source=c["emit"]), **kw)
    for _ in range(9):                   # source 2 wraps its epoch
        _equal(tb.next_batch(), jb.next_batch())
    # quarantine source 1, then bring it back: its credit restarts at 0
    for w in ([1.0, 0.0, 1.0, 1.0], [0.2, 0.5, 0.1, 0.2]):
        tb.set_weights(w)
        jb.set_weights(w)
        np.testing.assert_array_equal(tb.credit, jb.credit)
        for _ in range(4):
            a, b = tb.next_batch(), jb.next_batch()
            _equal(a, b)
    snap = json.loads(json.dumps(tb.state()))
    assert snap == json.loads(json.dumps(jb.state()))
    want = [jb.next_batch() for _ in range(6)]
    for fresh in (MixingBatcher(srcs, 7, mixing=MixingConfig(
            emit_source=c["emit"]), **kw),
            JMixingBatcher(srcs, 7, mixing=JMixingConfig(
                emit_source=c["emit"]), **kw)):
        fresh.restore(snap)
        for w in want:
            _equal(fresh.next_batch(), w)
    if c["task_major"]:
        assert want[0]["x"].shape == (1, 7)


def test_mixing_over_gather_sources_matches_repro(tmp_path):
    srcs = _toy([40, 9, 17])
    readers = []
    for i, s in enumerate(srcs):
        write_store(str(tmp_path / f"s{i}"), s, shard_size=8)
        readers.append(ShardedSource(str(tmp_path / f"s{i}")))
    tb = MixingBatcher(readers, 6, seed=1, drop_keys=("extra",))
    jb = JMixingBatcher(srcs, 6, seed=1, drop_keys=("extra",))
    for _ in range(12):
        _equal(tb.next_batch(), jb.next_batch())
    with pytest.raises(ValueError, match="sources"):
        MixingBatcher(readers[:2], 6).restore(tb.state())


def test_set_weights_validation():
    tb = MixingBatcher(_toy([5, 5]), 2)
    with pytest.raises(ValueError, match="every"):
        tb.set_weights([0.0, 0.0])
    with pytest.raises(ValueError, match=">= 0"):
        tb.set_weights([1.0, -1.0])
    with pytest.raises(ValueError, match="weights for"):
        tb.set_weights([1.0])


def test_session_mixing_shorthands():
    assert _as_mixing(None) is None
    assert _as_mixing(2.0) == MixingConfig(temperature=2.0)
    assert _as_mixing((1, 3)) == MixingConfig(weights=(1, 3))
    mc = MixingConfig(temperature=3.0)
    assert _as_mixing(mc) is mc
    with pytest.raises(TypeError):
        _as_mixing("proportional")
    with pytest.raises(TypeError, match="ambiguous"):
        _as_mixing(True)
    with pytest.raises(TypeError, match="ambiguous"):
        _as_bucket_spec(True, None, None)


@pytest.fixture(scope="module")
def mixture():
    cfg = j_gfm.smoke()
    return source_dicts(generate_mixture(40, max_atoms=cfg.max_atoms,
                                         max_edges=cfg.max_edges, seed=0))


def _sessions(sources, **kw):
    """repro's and the port's Session, the port from repro's initial
    params."""
    common = dict(steps=4, lr=1e-3, warmup=2, log_every=1, verbose=False,
                  seed=0, **kw)
    js = JSession.from_config(JSessionConfig(arch=j_gfm.smoke(), **common),
                              sources=sources)
    ts = Session.from_config(SessionConfig(
        arch=t_gfm.smoke().replace(segment_sum_impl="fused"), **common),
        sources=sources, device="cpu")
    p0 = interop.to_torch(js.state.params)
    ts.state = ts.state._replace(params=p0,
                                 opt_state=ts.optimizer.init(p0))
    return js, ts


def _losses(result, keys=("loss",)):
    return {k: [r[k] for r in result.logger.history] for k in keys}


@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_session_baseline_all_matches_repro(mixture, temperature):
    js, ts = _sessions(mixture, model="gfm-baseline", batch_per_task=6,
                       mixing=temperature)
    assert isinstance(ts.batcher, MixingBatcher) and ts.batcher.task_major
    assert ts.task_names == ["task0"] and ts.model.n_tasks == 1
    with js, ts:
        jr, tr = js.run(), ts.run()
    np.testing.assert_allclose(_losses(tr)["loss"], _losses(jr)["loss"],
                               rtol=1e-4)
    assert all(v.shape[0] == 1
               for v in interop.leaves(tr.params["heads"]).values())
    assert ts.datapipe_state() == json.loads(json.dumps(js.datapipe_state()))


def test_session_mtl_mixing_becomes_loss_weights(mixture):
    js, ts = _sessions(mixture, model="gfm-mtl", batch_per_task=3,
                       mixing=2.0)
    np.testing.assert_array_equal(ts.task_weights, js.task_weights)
    sizes = [len(s["energy"]) for s in mixture]
    np.testing.assert_array_equal(ts.task_weights,
                                  mix_weights(sizes, temperature=2.0))
    with js, ts:
        jr, tr = js.run(), ts.run()
    keys = ("loss",) + tuple(f"task{t}" for t in range(len(mixture)))
    got, want = _losses(tr, keys), _losses(jr, keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_session_quarantines_a_mixture_source_as_repro_does(mixture):
    js, ts = _sessions(mixture, model="gfm-baseline", batch_per_task=8,
                       mixing=1.0, prefetch=False)
    for s in (js, ts):
        s.quarantine_tasks([1, 3])
    np.testing.assert_array_equal(ts.batcher.weights, js.batcher.weights)
    assert ts._quarantined_sources == {1, 3} and not ts._quarantined
    for _ in range(3):
        _equal(ts.batcher.next_batch(), js.batcher.next_batch())
    # a restored pre-quarantine snapshot is re-zeroed
    ts.batcher.restore(MixingBatcher(mixture, 8, mixing=MixingConfig(),
                                     task_major=True).state())
    ts._reapply_quarantine()
    assert ts.batcher.weights[1] == ts.batcher.weights[3] == 0.0
    with pytest.raises(ValueError, match="every"):
        ts.quarantine_tasks(range(len(mixture)))
    jax.clear_caches()
