"""The port's serve hardening (on the CPU), with
``tests/test_serve_resilience.py``'s contracts: a dead worker fails EVERY
pending future at once (queued, in flight and binned — nothing hangs),
later submits raise ``ServeClosedError``, and ``restart_worker()`` recovers
with the shape cache intact; requests that age past ``max_queue_wait`` are
shed with ``DeadlineExceededError`` instead of computed; ``submit()`` under
backpressure gives up after ``admission_timeout`` in the caller's thread.

The recovered session is held against ``repro``'s ``predict_one`` on the
same params within ``TOL = 1e-4`` (fp32 forward, sums in another order),
as ``tests/test_torch_serve.py`` holds a healthy one."""
import threading
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.mtl import make_gfm_mtl
from repro.data.bucketing import BucketSpec as JBucketSpec
from repro.serve import ServeSession as JServeSession

from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic_atoms as t_atoms
from repro_torch.data.bucketing import BucketSpec
from repro_torch.serve import (DeadlineExceededError, ServeClosedError,
                               ServeMetrics, ServeSession)
from repro_torch.serve.queue import Request, RequestQueue, _as_sample

JCFG = JArchConfig(name="serve-res", family="gnn", gnn_hidden=16,
                   gnn_layers=2, n_species=64, head_hidden=8, head_layers=2,
                   remat=False, compute_dtype=jnp.float32)
CFG = ArchConfig(name="serve-res", gnn_hidden=16, gnn_layers=2,
                 n_species=64, head_hidden=8, head_layers=2,
                 compute_dtype=torch.float32)
SPEC = BucketSpec((8, 16), (32, 64))
TOL = 1e-4


@pytest.fixture(scope="module")
def served():
    sources = t_atoms.source_dicts(t_atoms.generate_mixture(
        24, max_atoms=16, max_edges=64))
    params = make_gfm_mtl(JCFG, len(sources)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params), sources


def _sample(sources, t=0, i=0):
    s = sources[t]
    i = i % s["species"].shape[0]
    return {k: s[k][i] for k in ("species", "pos", "edge_src", "edge_dst",
                                 "node_mask", "edge_mask")}


def _session(params, **kw):
    return ServeSession(params, CFG, spec=SPEC, device="cpu", **kw)


# ---------------------------------------------------------------------------
# worker-crash propagation + restart
# ---------------------------------------------------------------------------

def test_worker_crash_fails_all_pending_then_restart_recovers(served):
    """Kill the worker mid-backlog (batcher.add raises): every pending
    future — the request the worker had already dequeued too — fails with
    the crash error, new submits raise ServeClosedError, and
    restart_worker() brings the session back with its shape cache."""
    params, sources = served
    srv = _session(params, max_batch=4, max_wait_ms=2.0)
    try:
        release = threading.Event()

        def dying_add(req):
            # hold the worker here so more requests queue behind the one
            # being filed, then detonate
            release.wait(timeout=10)
            raise RuntimeError("batcher exploded")

        srv.batcher.add = dying_add
        f1 = srv.submit(_sample(sources, 0), head=0)
        f2 = srv.submit(_sample(sources, 1), head=1)
        release.set()
        for f in (f1, f2):                     # nothing hangs
            with pytest.raises(RuntimeError, match="batcher exploded"):
                f.result(timeout=30)
        srv._worker.join(timeout=10)
        assert not srv._worker.is_alive()

        with pytest.raises(ServeClosedError, match="restart_worker"):
            srv.submit(_sample(sources, 0))
        # ServeClosedError IS a RuntimeError matching "closed"
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(_sample(sources, 0))

        compiled_before = len(srv._shapes_compiled)
        assert srv.restart_worker() is True
        sm = _sample(sources, 2)
        got = srv.submit(sm, head=2).result(timeout=60)
        ref = srv.predict_one(sm, head=2)
        assert got["energy"] == ref["energy"]
        np.testing.assert_array_equal(got["forces"], ref["forces"])
        assert len(srv._shapes_compiled) >= compiled_before

        c = srv.stats()["counters"]
        assert c["worker_failures"] == 1
        assert c["worker_restarts"] == 1
        assert c["failed"] >= 2
    finally:
        srv.close()


def test_recovered_session_matches_repro(served):
    """After a crash and a restart, served rows still agree with
    ``repro``'s single-device session on the same params."""
    params, sources = served
    jobs = [(t, _sample(sources, t, i)) for t in range(len(sources))
            for i in range(2)]
    with JServeSession(params, JCFG, spec=JBucketSpec((8, 16), (32, 64)),
                       max_batch=4) as ref:
        want = [ref.predict_one(sm, head=t) for t, sm in jobs]
    srv = _session(params, max_batch=4, max_wait_ms=2.0)
    try:
        srv.batcher.add = lambda req: 1 / 0
        with pytest.raises(ZeroDivisionError):
            srv.submit(jobs[0][1], head=0).result(timeout=30)
        srv._worker.join(timeout=10)
        assert srv.restart_worker() is True
        got = [f.result(timeout=60)
               for f in [srv.submit(sm, head=t) for t, sm in jobs]]
    finally:
        srv.close()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["energy"], w["energy"], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(g["forces"], w["forces"], atol=TOL,
                                   rtol=TOL)


def test_restart_worker_is_noop_when_healthy_and_raises_when_closed(served):
    params, _ = served
    srv = _session(params, max_batch=2)
    assert srv.restart_worker() is False
    assert srv.stats()["counters"]["worker_restarts"] == 0
    srv.close()
    with pytest.raises(ServeClosedError):
        srv.restart_worker()
    with pytest.raises(ServeClosedError):
        srv.submit({"species": np.zeros(2, np.int32),
                    "pos": np.zeros((2, 3), np.float32)})


# ---------------------------------------------------------------------------
# deadlines: queue-wait shedding + admission timeout
# ---------------------------------------------------------------------------

def test_submit_stamps_queue_wait_deadline(served):
    _, sources = served
    q = RequestQueue(SPEC, depth=4, n_heads=3, max_queue_wait=0.05)
    q.submit(_sample(sources, 0), head=0)
    req = q.get(timeout=1.0)
    assert req is not None
    assert req.deadline == pytest.approx(req.t_submit + 0.05)


def test_worker_sheds_requests_past_their_deadline(served):
    """Hand _file a request whose deadline is already past: its future
    fails with DeadlineExceededError, the shed is counted, and the request
    never reaches the batcher."""
    params, sources = served
    srv = _session(params, max_batch=4, max_queue_wait_ms=50.0)
    srv.close()                                # worker quiesced; _file is ours
    canon, n_atoms, n_edges = _as_sample(_sample(sources, 0))
    req = Request(sample=canon, head=0,
                  bucket=SPEC.bucket_for(n_atoms, n_edges),
                  n_atoms=n_atoms, n_edges=n_edges, future=Future(),
                  t_submit=0.0, deadline=-1.0)
    assert srv._file(req) is None
    with pytest.raises(DeadlineExceededError):
        req.future.result(timeout=0)
    assert srv.stats()["counters"]["shed_deadline"] == 1
    assert srv.batcher.pending_requests() == []


def test_admission_timeout_sheds_in_caller_thread(served):
    """depth=1 and no consumer: the first submit takes the only slot, the
    second gives up after admission_timeout in the CALLER's thread."""
    _, sources = served
    m = ServeMetrics()
    q = RequestQueue(SPEC, depth=1, n_heads=3, admission_timeout=0.05,
                     metrics=m)
    q.submit(_sample(sources, 0), head=0)
    with pytest.raises(DeadlineExceededError, match="saturated"):
        q.submit(_sample(sources, 1), head=1)
    assert m.counters["shed_admission"] == 1
    assert m.counters["submitted"] == 1        # the shed one never counted


def test_closed_queue_rejects_submits_with_closed_error(served):
    _, sources = served
    q = RequestQueue(SPEC, depth=2, n_heads=3)
    q.close()
    with pytest.raises(ServeClosedError):
        q.submit(_sample(sources, 0))
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(_sample(sources, 0))
    q.close()                                  # idempotent re-entry
