"""The port's ServeSession (on the CPU) against ``repro``'s, and the
serving contracts it keeps: batched rows bitwise equal to ``predict_one``,
a lone request flushes at ``max_wait``, ``close()`` drains, checkpoints
written by ``repro`` serve, and the data side (synthetic structures, bucket
grid) is identical to ``repro``'s.

Tolerance against ``repro``: 1e-4 on energies and forces (fp32 forward of
two EGNN layers and the heads; sums in another order)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.mtl import make_gfm_mtl
from repro.data import synthetic_atoms as j_atoms
from repro.data.bucketing import BucketSpec as JBucketSpec
from repro.serve import ServeSession as JServeSession
from repro.train import checkpoint as j_ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic_atoms as t_atoms
from repro_torch.data.bucketing import BucketOverflowError, BucketSpec
from repro_torch.serve import ServeSession

JCFG = JArchConfig(name="serve-test", family="gnn", gnn_hidden=16,
                   gnn_layers=2, n_species=64, head_hidden=8, head_layers=2,
                   remat=False, compute_dtype=jnp.float32)
CFG = ArchConfig(name="serve-test", gnn_hidden=16, gnn_layers=2,
                 n_species=64, head_hidden=8, head_layers=2,
                 compute_dtype=torch.float32)
SPEC = BucketSpec((8, 16), (32, 64))
TOL = 1e-4


@pytest.fixture(scope="module")
def served():
    # the port's generator: same structures as repro's (last test)
    sources = t_atoms.source_dicts(t_atoms.generate_mixture(
        40, max_atoms=16, max_edges=64))
    params = make_gfm_mtl(JCFG, len(sources)).init(jax.random.PRNGKey(0))
    return params, sources


def _sample(sources, t, i):
    s = sources[t]
    i = i % s["species"].shape[0]
    return {k: s[k][i] for k in ("species", "pos", "edge_src", "edge_dst",
                                 "node_mask", "edge_mask")}


def _session(params, **kw):
    kw.setdefault("spec", SPEC)
    return ServeSession(params, CFG, device="cpu", **kw)


def test_port_serving_matches_repro(served):
    params, sources = served
    jobs = [(t, _sample(sources, t, i)) for t in range(len(sources))
            for i in range(2)]
    with JServeSession(params, JCFG, spec=JBucketSpec((8, 16), (32, 64)),
                       max_batch=4, max_wait_ms=2.0) as ref, \
            _session(params, max_batch=4, max_wait_ms=2.0) as srv:
        want = [f.result(timeout=120) for f in
                [ref.submit(sm, head=t) for t, sm in jobs]]
        got = [f.result(timeout=120) for f in
               [srv.submit(sm, head=t) for t, sm in jobs]]
    for (t, sm), g, w in zip(jobs, got, want):
        np.testing.assert_allclose(g["energy"], w["energy"], atol=TOL,
                                   rtol=TOL, err_msg=f"head {t}")
        assert g["forces"].shape == w["forces"].shape
        np.testing.assert_allclose(g["forces"], w["forces"], atol=TOL,
                                   rtol=TOL, err_msg=f"head {t}")


def test_batched_rows_bitwise_equal_predict_one(served):
    params, sources = served
    with _session(params, max_batch=4, max_wait_ms=2.0) as srv:
        jobs = [(t, _sample(sources, t, i))
                for t in range(len(sources)) for i in range(3)]
        futs = [(t, sm, srv.submit(sm, head=t)) for t, sm in jobs]
        for t, sm, fut in futs:
            got = fut.result(timeout=60)
            one = srv.predict_one(sm, head=t)
            assert got["energy"] == one["energy"], (t, got, one)
            np.testing.assert_array_equal(got["forces"], one["forces"])
            assert got["forces"].shape == (int(sm["node_mask"].sum()), 3)


def test_lone_request_flushes_at_deadline(served):
    params, sources = served
    with _session(params, max_batch=64, max_wait_ms=20.0) as srv:
        assert srv.warmup() == SPEC.n_shapes
        fut = srv.submit(_sample(sources, 0, 0), head=0)
        t0 = time.monotonic()
        out = fut.result(timeout=10)        # would hang if it waited for 64
        assert time.monotonic() - t0 < 5.0
        assert np.isfinite(out["energy"])
        c = srv.stats()["counters"]
        assert c["batches"] >= 1 and c["batch_real"] < c["batch_slots"]


def test_close_drains_in_flight_requests(served):
    params, sources = served
    srv = _session(params, max_batch=8, max_wait_ms=10_000.0)
    futs = [srv.submit(_sample(sources, t, i), head=t)
            for t in range(3) for i in range(3)]
    srv.close()
    for f in futs:
        assert np.isfinite(f.result(timeout=1)["energy"])
    srv.close()                              # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_sample(sources, 0, 0), head=0)
    snap = srv.stats()
    assert snap["counters"]["completed"] == len(futs)
    assert snap["executable_cache"]["compiled_shapes"] <= SPEC.n_shapes
    assert not srv._worker.is_alive()


def test_admission_and_counters(served):
    params, sources = served
    with _session(params, max_batch=4, max_wait_ms=1.0) as srv:
        for t in range(len(sources)):
            srv.submit(_sample(sources, t, 0), head=t)
        with pytest.raises(ValueError):
            srv.submit(_sample(sources, 0, 0), head=99)
        with pytest.raises(BucketOverflowError):
            srv.submit({"species": np.ones(40, np.int32),
                        "pos": np.zeros((40, 3), np.float32)}, head=0)
        srv.close()
        c = srv.stats()["counters"]
    assert c["submitted"] == c["completed"] == len(sources)
    assert c["rejected"] == 2 and c["failed"] == 0
    assert c["compilations"] <= SPEC.n_shapes


def test_from_checkpoint_serves_repro_checkpoint(served, tmp_path):
    params, sources = served
    path = str(tmp_path / "ck")
    j_ckpt.save(path, {"params": params})
    srv = ServeSession.from_checkpoint(path, CFG, n_heads=len(sources),
                                       spec=SPEC, max_wait_ms=1.0,
                                       device="cpu")
    with srv, _session(params, max_wait_ms=1.0) as direct:
        sm = _sample(sources, 3, 1)
        a = srv.submit(sm, head=3).result(timeout=30)
        b = direct.submit(sm, head=3).result(timeout=30)
    assert a["energy"] == b["energy"]
    np.testing.assert_array_equal(a["forces"], b["forces"])


def test_same_structures_and_bucket_grid_as_repro():
    kw = dict(max_atoms=64, max_edges=2048, seed=3)
    want = j_atoms.generate_mixture(25, **kw)
    got = t_atoms.generate_mixture(25, **kw)
    assert list(want) == list(got)
    for name in want:
        for k in ("species", "pos", "edge_src", "edge_dst", "node_mask",
                  "edge_mask"):
            np.testing.assert_array_equal(getattr(got[name], k),
                                          getattr(want[name], k),
                                          err_msg=f"{name}.{k}")
    spec_j = JBucketSpec.from_sources(j_atoms.source_dicts(want))
    spec_t = BucketSpec.from_sources(t_atoms.source_dicts(got))
    assert (spec_t.atom_buckets, spec_t.edge_buckets) == \
        (spec_j.atom_buckets, spec_j.edge_buckets)
    for n_atoms, n_edges in ((1, 1), (20, 300), (64, 2048)):
        assert spec_t.bucket_for(n_atoms, n_edges) == \
            spec_j.bucket_for(n_atoms, n_edges)
