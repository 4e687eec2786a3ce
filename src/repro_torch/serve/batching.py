"""Continuous size-binned request batching (a copy of
``repro.serve.batching``; the port does not import ``repro``).

Training already solved the padding-waste-vs-recompile tradeoff with
``BucketSpec`` (quantized pad-shape grids, ``repro.data.bucketing``); at
serving time the SAME grid becomes the coalescing rule: requests whose
(atom, edge) counts land in the same bucket are padded to one shared shape
and run as one batch, so the compiled-shape universe of the serving engine
is exactly the training bucket grid.

"Continuous" in the vLLM sense, adapted to fixed-shape batches: the
binner never waits for an epoch or a fixed batch — as requests stream in it
holds at most one open bin per (bucket, head) and releases it the moment it
is **full** (``max_batch`` requests) or **expired** (its oldest request has
waited ``max_wait``). The deadline bounds tail latency under low arrival
rates: a lone request costs at most ``max_wait`` + one forward, it never
waits for a full batch that will not come.

The released batch is padded to a STATIC shape (``max_batch`` rows at the
bucket's (A_pad, E_pad)) with inert rows — all-pad structures whose node
masks are empty and whose edges point at the ``A_pad`` sentinel (the
``>= n_nodes`` kernel contract, see docs/kernels.md) — so partial flushes
reuse the full batch's executable instead of compiling a (k, ...) variant
per occupancy k.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .queue import Request


@dataclasses.dataclass
class AssembledBatch:
    """One ready-to-run padded batch: ``batch`` is the (max_batch, A_pad,
    ...) dict the compiled forward takes; ``requests`` (length ``n_real``
    <= max_batch) maps row i back to the future to resolve."""
    batch: dict
    requests: list[Request]
    bucket: tuple
    head: int

    @property
    def n_real(self) -> int:
        return len(self.requests)


def assemble(requests: list[Request], bucket: tuple,
             max_batch: int) -> AssembledBatch:
    """Pad-and-stack admitted requests into one (max_batch, A_pad/E_pad)
    batch. Every request must already be binned into ``bucket`` (admission
    guarantees content fits); rows beyond ``len(requests)`` are inert pad
    structures. Edge endpoints of masked/pad edges are re-pointed at the
    ``A_pad`` sentinel — same contract as ``BucketingBatcher``."""
    assert 1 <= len(requests) <= max_batch, (len(requests), max_batch)
    a_pad, e_pad = bucket
    head = requests[0].head
    B = max_batch
    species = np.zeros((B, a_pad), np.int32)
    pos = np.zeros((B, a_pad, 3), np.float32)
    src = np.full((B, e_pad), a_pad, np.int32)
    dst = np.full((B, e_pad), a_pad, np.int32)
    nmask = np.zeros((B, a_pad), bool)
    emask = np.zeros((B, e_pad), bool)
    for i, r in enumerate(requests):
        assert r.bucket == bucket and r.head == head, \
            "batcher invariant: one (bucket, head) per assembled batch"
        s = r.sample
        nm, em = s["node_mask"], s["edge_mask"]
        # stored arrays may be longer than the bucket (a small structure
        # submitted in a big padded container): admission checked CONTENT
        # fits, so trailing storage beyond A_pad/E_pad is pad by contract
        na = min(nm.shape[0], a_pad)
        ne = min(em.shape[0], e_pad)
        # admission enforces front-packed masks and bucket_for sized the
        # bucket to the content, so the tail beyond the bucket is pure pad
        assert not (nm[na:].any() or em[ne:].any()), \
            "assemble invariant: real content beyond the assigned bucket"
        species[i, :na] = np.where(nm[:na], s["species"][:na], 0)
        pos[i, :na] = np.where(nm[:na, None], s["pos"][:na], 0.0)
        nmask[i, :na] = nm[:na]
        emask[i, :ne] = em[:ne]
        src[i, :ne] = np.where(em[:ne], s["edge_src"][:ne], a_pad)
        dst[i, :ne] = np.where(em[:ne], s["edge_dst"][:ne], a_pad)
    return AssembledBatch(
        batch={"species": species, "pos": pos, "edge_src": src,
               "edge_dst": dst, "node_mask": nmask, "edge_mask": emask},
        requests=list(requests), bucket=bucket, head=head)


class AdaptivePolicy:
    """Move the (max_batch, max_wait) knee per (bucket, head) bin from the
    measured arrival rate instead of serving fixed knobs.

    The PR 6 bench showed the knee shifts with model size and load, so a
    static (max_batch, max_wait) is only right at one operating point. The
    policy keeps, per bin key, an EWMA of the inter-arrival gap (from
    ``t_submit`` stamps — the shared engine clock) and of released-bin
    occupancy, and derives:

      * ``target_rows(key)`` — how many rows are worth waiting for: the
        arrivals expected inside the base window (capped at ``max_batch``).
        Under saturating load this is ``max_batch``; at low rates it decays
        to 1 so lone requests release immediately.
      * ``wait(key)`` — how long the oldest request may wait: just long
        enough for ``target_rows`` arrivals (``(rows-1) * gap``), floored at
        ``min_wait`` and capped at the configured ``max_wait``.

    Only RELEASE timing adapts — the assembled batch is always padded to the
    static ``max_batch`` rows, so the compiled-shape universe (and the
    compile budget) is untouched. All inputs come through injected clocks/
    stamps: under a fake clock the policy is fully deterministic.
    """

    def __init__(self, *, max_batch: int, max_wait: float,
                 min_wait: float = 2e-4, alpha: float = 0.2):
        assert max_batch >= 1 and max_wait >= 0.0
        assert 0.0 <= min_wait <= max(max_wait, min_wait)
        assert 0.0 < alpha <= 1.0
        self.max_batch = max_batch
        self.base_wait = max_wait
        self.min_wait = min(min_wait, max_wait) if max_wait > 0 else 0.0
        self.alpha = alpha
        self._gap: dict[tuple, float] = {}    # key -> EWMA inter-arrival (s)
        self._last: dict[tuple, float] = {}   # key -> last arrival stamp
        self._occ: dict[tuple, float] = {}    # key -> EWMA released rows

    def observe_arrival(self, key: tuple, t: float):
        last = self._last.get(key)
        self._last[key] = t
        if last is None:
            return
        gap = max(t - last, 1e-9)
        g = self._gap.get(key)
        self._gap[key] = gap if g is None \
            else (1.0 - self.alpha) * g + self.alpha * gap

    def observe_release(self, key: tuple, occupancy: int):
        o = self._occ.get(key)
        self._occ[key] = float(occupancy) if o is None \
            else (1.0 - self.alpha) * o + self.alpha * occupancy

    def target_rows(self, key: tuple) -> int:
        g = self._gap.get(key)
        if g is None:                 # no rate estimate yet: be patient
            return self.max_batch
        expect = int(self.base_wait / g) + 1
        return max(1, min(self.max_batch, expect))

    def wait(self, key: tuple) -> float:
        g = self._gap.get(key)
        if g is None:
            return self.base_wait
        if g > self.base_wait:        # nothing else is coming in the window
            return self.min_wait
        return min(self.base_wait,
                   max((self.target_rows(key) - 1) * g, self.min_wait))

    def snapshot(self) -> dict:
        """Per-key effective knobs (JSON-safe), for stats()/bench output."""
        keys = sorted(self._last)
        return {repr(k): {"gap_ms": self._gap.get(k, 0.0) * 1e3,
                          "wait_ms": self.wait(k) * 1e3,
                          "target_rows": self.target_rows(k),
                          "occupancy_ewma": self._occ.get(k, 0.0)}
                for k in keys}


class SizeBinnedBatcher:
    """Accumulate requests into per-(bucket, head) bins; release full or
    expired bins. Single-consumer (the engine worker owns it) — no locking.

    max_batch: rows per compiled batch (the static leading dim).
    max_wait:  seconds the OLDEST request of a bin may wait before the bin
               is flushed partially filled (the p99 bound at low rates).
    clock:     the shared engine clock; ``expired``/``next_deadline`` use it
               when the caller passes no ``now``, so bin-age math always
               lives on the same base as ``t_submit``.
    policy:    optional ``AdaptivePolicy`` — replaces the fixed release
               knobs with measured-rate per-bin ones (release shape is
               still the static ``max_batch``).
    """

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.005,
                 clock=time.monotonic, policy: AdaptivePolicy | None = None):
        assert max_batch >= 1 and max_wait >= 0.0
        if policy is not None:
            assert policy.max_batch == max_batch, \
                "policy and batcher must agree on the static batch shape"
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._clock = clock
        self.policy = policy
        self._bins: dict[tuple, list[Request]] = {}   # (bucket, head) -> reqs

    # per-bin effective knobs: fixed, unless a policy is measuring
    def _wait(self, key: tuple) -> float:
        return self.max_wait if self.policy is None else self.policy.wait(key)

    def _target(self, key: tuple) -> int:
        return self.max_batch if self.policy is None \
            else self.policy.target_rows(key)

    def add(self, req: Request) -> AssembledBatch | None:
        """File one request; returns an AssembledBatch immediately when it
        fills its bin (to the policy's target under adaptation), else None
        (the bin keeps waiting)."""
        key = (req.bucket, req.head)
        if self.policy is not None:
            self.policy.observe_arrival(key, req.t_submit)
        bin_ = self._bins.setdefault(key, [])
        bin_.append(req)
        if len(bin_) >= self._target(key):
            del self._bins[key]
            return self._release(key, bin_)
        return None

    def _release(self, key: tuple, bin_: list[Request]) -> AssembledBatch:
        if self.policy is not None:
            self.policy.observe_release(key, len(bin_))
        return assemble(bin_, key[0], self.max_batch)

    def expired(self, now: float | None = None) -> list[AssembledBatch]:
        """Bins whose oldest request has waited past its wait budget,
        assembled (possibly partial). Deterministic order: by that oldest
        timestamp."""
        if now is None:
            now = self._clock()
        due = [(bin_[0].t_submit, key) for key, bin_ in self._bins.items()
               if now - bin_[0].t_submit >= self._wait(key)]
        return [self._release(key, self._bins.pop(key))
                for _, key in sorted(due)]

    def flush(self) -> list[AssembledBatch]:
        """Assemble every pending bin regardless of age (shutdown drain)."""
        out = [self._release(key, bin_)
               for key, bin_ in sorted(self._bins.items(),
                                       key=lambda kv: kv[1][0].t_submit)]
        self._bins.clear()
        return out

    def next_deadline(self, now: float | None = None) -> float | None:
        """Seconds until the earliest pending bin expires (<= 0: already
        due); None when no bins are waiting. The engine worker uses this as
        its queue-poll timeout so deadline flushes fire on time."""
        if now is None:
            now = self._clock()
        if not self._bins:
            return None
        due = min(bin_[0].t_submit + self._wait(key)
                  for key, bin_ in self._bins.items())
        return due - now

    @property
    def n_pending(self) -> int:
        return sum(len(b) for b in self._bins.values())

    def pending_requests(self) -> list[Request]:
        """The raw requests still binned, without assembling (failure-path
        cleanup: resolve their futures even when assembly itself is what
        broke)."""
        return [r for b in self._bins.values() for r in b]
