"""Per-client compute/bandwidth traces for the event-driven simulator (a
copy of the JAX package's ``repro/sim/traces.py``; numpy and the standard
library only, every float operation in the reference's order, so virtual
times agree with it exactly).

A :class:`TraceSet` fixes, for every client, a per-step compute time, a
link bandwidth, and a propagation latency, plus optional timed *episodes*
(stragglers and preemptions) that modulate compute progress.  Traces are
plain frozen data — hashable, JSON round-trippable — so a heterogeneous
swarm experiment is exactly reproducible from its config.

Delay model (DESIGN.md §9): a batch of ``nbytes`` flood bytes sent from
``i`` to ``j`` arrives after

    latency_s[i] + latency_s[j] + extra_latency + nbytes * 8 / min(bw_i, bw_j)

where the byte count is exactly what the :class:`~repro_torch.core.messages.
CommLedger` charges for the send (``len(msgs) * MESSAGE_BYTES``) — virtual
time and the paper's byte accounting derive from the same number.  Infinite
bandwidth (JSON ``null``) zeroes the serialization term; the all-defaults
:meth:`TraceSet.constant` trace is therefore the homogeneous zero-latency
trace under which the event loop must reproduce the synchronous Trainer
bitwise.

Episode semantics: within ``[t0, t1)`` a client's compute progresses at
rate ``1/factor`` (``straggle``) or stops entirely (``preempt``); progress
is integrated piecewise by :meth:`TraceSet.finish_time`.  Episodes of one
client must not overlap.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics

import numpy as np

EPISODE_KINDS = ("straggle", "preempt")


@dataclasses.dataclass(frozen=True)
class Episode:
    """One timed compute disruption of a single client."""
    client: int
    t0: float                  # virtual seconds, inclusive
    t1: float                  # virtual seconds, exclusive
    kind: str                  # "straggle" | "preempt"
    factor: float = 1.0        # straggle: slowdown multiplier (>= 1)

    def __post_init__(self):
        if self.kind not in EPISODE_KINDS:
            raise ValueError(f"unknown episode kind '{self.kind}' "
                             f"(have {EPISODE_KINDS})")
        if not self.t1 > self.t0 >= 0.0:
            raise ValueError(f"episode needs 0 <= t0 < t1, got "
                             f"[{self.t0}, {self.t1})")
        if self.kind == "straggle" and self.factor < 1.0:
            raise ValueError("straggle factor must be >= 1")

    @property
    def rate(self) -> float:
        """Compute progress per virtual second inside the episode."""
        return 0.0 if self.kind == "preempt" else 1.0 / self.factor


@dataclasses.dataclass(frozen=True)
class TraceSet:
    """Per-client compute/bandwidth/latency profile of one swarm."""
    compute_s: tuple[float, ...]        # base seconds per local step
    bandwidth_bps: tuple[float, ...]    # bits/s; math.inf = no serialization
    latency_s: tuple[float, ...]        # one-way propagation, per client
    episodes: tuple[Episode, ...] = ()

    def __post_init__(self):
        n = len(self.compute_s)
        if not (len(self.bandwidth_bps) == len(self.latency_s) == n > 0):
            raise ValueError("compute_s/bandwidth_bps/latency_s lengths differ")
        if any(c <= 0 for c in self.compute_s):
            raise ValueError("compute_s entries must be positive")
        if any(b <= 0 for b in self.bandwidth_bps):
            raise ValueError("bandwidth_bps entries must be positive")
        if any(ep.client not in range(n) for ep in self.episodes):
            raise ValueError("episode client out of range")
        for i in range(n):
            spans = sorted((ep.t0, ep.t1) for ep in self.episodes
                           if ep.client == i)
            for (_, a1), (b0, _) in zip(spans, spans[1:]):
                if b0 < a1:
                    raise ValueError(f"client {i} has overlapping episodes")

    @property
    def n(self) -> int:
        return len(self.compute_s)

    @property
    def ref_step_s(self) -> float:
        """Median per-step compute — the default virtual seconds one
        ChurnSchedule step index spans (``sim_churn_step_s`` overrides)."""
        return float(statistics.median(self.compute_s))

    # -- virtual-time arithmetic ----------------------------------------------

    def compute_time(self, client: int, step: int) -> float:
        """Base compute seconds of one local step (constant per client; the
        step argument keeps the signature ready for per-step traces)."""
        del step
        return self.compute_s[client]

    def finish_time(self, client: int, start: float, work_s: float) -> float:
        """Virtual time at which ``work_s`` seconds of full-rate compute
        starting at ``start`` completes, integrating episode rates."""
        t, remaining = start, work_s
        for ep in sorted((e for e in self.episodes if e.client == client),
                         key=lambda e: e.t0):
            if ep.t1 <= t:
                continue
            if ep.t0 > t:                      # full-rate gap before episode
                gap = ep.t0 - t
                if remaining <= gap:
                    return t + remaining
                t, remaining = ep.t0, remaining - gap
            span = ep.t1 - t
            if ep.rate > 0 and remaining <= span * ep.rate:
                return t + remaining / ep.rate
            t, remaining = ep.t1, remaining - span * ep.rate
        return t + remaining

    def edge_delay(self, i: int, j: int, nbytes: int,
                   extra_latency: float = 0.0) -> float:
        """Delivery delay of ``nbytes`` ledger-charged bytes over edge (i,j)."""
        lat = self.latency_s[i] + self.latency_s[j] + extra_latency
        bw = min(self.bandwidth_bps[i], self.bandwidth_bps[j])
        ser = 0.0 if math.isinf(bw) else nbytes * 8.0 / bw
        return lat + ser

    # -- builders -------------------------------------------------------------

    @classmethod
    def constant(cls, n: int, compute_s: float = 1.0,
                 bandwidth_bps: float = math.inf,
                 latency_s: float = 0.0) -> "TraceSet":
        """Homogeneous trace; all defaults = the zero-latency oracle trace."""
        return cls((float(compute_s),) * n, (float(bandwidth_bps),) * n,
                   (float(latency_s),) * n)

    @classmethod
    def two_speed(cls, n: int, fast_s: float = 1.0, slow_s: float = 4.0,
                  bandwidth_bps: float = math.inf,
                  latency_s: float = 0.0) -> "TraceSet":
        """First half of the swarm fast, second half slow — the benchmark's
        compute-heterogeneity shape (slow_s/fast_s = the heterogeneity ratio)."""
        comp = tuple(float(fast_s) if i < n - n // 2 else float(slow_s)
                     for i in range(n))
        return cls(comp, (float(bandwidth_bps),) * n, (float(latency_s),) * n)

    @classmethod
    def lognormal(cls, n: int, median_s: float = 1.0, sigma: float = 0.5,
                  seed: int = 0, bandwidth_bps: float = math.inf,
                  latency_s: float = 0.0) -> "TraceSet":
        """Lognormal-heterogeneous compute times (the SWARM-style long tail)."""
        rng = np.random.default_rng(seed)
        comp = median_s * np.exp(sigma * rng.standard_normal(n))
        return cls(tuple(float(c) for c in comp),
                   (float(bandwidth_bps),) * n, (float(latency_s),) * n)

    # -- JSON -----------------------------------------------------------------

    def to_json(self) -> dict:
        def bw(b: float):
            return None if math.isinf(b) else b
        return {
            "n": self.n,
            "compute_s": list(self.compute_s),
            "bandwidth_bps": [bw(b) for b in self.bandwidth_bps],
            "latency_s": list(self.latency_s),
            "episodes": [{"client": ep.client, "t0": ep.t0, "t1": ep.t1,
                          "kind": ep.kind, "factor": ep.factor}
                         for ep in self.episodes],
        }

    @classmethod
    def from_json(cls, d: dict) -> "TraceSet":
        comp = tuple(float(c) for c in d["compute_s"])
        n = int(d.get("n", len(comp)))
        if n != len(comp):
            raise ValueError(f"trace says n={n} but has {len(comp)} "
                             f"compute_s entries")
        bws = tuple(math.inf if b is None else float(b)
                    for b in d.get("bandwidth_bps", [None] * n))
        lats = tuple(float(x) for x in d.get("latency_s", [0.0] * n))
        eps = tuple(Episode(client=int(e["client"]), t0=float(e["t0"]),
                            t1=float(e["t1"]), kind=str(e["kind"]),
                            factor=float(e.get("factor", 1.0)))
                    for e in d.get("episodes", ()))
        return cls(comp, bws, lats, eps)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "TraceSet":
        with open(path) as f:
            return cls.from_json(json.load(f))


def as_trace(obj, n_clients: int) -> TraceSet:
    """Resolve ``DTrainConfig.trace`` — a TraceSet, a trace-JSON dict, or a
    path to one — and check it matches the swarm size."""
    if isinstance(obj, TraceSet):
        trace = obj
    elif isinstance(obj, dict):
        trace = TraceSet.from_json(obj)
    elif isinstance(obj, str):
        trace = TraceSet.load(obj)
    else:
        raise TypeError(f"trace must be a TraceSet, trace-JSON dict, or "
                        f"path, got {type(obj).__name__}")
    if trace.n != n_clients:
        raise ValueError(f"trace covers {trace.n} clients but the run has "
                         f"{n_clients}")
    return trace
