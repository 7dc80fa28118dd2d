"""Decentralized training entry point of the port: ``DTrainConfig``,
``validate_config`` and ``run``.

    from repro_torch.dtrain.runner import DTrainConfig, run
    result = run(DTrainConfig(method="dsgd", n_clients=8, steps=3))  # on the card

Every method of the paper's §4.2 runs through the registry
(``repro_torch.dtrain.methods.METHOD_SPECS``), each a Method composed with
a Transport and driven by the one ``Trainer``, on any static topology of
``topology.graphs``:

  seedflood     flooding of seed–scalar ZO messages + SubCGE aggregation
  dzsgd         ZO local steps + gossip model averaging
  dsgd          FO local steps + gossip model averaging
  choco         FO + compressed-difference gossip, 99 % top-k
  dsgd_lora / dzsgd_lora / choco_lora   — adapters-only training + gossip
  gossip_sr     gossip with shared randomness (the §3.2 strawman; O(tnd))
  central_zo    centralized n-perturbation ZO (+ subspace ``momentum``)

Runs can be subjected to churn (``churn``: a ``ChurnSchedule`` or a
``ChurnConfig``; seedflood and the gossip variants) and checkpointed and
resumed bitwise (``checkpoint_every`` / ``checkpoint_dir`` /
``resume_from``).  Setting ``trace`` (a ``repro_torch.sim.TraceSet``, a
trace-JSON dict or a path to one) runs seedflood or a gossip variant on
the event engine instead (``repro_torch.sim.EventTrainer``): each client
steps at its trace's rate on a virtual clock and flood messages arrive
per edge after latency + bytes / bandwidth.

    from repro_torch.sim import TraceSet
    r = run(DTrainConfig(n_clients=8, steps=4, device="cpu",
                         trace=TraceSet.two_speed(8, bandwidth_bps=1e9)))
    r.extra["virtual_time_s"], r.extra["loss_vs_virtual_time"]

The config carries only the fields the port reads.  ``device`` defaults to
``"cuda"``; asking for it without a card raises.  The CPU runs the
kernels' plain versions and is what the tests use (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ArchConfig, ChurnConfig
from repro_torch.data import synthetic
from repro_torch.dtrain.api import RunResult, Setup, sim_arch  # noqa: F401  (re-export)
from repro_torch.dtrain.methods import METHOD_SPECS, MethodSpec
from repro_torch.dtrain.trainer import Trainer
from repro_torch.sim import EventTrainer, as_trace, wrap_async
from repro_torch.topology.dynamic import ChurnSchedule


@dataclasses.dataclass
class DTrainConfig:
    method: str = "seedflood"
    n_clients: int = 8
    topology: str = "ring"
    steps: int = 200
    lr: float = 1e-2
    batch_size: int = 8
    eps: float = 1e-3
    local_iters: int = 5            # gossip every 5 local steps (paper)
    flood_k: int | None = None      # None -> network diameter (full flooding)
    subcge_rank: int = 16
    subcge_tau: int = 1000
    choco_density: float = 0.01     # 99 % top-k sparsification (paper)
    lora_r: int = 8
    lora_alpha: float = 16.0
    momentum: float = 0.0           # beyond-paper: subspace momentum β
    seed: int = 0
    partition: str = "uniform"      # uniform | dirichlet (data.synthetic)
    arch: ArchConfig | None = None
    task: synthetic.TaskConfig | None = None
    # churn: a ChurnSchedule or declarative ChurnConfig; None is the
    # paper's static topology
    churn: Any = None
    # True: replay every received message under its SENDER's τ-epoch.
    # False pins the legacy receiver-step replay, wrong whenever staleness
    # crosses a τ boundary; a regression arm only
    epoch_replay: bool = True
    # after the last step keep flooding + replaying until quiescent, so a
    # delayed-flooding run ends with every message delivered
    drain: bool = False
    eval_every: int = 0             # 0 = only at the end
    # flood engine: "python" (per-message), "numpy" (bitset), or "auto"
    # (the bitset engine from core.flood.AUTO_VECTOR_MIN_CLIENTS clients)
    flood_backend: str = "auto"
    # True: the estimate -> own update -> replay pipeline runs batched over
    # the stacked client axis.  False: the per-client reference path (each
    # client's own update and replay apart, on its view of the stacked
    # params), kept for parity and as the batched path's baseline
    batched_step: bool = True
    # every k steps the Trainer writes method + transport state to
    # checkpoint_dir/stepNNNNNN.npz; resume_from restores one and continues
    # bitwise as the uninterrupted run would
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    resume_from: str = ""
    # event-driven asynchronous runs (DESIGN.md §9): a TraceSet, trace-JSON
    # dict, or path to one switches the run onto the discrete-event
    # EventTrainer, where each client steps at its trace rate and flood
    # messages arrive with per-edge delay.  None keeps the synchronous
    # barrier loop (with TraceSet.constant defaults the two are bitwise
    # identical — pinned by tests/test_torch_sim.py)
    trace: Any = None
    # extra per-delivery latency added on top of the trace's per-client
    # propagation terms (one knob for "same trace, slower network")
    sim_latency_s: float = 0.0
    # virtual seconds one churn-schedule step index spans; None uses the
    # trace's median per-step compute time
    sim_churn_step_s: float | None = None
    device: str = "cuda"


#: DTrainConfig fields that belong to specific methods.  A non-default value
#: for a field outside its method's ``consumes`` set is a config error, not
#: a silent no-op.
_METHOD_FIELDS = ("momentum", "choco_density", "flood_k", "flood_backend",
                  "batched_step", "epoch_replay", "drain", "lora_r",
                  "lora_alpha", "trace", "sim_latency_s", "sim_churn_step_s")

_DEFAULTS = {f.name: f.default for f in dataclasses.fields(DTrainConfig)}


def validate_config(cfg: DTrainConfig, spec: MethodSpec | None = None) -> None:
    """Reject configs whose method-specific fields would be silently ignored.

    Raises ``KeyError`` for an unknown method and ``ValueError`` for a field
    the chosen method does not consume (e.g. ``momentum`` outside
    ``central_zo``, ``choco_density`` outside the choco variants,
    ``flood_k`` outside ``seedflood``), for churn on a static-only method,
    for event-engine settings the run cannot honour (the ``sim_*`` fields
    without a trace; a trace with checkpoints, ``flood_k``, the legacy
    replay, the bitset engine, ``drain``, or churn under gossip), and for
    checkpoint settings that would write nothing.
    """
    if spec is None:
        if cfg.method not in METHOD_SPECS:
            raise KeyError(f"unknown method '{cfg.method}' "
                           f"(have {sorted(METHOD_SPECS)})")
        spec = METHOD_SPECS[cfg.method]
    for field in _METHOD_FIELDS:
        if field in spec.consumes:
            continue
        if getattr(cfg, field) != _DEFAULTS[field]:
            users = sorted(name for name, s in METHOD_SPECS.items()
                           if field in s.consumes)
            raise ValueError(
                f"config field '{field}'={getattr(cfg, field)!r} is not "
                f"consumed by method '{spec.name}' and would be silently "
                f"ignored (only {users} read it)")
    if cfg.churn is not None and not spec.supports_churn:
        raise ValueError(f"method '{spec.name}' does not support churn")
    if cfg.trace is None:
        if cfg.sim_latency_s != 0.0 or cfg.sim_churn_step_s is not None:
            raise ValueError(
                "sim_latency_s/sim_churn_step_s only apply to event-driven "
                "runs and would be silently ignored — set 'trace' as well")
    else:
        if cfg.checkpoint_every or cfg.resume_from:
            raise ValueError("event-driven runs do not support "
                             "checkpoint/resume yet")
        if cfg.flood_k is not None:
            raise ValueError("flood_k has no meaning under per-edge "
                             "timestamped delivery — unset it for trace runs")
        if not cfg.epoch_replay:
            raise ValueError("event-driven runs require epoch_replay=True: "
                             "arbitrarily stale arrivals are only exact "
                             "under sender-epoch replay")
        if cfg.flood_backend == "numpy":
            raise ValueError("the numpy bitset flood engine is "
                             "round-synchronous; event-driven runs need "
                             "flood_backend='python' (or 'auto')")
        if cfg.drain:
            raise ValueError("event-driven runs always drain — "
                             "'drain' would be silently ignored")
        if cfg.churn is not None and spec.name != "seedflood":
            raise ValueError(f"method '{spec.name}' cannot combine churn "
                             "with a trace (gossip mixing is a barrier over "
                             "all clients)")
    if cfg.checkpoint_every and not cfg.checkpoint_dir:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    if cfg.checkpoint_dir and not cfg.checkpoint_every:
        raise ValueError("checkpoint_dir is set but checkpoint_every is 0 — "
                         "no checkpoints would be written")


def _churn_schedule(cfg: DTrainConfig) -> ChurnSchedule | None:
    if cfg.churn is None:
        return None
    if isinstance(cfg.churn, ChurnSchedule):
        return cfg.churn
    if isinstance(cfg.churn, ChurnConfig):
        return ChurnSchedule.from_config(cfg.churn)
    raise TypeError(f"churn must be a ChurnSchedule or ChurnConfig, "
                    f"got {type(cfg.churn).__name__}")


def _run_event(spec: MethodSpec, cfg: DTrainConfig) -> RunResult:
    """Trace-clocked asynchronous run: same Method, async-adapted Transport,
    EventTrainer loop (DESIGN.md §9)."""
    trace = as_trace(cfg.trace, cfg.n_clients)
    if "flood_backend" in spec.consumes:
        # the event engine delivers per edge; only the per-message engine
        # supports that ("auto" would pick the bitset engine at scale)
        cfg = dataclasses.replace(cfg, flood_backend="python")
    setup = Setup(cfg)
    method = spec.make_method(cfg)
    transport = wrap_async(spec.make_transport(cfg, setup), trace,
                           cfg.sim_latency_s)
    return EventTrainer(cfg, setup, method, transport, trace,
                        churn=_churn_schedule(cfg)).run()


def run(cfg: DTrainConfig) -> RunResult:
    validate_config(cfg)
    spec = METHOD_SPECS[cfg.method]
    if cfg.trace is not None:
        return _run_event(spec, cfg)
    setup = Setup(cfg)
    method = spec.make_method(cfg)
    transport = spec.make_transport(cfg, setup)
    return Trainer(cfg, setup, method, transport,
                   churn=_churn_schedule(cfg)).run()
