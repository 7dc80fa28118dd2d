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
``resume_from``).

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
    # every k steps the Trainer writes method + transport state to
    # checkpoint_dir/stepNNNNNN.npz; resume_from restores one and continues
    # bitwise as the uninterrupted run would
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    resume_from: str = ""
    device: str = "cuda"


#: DTrainConfig fields that belong to specific methods.  A non-default value
#: for a field outside its method's ``consumes`` set is a config error, not
#: a silent no-op.
_METHOD_FIELDS = ("momentum", "choco_density", "flood_k", "flood_backend",
                  "epoch_replay", "drain", "lora_r", "lora_alpha")

_DEFAULTS = {f.name: f.default for f in dataclasses.fields(DTrainConfig)}


def validate_config(cfg: DTrainConfig, spec: MethodSpec | None = None) -> None:
    """Reject configs whose method-specific fields would be silently ignored.

    Raises ``KeyError`` for an unknown method and ``ValueError`` for a field
    the chosen method does not consume (e.g. ``momentum`` outside
    ``central_zo``, ``choco_density`` outside the choco variants,
    ``flood_k`` outside ``seedflood``), for churn on a static-only method,
    and for checkpoint settings that would write nothing.
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


def run(cfg: DTrainConfig) -> RunResult:
    validate_config(cfg)
    spec = METHOD_SPECS[cfg.method]
    setup = Setup(cfg)
    method = spec.make_method(cfg)
    transport = spec.make_transport(cfg, setup)
    return Trainer(cfg, setup, method, transport,
                   churn=_churn_schedule(cfg)).run()
