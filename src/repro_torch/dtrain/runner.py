"""Decentralized training entry point of the port: ``DTrainConfig`` and
``run``.

    from repro_torch.dtrain.runner import DTrainConfig, run
    result = run(DTrainConfig(n_clients=8, steps=3))          # on the card

The port runs SeedFlood (Algorithm 1) — flooding of seed–scalar ZO messages
with SubCGE aggregation — on any static topology of ``topology.graphs``;
the config carries only the fields this path reads.  ``device`` defaults
to ``"cuda"``; asking for it without a card raises.  The CPU runs the
kernels' plain versions and is what the tests use (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core.transport import FloodTransport
from repro_torch.data import synthetic
from repro_torch.dtrain.api import RunResult, Setup, sim_arch  # noqa: F401  (re-export)
from repro_torch.dtrain.methods.seedflood import SeedFloodMethod
from repro_torch.dtrain.trainer import Trainer


@dataclasses.dataclass
class DTrainConfig:
    method: str = "seedflood"
    n_clients: int = 8
    topology: str = "ring"
    steps: int = 200
    lr: float = 1e-2
    batch_size: int = 8
    eps: float = 1e-3
    flood_k: int | None = None      # None -> network diameter (full flooding)
    subcge_rank: int = 16
    subcge_tau: int = 1000
    seed: int = 0
    partition: str = "uniform"      # uniform | dirichlet (data.synthetic)
    arch: ArchConfig | None = None
    task: synthetic.TaskConfig | None = None
    # after the last step keep flooding + replaying until quiescent, so a
    # delayed-flooding run ends with every message delivered
    drain: bool = False
    eval_every: int = 0             # 0 = only at the end
    # flood engine: "python" (per-message), "numpy" (bitset), or "auto"
    # (the bitset engine from core.flood.AUTO_VECTOR_MIN_CLIENTS clients)
    flood_backend: str = "auto"
    device: str = "cuda"


def run(cfg: DTrainConfig) -> RunResult:
    if cfg.method != "seedflood":
        raise KeyError(f"method '{cfg.method}' is not ported (have "
                       "['seedflood'])")
    setup = Setup(cfg)
    transport = FloodTransport(setup.graph, backend=cfg.flood_backend,
                               flood_k=cfg.flood_k)
    return Trainer(cfg, setup, SeedFloodMethod(cfg), transport).run()
