"""The Method × Transport plugin API of the decentralized trainer (the
port of ``repro/dtrain/api.py``).

* a :class:`Method` owns the *math* of one training algorithm: how a
  client turns a batch into new local state and an outbox
  (``local_step``), how it folds a transport's inbox back in
  (``apply_inbox``, which accepts ``None``), and which stacked params its
  state stands for (``params_of``);
* a Transport (``repro_torch.core.transport``) owns the *network*: it moves
  outboxes, applies churn to the topology, and is the only layer that
  touches a ``CommLedger``;
* the Trainer (``repro_torch.dtrain.trainer``) owns the *loop*: churn
  scheduling, logging, checkpoints, drain and the ``RunResult``, once, for
  every method.

Contract details the protocol cannot express in types:

* ``local_step`` receives the live ``active`` mask and must make offline
  clients exact no-ops (freeze their parameters, emit nothing for them).
  :func:`freeze_offline` is the shared helper; SeedFlood instead gives
  offline clients a coefficient of 0, which is bitwise the same.
* ``Outbox.payload`` is transport-specific: flooding methods emit
  ``(client, Message)`` pairs, gossip methods the stacked trainable dict,
  gossip-SR coefficient histories, and the null transport ignores it.
* ``state_tree`` / ``state_meta`` / ``load_state`` make method state
  checkpointable: the tree holds tensors (saved by
  ``repro_torch.checkpoint.ckpt``), the meta JSON-serializable values.  A
  resumed run is bitwise the uninterrupted one.

This module also holds the tiny default arch, the per-run ``Setup`` and the
logging helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, uniform_dense
from repro_torch.core.subcge import SubCGEConfig
from repro_torch.data import synthetic
from repro_torch.models import params as plib
from repro_torch.models import transformer as tf
from repro_torch.topology import graphs


def sim_arch(vocab: int = 256, d_model: int = 64, n_layers: int = 2,
             n_heads: int = 4, d_ff: int = 128) -> ArchConfig:
    """Tiny dense decoder for simulator experiments (the paper's OPT stand-in)."""
    return uniform_dense("sim-tiny", n_layers=n_layers, d_model=d_model,
                         n_heads=n_heads, n_kv=n_heads, d_ff=d_ff,
                         vocab=vocab, tie_embeddings=True, max_seq=128)


def resolve_device(name: str) -> torch.device:
    """The run's device; asking for CUDA without a card is an error, never a
    silent fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available "
                           "(pass device='cpu' to run the plain versions)")
    return dev


class Setup:
    """Arch, data splits, topology and stacked params of one run."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.arch = cfg.arch or sim_arch()
        self.task = cfg.task or synthetic.TaskConfig(vocab=self.arch.vocab)
        self.train, self.valid, self.test = synthetic.make_splits(self.task)
        self.parts = synthetic.partition(self.train, cfg.n_clients,
                                         scheme=cfg.partition, seed=cfg.seed)
        self.graph = graphs.make(cfg.topology, cfg.n_clients)
        self.W = graphs.metropolis_weights(self.graph)
        self.spec = tf.arch_spec(self.arch)
        p0 = plib.init_params(self.spec, cfg.seed, self.device)
        self.stacked = {}
        for path in list(p0):
            leaf = p0.pop(path)
            self.stacked[path] = leaf.unsqueeze(0).repeat(
                (cfg.n_clients,) + (1,) * leaf.ndim)
        self.meta = plib.subcge_meta(self.spec)
        self.scfg = SubCGEConfig(rank=cfg.subcge_rank,
                                 refresh_period=cfg.subcge_tau, eps=cfg.eps)
        self.n_params = plib.n_params(self.spec)

    def batches(self, step: int) -> torch.Tensor:
        toks = synthetic.stacked_batches(self.train, self.parts, step,
                                         self.cfg.batch_size, self.cfg.seed)
        return torch.as_tensor(toks, device=self.device)

    def gmp(self, stacked: dict) -> float:
        avg = {p: t.mean(dim=0) for p, t in stacked.items()}
        return synthetic.accuracy(self.arch, avg, self.test,
                                  forward_fn=tf.forward)

    @torch.no_grad()
    def valid_loss(self, stacked: dict) -> float:
        """The averaged model's ``lm_loss`` on the first 128 validation rows."""
        avg = {p: t.mean(dim=0, keepdim=True) for p, t in stacked.items()}
        toks = torch.as_tensor(self.valid.tokens[:128], device=self.device)
        return float(tf.lm_loss(self.arch, avg, toks[None])[0])


@dataclasses.dataclass
class RunResult:
    method: str
    gmp: float                      # final averaged-model accuracy
    loss_curve: list[float]
    acc_curve: list[tuple[int, float]]
    bytes_per_edge: float
    total_bytes: float
    consensus_error: float
    wall_s: float
    compile_wall_s: float = 0.0     # the first step (kernel builds, warm-up)
    extra: dict = dataclasses.field(default_factory=dict)

    #: extra[] entries excluded from to_json(): whole parameter trees that
    #: belong in a checkpoint, not a results file.
    _JSON_DROP = ("final_stacked", "final_params")

    def to_json(self) -> dict:
        """JSON-safe dict: tensors and numpy scalars become Python numbers,
        arrays lists, anything else unknown its ``str``; the parameter trees
        (``final_stacked`` / ``final_params``) are dropped."""
        def coerce(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu()
                x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
            if isinstance(x, (np.ndarray, np.generic)):
                arr = np.asarray(x)
                return arr.item() if arr.ndim == 0 else arr.tolist()
            if isinstance(x, dict):
                return {str(k): coerce(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [coerce(v) for v in x]
            if isinstance(x, (bool, int, str, float)) or x is None:
                return x
            return str(x)

        extra = {k: v for k, v in self.extra.items()
                 if k not in self._JSON_DROP}
        return coerce({
            "method": self.method, "gmp": self.gmp,
            "loss_curve": self.loss_curve, "acc_curve": self.acc_curve,
            "bytes_per_edge": self.bytes_per_edge,
            "total_bytes": self.total_bytes,
            "consensus_error": self.consensus_error,
            "wall_s": self.wall_s, "compile_wall_s": self.compile_wall_s,
            "extra": extra,
        })


@dataclasses.dataclass
class Outbox:
    """What one local step hands back: per-model losses (the Trainer logs
    them) and a transport payload."""
    losses: np.ndarray
    payload: Any = None


@runtime_checkable
class Method(Protocol):
    """One training algorithm.  State is opaque to the Trainer."""

    def init(self, setup: Setup) -> Any: ...
    def local_step(self, state: Any, batch: torch.Tensor, active: np.ndarray,
                   t: int) -> tuple[Any, Outbox]: ...
    def apply_inbox(self, state: Any, inbox: Any) -> Any: ...
    def params_of(self, state: Any) -> dict: ...


@runtime_checkable
class Transport(Protocol):
    """One communication substrate (``repro_torch.core.transport``).  Owns
    the CommLedger: every byte a run charges is charged here."""

    def bind(self, init_payload: Any) -> None: ...
    def active_mask(self) -> np.ndarray: ...
    def apply_churn(self, events) -> None: ...
    def exchange(self, payload: Any, t: int, active: np.ndarray) -> Any: ...
    def stats(self) -> dict: ...


class MethodBase:
    """Default hooks so concrete methods only override what they use."""

    name = "method"

    def initial_payload(self, state: Any) -> Any:
        """Payload-equivalent view of the *initial* state, handed to
        ``Transport.bind`` (Choco initializes its surrogate copies from the
        pre-training weights, paper App. B.2)."""
        return None

    def params_of(self, state: Any) -> dict:
        """The stacked params (models, ...) that ``state`` stands for: what
        the Trainer evaluates and reports as ``extra["final_stacked"]``."""
        return state

    def label(self, transport_stats: dict) -> str:
        """RunResult.method display name (may cite transport stats)."""
        return self.name

    def result_extra(self, state: Any) -> dict:
        return {}

    # -- checkpointing --------------------------------------------------------

    def state_tree(self, state: Any) -> dict:
        """Tensor-valued tree capturing the method state (``ckpt.save``)."""
        raise NotImplementedError(f"{self.name} does not support checkpointing")

    def state_meta(self, state: Any) -> dict:
        """JSON-serializable non-tensor state (histories, counters)."""
        return {}

    def load_state(self, state: Any, tree: dict, meta: dict) -> Any:
        raise NotImplementedError(f"{self.name} does not support checkpointing")


def freeze_offline(new: dict, old: dict, active: np.ndarray) -> dict:
    """Keep offline clients' leaves at their pre-step values."""
    mask = torch.as_tensor(np.asarray(active, bool),
                           device=next(iter(new.values())).device)
    return {p: torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a,
                           old[p])
            for p, a in new.items()}


def load_leaves(tree: dict, like: dict) -> dict:
    """A checkpoint subtree (nested dicts of numpy arrays) as flat
    path-keyed tensors with the dtype and device of ``like``'s leaves."""
    flat = plib.flatten(tree)
    if set(flat) != set(like):
        raise ValueError(f"checkpoint leaves differ: missing "
                         f"{sorted(set(like) - set(flat))[:5]}, extra "
                         f"{sorted(set(flat) - set(like))[:5]}")
    return {p: torch.as_tensor(flat[p], dtype=t.dtype,
                               device=t.device).reshape(t.shape)
            for p, t in like.items()}


def log_step_loss(loss_curve: list[float], losses: np.ndarray,
                  active: np.ndarray) -> None:
    """Mean loss over online clients (carry the last value under a full
    outage)."""
    if active.any():
        loss_curve.append(float(np.mean(losses[active])))
    else:
        loss_curve.append(loss_curve[-1] if loss_curve else float("nan"))


_CHUNK = 1 << 22


@torch.no_grad()
def consensus_error(stacked: dict) -> float:
    """(1/n) Σ_i ||θ_i − θ̄||² / ||θ̄||², summed in float64 over column
    chunks so the float64 temporaries stay small beside the stacked params."""
    num = den = 0.0
    for leaf in stacked.values():
        flat = leaf.reshape(leaf.shape[0], -1)
        for c0 in range(0, flat.shape[1], _CHUNK):
            x = flat[:, c0:c0 + _CHUNK].double()
            mean = x.mean(dim=0, keepdim=True)
            num += float(((x - mean) ** 2).sum())
            den += float((mean ** 2).sum()) * leaf.shape[0]
    return num / max(den, 1e-20)


def active_consensus(stacked: dict, active: np.ndarray) -> float:
    """Consensus error over online clients only.  The mask is clipped to the
    model axis, so single-model methods (central_zo) report 0."""
    n_models = next(iter(stacked.values())).shape[0]
    active = active[:n_models]
    idx = np.flatnonzero(active)
    if idx.size <= 1:
        return 0.0
    if idx.size == active.size:
        return consensus_error(stacked)
    sel = torch.as_tensor(idx, device=next(iter(stacked.values())).device)
    return consensus_error({p: t[sel] for p, t in stacked.items()})
