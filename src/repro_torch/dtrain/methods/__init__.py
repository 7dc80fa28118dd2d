"""Method registry: name -> (method factory, transport factory, config
fields it reads), the port of ``repro/dtrain/methods/__init__.py``.

Every §4.2 protocol is one :class:`MethodSpec` composing a Method plugin
with a Transport plugin; the Trainer loop and RunResult assembly are
shared.  ``consumes`` lists the *method-specific* DTrainConfig fields a
spec reads; ``repro_torch.dtrain.runner.validate_config`` rejects
non-default values of any other method-specific field instead of dropping
them on the floor.

The names and the ``consumes`` sets are the JAX package's, less the field
the port's config does not have: ``kernel_backend`` (the port dispatches
on the device).
The event engine's ``trace`` and ``sim_latency_s`` belong to seedflood and
the six gossip variants, ``sim_churn_step_s`` to seedflood alone (churn
under a trace needs the flood substrate); central_zo and gossip_sr reject a
trace.  ``supports_churn`` marks the methods a churn schedule may drive:
seedflood and the six gossip variants.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.transport import (FloodTransport, GossipSRTransport,
                                        GossipTransport, NullTransport)
from repro_torch.dtrain.api import Method, Setup, Transport
from repro_torch.dtrain.methods.central_zo import CentralZOMethod
from repro_torch.dtrain.methods.gossip import (FirstOrderStep, GossipMethod,
                                               LoRAAdapter, ZeroOrderStep)
from repro_torch.dtrain.methods.gossip_sr import GossipSRMethod
from repro_torch.dtrain.methods.seedflood import SeedFloodMethod


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    make_method: Callable[..., Method]          # (cfg) -> Method
    make_transport: Callable[..., Transport]    # (cfg, setup) -> Transport
    consumes: frozenset = frozenset()  # method-specific cfg fields
    supports_churn: bool = False


def _flood_transport(cfg, setup: Setup) -> FloodTransport:
    return FloodTransport(setup.graph, backend=cfg.flood_backend,
                          flood_k=cfg.flood_k)


def _gossip_transport(choco: bool):
    def make(cfg, setup: Setup) -> GossipTransport:
        return GossipTransport(
            setup.graph, setup.W, every=cfg.local_iters,
            choco_density=cfg.choco_density if choco else None,
            churn_aware=cfg.churn is not None)
    return make


def _gossip_sr_transport(cfg, setup: Setup) -> GossipSRTransport:
    return GossipSRTransport(setup.graph, setup.W, every=cfg.local_iters)


def _null_transport(cfg, setup: Setup) -> NullTransport:
    return NullTransport(cfg.n_clients)


def _gossip_spec(name: str, *, zeroth_order: bool, use_lora: bool,
                 choco: bool) -> MethodSpec:
    local_cls = ZeroOrderStep if zeroth_order else FirstOrderStep

    def make_method(cfg) -> GossipMethod:
        adapter = (LoRAAdapter(cfg.lora_r, cfg.lora_alpha) if use_lora
                   else None)
        return GossipMethod(cfg, name, local_cls(), adapter)

    consumes = {"trace", "sim_latency_s"}
    if choco:
        consumes.add("choco_density")
    if use_lora:
        consumes |= {"lora_r", "lora_alpha"}
    return MethodSpec(name=name, make_method=make_method,
                      make_transport=_gossip_transport(choco),
                      consumes=frozenset(consumes), supports_churn=True)


METHOD_SPECS: dict[str, MethodSpec] = {
    "seedflood": MethodSpec(
        name="seedflood", make_method=SeedFloodMethod,
        make_transport=_flood_transport,
        consumes=frozenset({"flood_k", "flood_backend", "batched_step",
                            "epoch_replay", "drain", "trace",
                            "sim_latency_s", "sim_churn_step_s"}),
        supports_churn=True),
    "dsgd": _gossip_spec("dsgd", zeroth_order=False, use_lora=False,
                         choco=False),
    "dzsgd": _gossip_spec("dzsgd", zeroth_order=True, use_lora=False,
                          choco=False),
    "choco": _gossip_spec("choco", zeroth_order=False, use_lora=False,
                          choco=True),
    "dsgd_lora": _gossip_spec("dsgd_lora", zeroth_order=False, use_lora=True,
                              choco=False),
    "dzsgd_lora": _gossip_spec("dzsgd_lora", zeroth_order=True, use_lora=True,
                               choco=False),
    "choco_lora": _gossip_spec("choco_lora", zeroth_order=False,
                               use_lora=True, choco=True),
    "gossip_sr": MethodSpec(
        name="gossip_sr", make_method=GossipSRMethod,
        make_transport=_gossip_sr_transport),
    "central_zo": MethodSpec(
        name="central_zo", make_method=CentralZOMethod,
        make_transport=_null_transport, consumes=frozenset({"momentum"})),
}
