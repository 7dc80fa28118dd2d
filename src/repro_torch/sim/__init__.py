"""Deterministic discrete-event simulation of asynchronous swarms (the port
of ``repro/sim``; DESIGN.md §9): the event core, per-client traces, the
async transport adapters and the EventTrainer that
``repro_torch.dtrain.runner.run`` switches to when ``DTrainConfig.trace``
is set."""
from repro_torch.sim.async_transport import (AsyncFloodTransport,
                                             AsyncGossipTransport, wrap_async)
from repro_torch.sim.event_trainer import (EventTrainer, barrier_schedule,
                                           time_to_loss)
from repro_torch.sim.events import Event, EventQueue
from repro_torch.sim.traces import Episode, TraceSet, as_trace

__all__ = [
    "AsyncFloodTransport", "AsyncGossipTransport", "wrap_async",
    "EventTrainer", "barrier_schedule", "time_to_loss",
    "Event", "EventQueue",
    "Episode", "TraceSet", "as_trace",
]
